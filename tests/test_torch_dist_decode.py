"""The sequence-sharded decode of the port (`dist.decode`, DESIGN §5) on
the CPU.

Ranks are gloo CPU processes (`tests/torch_dp_ranks.py::decode_scenario`),
2 and 4, each scoring its Smax / n slice of the same cache and merging by
MAX, SUM, SUM. Held, on a scalar and a per-slot `pos`, with and without a
window, within 1e-5: against the port's `models.attention.
decode_attention` on the whole cache, and against the reference's
`flash_decode_seq_sharded` run in a subprocess with 4 forced host devices
on hand-built ("model",) meshes of 2 and 4 (its own test builds its mesh
with `jax.make_mesh`, which this jax does not run; ROADMAP.md Queue 3
fact a). Then a paged engine on 2 ranks whose decode attends through the
hook (`Engine(attn_fn=...)`): its greedy tokens, and its solo replay's,
equal those of the engine without it."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.attention import decode_attention
from repro_torch.serve import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5

_REF = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import torch_dp_ranks as ranks
from repro.dist.decode import flash_decode_seq_sharded
q, k, v = (jnp.asarray(x) for x in ranks.decode_inputs())
out = {}
for n in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("model",))
    for name, (pos, window) in ranks.DEC_CASES.items():
        out[f"{n}_{name}"] = np.asarray(flash_decode_seq_sharded(
            q, k, v, jnp.asarray(pos, jnp.int32), mesh, axis="model",
            window=window))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs (a subprocess, started first and read when
    a test needs it)."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         os.path.join(REPO, "tests")])
    proc = subprocess.Popen([sys.executable, "-c", _REF, path], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    got = {}

    def result():
        if not got:
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log
            got.update(np.load(path))
        return got

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", params=[2, 4])
def ranked(request, reference, tmp_path_factory):
    n = request.param
    out = str(tmp_path_factory.mktemp(f"dec{n}"))
    spawn_ranks(ranks.decode_scenario, 1, (out, n == 2), dp=n,
                device="cpu", backend="gloo", threads=1)
    return n, [dict(np.load(os.path.join(out, f"rank{r}.npz")))
               for r in range(n)]


@pytest.mark.parametrize("case", list(ranks.DEC_CASES))
def test_seq_sharded_decode_matches_decode_attention(ranked, case):
    n, res = ranked
    q, k, v = (torch.from_numpy(x) for x in ranks.decode_inputs())
    pos, window = ranks.DEC_CASES[case]
    want = decode_attention(q, k, v, torch.tensor(pos).expand(ranks.DEC_B),
                            window=window).numpy()
    for r in range(n):
        np.testing.assert_allclose(res[r][f"dec_{case}"], want, atol=TOL,
                                   rtol=TOL)
        assert res[r][f"dec_{case}"].tobytes() == \
            res[0][f"dec_{case}"].tobytes()


@pytest.mark.parametrize("case", list(ranks.DEC_CASES))
def test_seq_sharded_decode_matches_reference(ranked, reference, case):
    n, res = ranked
    want = reference()[f"{n}_{case}"]
    for r in range(n):
        np.testing.assert_allclose(res[r][f"dec_{case}"], want, atol=TOL,
                                   rtol=TOL)


def test_seq_len_must_divide_the_group(monkeypatch):
    """A group of one takes any Smax (and is `decode_attention`); a group
    whose size does not divide Smax is refused."""
    import repro_torch.dist.decode as dec
    q, k, v = (torch.from_numpy(x[:, :31] if x.shape[1] == ranks.DEC_S
                                else x) for x in ranks.decode_inputs())
    pos = torch.tensor(9)
    np.testing.assert_allclose(
        dec.flash_decode_seq_sharded(q, k, v, pos).numpy(),
        decode_attention(q, k, v, pos.expand(ranks.DEC_B)).numpy(),
        atol=TOL)
    monkeypatch.setattr(dec, "group_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="must divide"):
        dec.flash_decode_seq_sharded(q, k, v, pos)


@pytest.mark.parametrize("ranked", [2], indirect=True)
def test_engine_with_the_hook_equals_engine_without(ranked):
    _, res = ranked
    eng = Engine(ranks.decode_engine_cfg(), head="full", device="cpu")
    reqs = ranks.decode_requests()
    want = eng.run(reqs)
    for r in range(2):
        for req in reqs:
            np.testing.assert_array_equal(res[r][f"tokens_{req.rid}"],
                                          want[req.rid].tokens)
            assert len(want[req.rid].tokens) == req.max_new
        np.testing.assert_array_equal(res[r]["solo_0"], want[0].tokens)
