"""Checkpoints of the port against the JAX package on the CPU: the on-disk
format in both directions (leaves bit for bit, the treedef string, the
per-leaf CRC32s), the reference's checkpoint tests, a 20 + 20-step resume
against a 40-step run, the serving checkpoint, and gradient accumulation.

Inputs are made with numpy from a seed or by the reference's init. Bars:
bitwise on every restored leaf, on a resumed run's losses, params, moments
and index, and on the tokens served from a restored checkpoint; 1e-5 on
gradient accumulation against the reference's (`tests/test_substrates.py`
holds its own at 1e-6 against the full batch)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.data import ZipfLM as JZipfLM
from repro.launch.train import train_loop as jtrain_loop
from repro.models import heads as jheads
from repro.models import init_params as jinit
from repro.optim import accumulate_gradients as jaccumulate
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro.proposals import registry as jregistry
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch.bridge import (index_from_numpy, params_from_numpy,
                                proposal_state_from_numpy, to_reference)
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    restore_serving_state, save_serving_state)
from repro_torch.checkpoint.manager import _flatten, _treedef_str
from repro_torch.configs import get_config
from repro_torch.core import midx, noise
from repro_torch.data import ZipfLM
from repro_torch.launch.train import train_loop
from repro_torch.models import heads, init_params
from repro_torch.optim import accumulate_gradients
from repro_torch.optim.optimizers import OptState, tree_leaves, tree_map
from repro_torch.serve import Engine, Request

FIELDS = ("codebook1", "codebook2", "assign1", "assign2", "residuals",
          "sorted_ids", "offsets", "counts", "log_counts")



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts test files in parallel
    workers, and torch's thread pools then oversubscribe the cores and
    these small train steps crawl (~50x)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(kind: str):
    """The reduced paper-lm training tuple of the reference, its moments
    filled with seeded values and step 7: (params, OptState, head state).
    kind: 'midx' (the RQ MultiIndex), 'rff' (an RFF proposal state) or
    'sgd' (SGD's state, nu None)."""
    cfg = jget_config("paper-lm").reduced()
    p = jinit(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    fill = lambda t: jax.tree_util.tree_map(            # noqa: E731
        lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), t)
    opt = (jsgd if kind == "sgd" else jadamw)(1e-3).init(p)
    opt = opt._replace(step=jnp.int32(7), mu=fill(opt.mu),
                       nu=None if opt.nu is None else fill(opt.nu))
    if kind == "rff":
        prop = jregistry.from_config(cfg.head, "rff")
        head = jheads.init_proposal_state(cfg, p, jax.random.PRNGKey(1), prop)
    else:
        head = jheads.init_head_state(cfg, p, jax.random.PRNGKey(1))
    return p, opt, head


def _port_state(jstate, kind: str):
    """The same values in the port's structure, on the CPU."""
    tcfg = get_config("paper-lm").reduced()
    jp, jo, jh = jstate
    p = params_from_numpy(tcfg, _np_tree(jp), device="cpu")
    moment = lambda t: None if t is None else params_from_numpy(  # noqa: E731
        tcfg, _np_tree(t), device="cpu")
    opt = OptState(int(jo.step), moment(jo.mu), moment(jo.nu))
    if kind == "rff":
        head = proposal_state_from_numpy(_np_tree(jh), device="cpu")
    else:
        head = index_from_numpy({"kind": jh.kind, **{
            f: np.asarray(getattr(jh, f)) for f in FIELDS}}, device="cpu")
    return p, opt, head


def _zeros_like(tree):
    """A restore target of the port's structure whose values all differ."""
    def go(t):
        if isinstance(t, OptState):
            return OptState(0, go(t.mu), go(t.nu))
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{f: go(getattr(t, f))
                                             for f in FIELDS})
        if isinstance(t, (tuple, list)):
            return type(t)(go(x) for x in t)
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return None if t is None else torch.zeros_like(t)
    return go(tree)


def _assert_ref_leaves_equal(port_tree, jax_tree):
    """The port's tree, laid out as the reference's, equals the JAX tree
    leaf for leaf, bit for bit, in dtype and shape."""
    got = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
           for x in _flatten(to_reference(port_tree))]
    want = jax.tree_util.tree_leaves(_np_tree(jax_tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


KINDS = ("midx", "rff", "sgd")


@pytest.mark.parametrize("kind", KINDS)
def test_reference_checkpoint_restores_in_the_port(tmp_path, kind):
    jstate = _jax_state(kind)
    JManager(str(tmp_path)).save(3, jstate, metadata={"next_step": 3})
    port = _port_state(jstate, kind)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.verify(3, port) == []
    got = mgr.restore(3, _zeros_like(port), device="cpu")
    assert got[1].step == 7 and isinstance(got[1].step, int)
    if kind == "midx":
        assert got[2].sorted_ids.dtype == torch.int64
    assert len(got[0]["blocks"]) == len(port[0]["blocks"])
    _assert_ref_leaves_equal(got, jstate)
    assert mgr.metadata(3) == {"next_step": 3}


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_restores_in_the_reference(tmp_path, kind):
    jstate = _jax_state(kind)
    CheckpointManager(str(tmp_path)).save(5, _port_state(jstate, kind),
                                          metadata={"next_step": 5})
    jm = JManager(str(tmp_path))
    like = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    assert jm.verify(5, like) == []
    got = jm.restore(5, like, verify=True)      # CRC32s and the treedef
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jm.metadata(5) == {"next_step": 5}


def _trees_saved():
    """(port tree, the same tree as the reference holds it): every tree
    the port saves."""
    out = []
    for kind in KINDS:
        j = _jax_state(kind)
        out.append((_port_state(j, kind), j))
    p, o, h = out[0][1]
    tp, to, th = out[0][0]
    out.append(((tp, to, None), (p, o, None)))           # the full head
    out.append(({"params": tp, "index": th}, {"params": p, "index": h}))
    bf = {"w": torch.ones(3, dtype=torch.bfloat16),
          "q": torch.zeros((2, 2), dtype=torch.float8_e4m3fn),
          "b": [torch.arange(3, dtype=torch.int32), (torch.ones(1),)]}
    out.append((bf, {"w": jnp.ones(3, jnp.bfloat16),
                     "q": jnp.zeros((2, 2), jnp.float8_e4m3fn),
                     "b": [jnp.arange(3, dtype=jnp.int32), (jnp.ones(1),)]}))
    return out


def test_treedef_string_is_jax_s():
    for port, ref in _trees_saved():
        assert _treedef_str(to_reference(port)) == \
            str(jax.tree_util.tree_flatten(ref)[1])


def test_both_packages_write_the_same_leaves(tmp_path):
    """The same values saved by each package: arrays.npz leaf bytes, and
    tree.json's treedef, shapes, dtypes and CRC32s, are equal."""
    for i, (port, ref) in enumerate(_trees_saved()):
        a, b = str(tmp_path / f"t{i}"), str(tmp_path / f"j{i}")
        CheckpointManager(a).save(1, port, metadata={"next_step": 1})
        JManager(b).save(1, ref, metadata={"next_step": 1})
        specs = []
        for root in (a, b):
            with open(os.path.join(root, "step_0000000001", "tree.json")) as f:
                specs.append(json.load(f))
        assert specs[0] == specs[1]
        with np.load(os.path.join(a, "step_0000000001", "arrays.npz")) as za, \
                np.load(os.path.join(b, "step_0000000001",
                                     "arrays.npz")) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for name in za.files:
                assert za[name].dtype == zb[name].dtype
                assert za[name].tobytes() == zb[name].tobytes()


def test_bf16_and_fp8_cross_as_raw_bits(tmp_path):
    """Extension dtypes cross both ways with their bits, and restore casts
    to the target's dtype (here bf16 -> fp32 exactly)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    ref = {"b": jnp.asarray(x, jnp.bfloat16),
           "f": jnp.asarray(x, jnp.float8_e4m3fn)}
    JManager(str(tmp_path / "j")).save(1, ref)
    got = CheckpointManager(str(tmp_path / "j")).restore(
        1, {"b": torch.zeros(1, dtype=torch.bfloat16),
            "f": torch.zeros(1, dtype=torch.float8_e4m3fn)}, device="cpu")
    for k, bits in (("b", torch.uint16), ("f", torch.uint8)):
        np.testing.assert_array_equal(
            got[k].view(bits).numpy(),
            np.asarray(ref[k]).view(np.dtype(f"u{bits.itemsize}")))
    CheckpointManager(str(tmp_path / "t")).save(1, got)
    back = JManager(str(tmp_path / "t")).restore(
        1, {"b": jnp.zeros((4, 5), jnp.float32),
            "f": jnp.zeros((4, 5), ml_dtypes.float8_e4m3fn)})
    np.testing.assert_array_equal(
        np.asarray(back["b"]), np.asarray(ref["b"]).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(back["f"]).view(np.uint8),
                                  np.asarray(ref["f"]).view(np.uint8))


def test_structural_mismatch_is_refused(tmp_path):
    jstate = _jax_state("midx")
    port = _port_state(jstate, "midx")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, port)
    rff = _port_state(_jax_state("rff"), "rff")
    assert mgr.verify(1, (port[0], port[1], rff[2]))
    with pytest.raises(CheckpointError, match="leaves|treedef"):
        mgr.restore(1, (port[0], port[1], rff[2]), device="cpu")


# ------------------------------------------ the reference's checkpoint tests
def _key_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 4), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    """Port of `tests/test_substrates.py::test_checkpoint_roundtrip_and_gc`."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _key_tree()
    for step in (10, 20, 30):
        mgr.save(step, tree, metadata={"next_step": step})
    assert mgr.all_steps() == [20, 30]        # keep-2 GC
    assert mgr.latest_step() == 30
    restored = mgr.restore(30, tree_map(torch.zeros_like, tree), device="cpu")
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert mgr.metadata(30)["next_step"] == 30


def test_checkpoint_atomicity(tmp_path):
    """Port of `tests/test_substrates.py::test_checkpoint_atomicity`: a
    stale .tmp dir (a crash) is ignored by latest_step."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, {"a": torch.ones(2)})
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    assert mgr.latest_step() == 5


def test_checkpoint_dtype_cast_on_restore(tmp_path):
    """Port of `tests/test_substrates.py::
    test_checkpoint_dtype_cast_on_restore`."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(3, dtype=torch.float32)})
    restored = mgr.restore(1, {"w": torch.zeros(3, dtype=torch.bfloat16)},
                           device="cpu")
    assert restored["w"].dtype == torch.bfloat16


# ------------------------------------------------------------------ resume
@pytest.fixture(scope="module")
def tiny_cfg():
    return get_config("paper-lm").reduced().with_head(
        num_negatives=32, refresh_every=25, proposal="per_token")


@pytest.fixture(scope="module")
def corpus(tiny_cfg):
    return ZipfLM(vocab_size=tiny_cfg.vocab_size, num_clusters=16,
                  seq_len=33, seed=0).sample(256)


def _state_leaves(run):
    params, opt, index, _ = run
    return (tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu)
            + [getattr(index, f) for f in FIELDS])


def test_checkpoint_resume_exact(tiny_cfg, corpus, tmp_path):
    """Port of `tests/test_train_e2e.py::test_checkpoint_resume_exact`,
    held bitwise: 40 steps straight equal 20, a crash, and 20 more from the
    checkpoint in a fresh loop (the refresh after step 24 included), both
    legs at the job's horizon total_steps=40."""
    kw = dict(batch_size=4, seq_len=16, corpus=corpus[:, :17], ckpt_every=20,
              lr=1e-3, log_every=1000, total_steps=40, device="cpu")
    straight = train_loop(tiny_cfg, steps=40, ckpt_dir=str(tmp_path / "a"),
                          **kw)
    first = train_loop(tiny_cfg, steps=20, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = train_loop(tiny_cfg, steps=40, ckpt_dir=str(tmp_path / "b"),
                         **kw)
    assert first[3] + resumed[3] == straight[3]
    assert resumed[1].step == straight[1].step == 40
    for a, b in zip(_state_leaves(straight), _state_leaves(resumed)):
        assert torch.equal(a, b)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [20, 40]


# ------------------------------------------------------------------ serving
def test_serving_checkpoint_roundtrip_identical_samples(tmp_path):
    """Port of `tests/test_serve.py::
    test_serving_checkpoint_roundtrip_identical_samples`."""
    cfg = get_config("paper-lm").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    index = heads.init_head_state(cfg, params,
                                  torch.Generator().manual_seed(1))
    save_serving_state(str(tmp_path), 7, params, index,
                       metadata={"arch": cfg.name})
    p2, i2, meta = restore_serving_state(
        str(tmp_path), _zeros_like(params), _zeros_like(index), device="cpu")
    assert meta["arch"] == cfg.name
    z = 0.3 * torch.randn((4, cfg.d_model),
                          generator=torch.Generator().manual_seed(2))
    keys = noise.row_keys(5, torch.arange(4), 0)
    d1 = midx.sample_twostage(index, z, 16, keys)
    d2 = midx.sample_twostage(i2, z, 16, keys)
    assert torch.equal(d1.ids, d2.ids) and torch.equal(d1.log_q, d2.log_q)
    sv = dict(max_slots=2, page_size=4, max_seq=32)
    req = Request(rid=0, tokens=np.arange(6, dtype=np.int32), max_new=5)
    out1 = Engine(cfg.with_serve(**sv), params, index=index, head="midx",
                  device="cpu").run([req])[0].tokens
    eng2 = Engine.from_checkpoint(cfg.with_serve(**sv), str(tmp_path),
                                  head="midx", device="cpu")
    np.testing.assert_array_equal(out1, eng2.run([req])[0].tokens)
    for a, b in zip(tree_leaves(params), tree_leaves(p2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("head", ["midx", "full", "rff-fused"])
def test_engine_save_checkpoint_serves_the_same_tokens(tmp_path, head):
    cfg = get_config("paper-lm").reduced().with_serve(
        max_slots=2, page_size=4, max_seq=32)
    eng = Engine(cfg, head=head, device="cpu", seed=3)
    eng.save_checkpoint(str(tmp_path), step=2)
    again = Engine.from_checkpoint(cfg, str(tmp_path), head=head,
                                   device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, 5)
                    .astype(np.int32), max_new=6, seed=1) for i in range(3)]
    a, b = eng.run(reqs), again.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(a[r.rid].tokens, b[r.rid].tokens)
    assert CheckpointManager(str(tmp_path)).metadata(2)["head"] == head


def test_reference_training_export_serves_greedily_in_the_port(tmp_path):
    """The reference's train_loop writes <ckpt>/serve; the port's engine
    restores it and decodes greedily through the full head the same
    tokens as the reference's engine restored from it."""
    jcfg = jget_config("paper-lm").reduced().with_head(
        num_negatives=32, proposal="per_token")
    corpus = JZipfLM(vocab_size=jcfg.vocab_size, num_clusters=16,
                     seq_len=17, seed=0).sample(64)
    ck = str(tmp_path / "ck")
    jtrain_loop(jcfg, steps=4, batch_size=4, seq_len=16, corpus=corpus,
                ckpt_dir=ck, lr=3e-3, log_every=1000)
    sv = dict(max_slots=2, page_size=4, max_seq=32)
    jg = jcfg.with_head(decode_temperature=0.0).with_serve(**sv)
    tg = get_config("paper-lm").reduced().with_head(
        num_negatives=32, proposal="per_token",
        decode_temperature=0.0).with_serve(**sv)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, 6).astype(np.int32)
               for _ in range(2)]
    want = JEngine.from_checkpoint(jg, os.path.join(ck, "serve"),
                                   head="full").run(
        [JRequest(rid=i, tokens=t, max_new=8) for i, t in enumerate(prompts)])
    got = Engine.from_checkpoint(tg, os.path.join(ck, "serve"), head="full",
                                 device="cpu").run(
        [Request(rid=i, tokens=t, max_new=8) for i, t in enumerate(prompts)])
    for i in range(len(prompts)):
        assert len(want[i].tokens) == 8
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)


def test_port_full_head_training_checkpoints_cross(tmp_path):
    """A full-head run of the port's train_loop checkpoints the MultiIndex
    the reference's carries: the reference's train_loop resumes from it
    (verify on, so the treedef and the CRC32s match), and both packages'
    engines serve its <ckpt>/serve export greedily through the full head,
    to the same tokens."""
    cfg = get_config("paper-lm").reduced().with_head(
        num_negatives=32, proposal="per_token")
    jcfg = jget_config("paper-lm").reduced().with_head(
        num_negatives=32, proposal="per_token")
    corpus = ZipfLM(vocab_size=cfg.vocab_size, num_clusters=16, seq_len=17,
                    seed=0).sample(64)
    ck = str(tmp_path / "ck")
    run = train_loop(cfg, steps=4, batch_size=4, seq_len=16, corpus=corpus,
                     ckpt_dir=ck, head_mode="full", lr=3e-3, log_every=1000,
                     device="cpu")
    assert isinstance(run[2], midx.MultiIndex)
    hist = jtrain_loop(jcfg, steps=6, batch_size=4, seq_len=16,
                       corpus=corpus, ckpt_dir=ck, head_mode="full",
                       lr=3e-3, log_every=1000)[3]
    assert len(hist) == 2                   # steps 4 and 5: it resumed
    serve = os.path.join(ck, "serve")
    # the reference's leg re-exported step 6; serve the port's step 4
    sv = dict(max_slots=2, page_size=4, max_seq=32)
    tg = cfg.with_head(decode_temperature=0.0).with_serve(**sv)
    jg = jcfg.with_head(decode_temperature=0.0).with_serve(**sv)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
               for _ in range(2)]
    got = Engine.from_checkpoint(tg, serve, step=4, head="full",
                                 device="cpu").run(
        [Request(rid=i, tokens=t, max_new=8) for i, t in enumerate(prompts)])
    want = JEngine.from_checkpoint(jg, serve, step=4, head="full").run(
        [JRequest(rid=i, tokens=t, max_new=8) for i, t in enumerate(prompts)])
    for i in range(len(prompts)):
        assert len(got[i].tokens) == 8
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)


# ------------------------------------------------------------ accumulation
def test_grad_accumulation_matches_the_reference():
    """Port of `tests/test_substrates.py::
    test_grad_accumulation_matches_full_batch`, held to the reference's
    accumulate_gradients at 1e-5."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 3)).astype(np.float32)

    def jlg(params, batch):
        return jax.value_and_grad(lambda p: jnp.mean(
            (batch["x"] @ p - batch["y"]) ** 2))(params)

    def tlg(params, batch):
        p = params.detach().requires_grad_(True)
        loss = torch.mean((batch["x"] @ p - batch["y"]) ** 2)
        return loss.detach(), torch.autograd.grad(loss, p)[0]

    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    l_full, g_full = tlg(torch.from_numpy(w), tb)
    for n in (1, 2, 4):
        jl, jg = jaccumulate(jlg, jnp.asarray(w),
                             {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                             num_microbatches=n)
        tl, tg = accumulate_gradients(tlg, torch.from_numpy(w), tb,
                                      num_microbatches=n)
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tl), float(l_full), atol=1e-6)
        np.testing.assert_allclose(tg.numpy(), g_full.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        accumulate_gradients(tlg, torch.from_numpy(w), tb, num_microbatches=3)
