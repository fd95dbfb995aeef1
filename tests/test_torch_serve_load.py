"""The serving load (`models.model.init_serving_params`) on the CPU: each
block cast to the compute dtype as it is drawn, bitwise
`cast_blocks(init_params(...))` with the generator left in the same state,
for every model family at its reduced config; the engine's params and
MIDX index (and a quantized head's state) bitwise those of the
fp32-then-cast build, the index built without its residual table bitwise
the full fit's; `Engine.from_checkpoint` bitwise the restore into
fp32 then cast, from the engine's own bf16 checkpoint and from an fp32
export; and the dense family's qwen3-14b, starcoder2-15b and smollm-135m
(reduced, fp32, greedy full head) token for token the reference engine's
from the same params. Inputs come from seeds."""
import dataclasses
import importlib
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import serve as jserve
from repro.models.model import init_params as jinit
from repro_torch import configs as tcfg
from repro_torch import serve as tserve
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import restore_serving_state, save_serving_state
from repro_torch.launch import serve as serve_cli
from repro_torch.models import cast_blocks, heads, init_params, \
    init_serving_params
from repro_torch.models import model as model_mod

# one config a family, and the dense family's other configurations
FAMILY_ARCHS = ("llama3.2-1b", "qwen2-moe-a2.7b", "mamba2-370m", "zamba2-7b",
                "llama-3.2-vision-11b", "whisper-tiny")
DENSE_ARCHS = ("smollm-135m", "qwen3-14b", "starcoder2-15b")
SHAPES = [(6, 5), (9, 7), (6, 3), (11, 6), (4, 6), (9, 2)]  # (plen, max_new)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=""):
    """(path, leaf) pairs of a params tree or head state: dicts, lists,
    dataclasses and named tuples down to tensors and scalars."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}/{f}")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}/{f.name}")
    else:
        yield path, tree


def _assert_bitwise(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, p
            assert torch.equal(x, y), p
        else:
            assert x == y, p


def _cfg(arch, **kw):
    return dataclasses.replace(tcfg.get_config(arch).reduced(), **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("arch", FAMILY_ARCHS + DENSE_ARCHS)
def test_serving_load_is_bitwise_the_cast_of_the_fp32_tree(arch):
    cfg = _cfg(arch)
    assert cfg.dtype == "bfloat16"
    g_new, g_old = _gen(7), _gen(7)
    new = init_serving_params(cfg, g_new, device="cpu")
    old = cast_blocks(cfg, init_params(cfg, g_old, device="cpu"))
    _assert_bitwise(new, old)
    assert torch.equal(g_new.get_state(), g_old.get_state())
    mm = [t for p, t in _leaves(new["blocks"])
          if p.split("/")[-1] in model_mod._MATMUL_WEIGHTS]
    assert mm and all(t.dtype == torch.bfloat16 for t in mm)
    assert new["embed"].dtype == torch.float32


def test_serving_load_at_fp32_is_init_params():
    """At the fp32 compute dtype nothing is cast: the load is
    `init_params` itself."""
    cfg = _cfg("qwen3-14b", dtype="float32")
    g_new, g_old = _gen(3), _gen(3)
    _assert_bitwise(init_serving_params(cfg, g_new, device="cpu"),
                    init_params(cfg, g_old, device="cpu"))
    assert torch.equal(g_new.get_state(), g_old.get_state())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_each_fp32_block_is_freed_before_the_next_is_drawn(arch,
                                                           monkeypatch):
    """Every block initialiser is wrapped: before it draws, no fp32 matmul
    weight of an earlier block is alive any more."""
    cfg = _cfg(arch)
    alive, drawn = [], []

    def watch(fn):
        def wrapped(*a, **kw):
            dead = [r() is None for r in alive]
            assert all(dead), f"{sum(not d for d in dead)} fp32 weights of " \
                              f"earlier blocks still alive"
            bp = fn(*a, **kw)
            for path, t in _leaves(bp):
                if path.split("/")[-1] in model_mod._MATMUL_WEIGHTS:
                    assert t.dtype == torch.float32
                    alive.append(weakref.ref(t))
            drawn.append(fn.__name__)
            return bp
        return wrapped

    for name in ("_attn_block_init", "_mamba_block_init",
                 "_decoder_block_init", "_shared_attn_init",
                 "_cross_block_init"):
        monkeypatch.setattr(model_mod, name, watch(getattr(model_mod, name)))
    for fam, fn in list(model_mod._BLOCK_INIT.items()):
        monkeypatch.setitem(model_mod._BLOCK_INIT, fam,
                            getattr(model_mod, fn.__name__))
    params = init_serving_params(cfg, _gen(1), device="cpu")
    assert alive and all(r() is None for r in alive)
    n_blocks = (cfg.num_layers + cfg.encoder_layers
                + ("shared_attn" in params)
                + len(params.get("cross_blocks", [])))
    assert len(drawn) == n_blocks


@pytest.mark.parametrize("arch,table_dtype", [("llama3.2-1b", "bf16"),
                                              ("qwen3-14b", "bf16"),
                                              ("starcoder2-15b", "int8"),
                                              ("zamba2-7b", "bf16")])
def test_engine_params_and_head_state_are_the_fp32_builds(arch, table_dtype):
    """`Engine(cfg, seed=s)`: params, the MIDX index (a QuantHeadState for
    int8) and the generator state a rebuild replays, bitwise those built
    from the fp32 tree and its cast."""
    cfg = _cfg(arch).with_head(table_dtype=table_dtype)
    for seed in (0, 11):
        eng = tserve.Engine(cfg, device="cpu", seed=seed)
        gen = _gen(seed)
        params = cast_blocks(cfg, init_params(cfg, gen, device="cpu"))
        state = gen.get_state()
        index = heads.init_head_state(cfg, params, gen)
        _assert_bitwise(eng.params, params)
        _assert_bitwise(eng.index, index)
        assert torch.equal(eng._index_gen_state, state)
        _assert_bitwise(eng.rebuild_index(), index)
        assert sorted(eng.build_seconds) == ["index", "params"]


@pytest.mark.parametrize("kind", ["rq", "pq"])
def test_index_build_without_residuals_is_the_full_fits(kind, monkeypatch):
    """`build(keep_residuals=False)` skips the residual table and forms the
    RQ residuals and the distortion a block of rows at a time (blocks of 7
    rows here, so 50 rows span 8): codebooks, assignments, CSR and the
    generator state are bitwise those of the full fit with its residuals
    dropped; a kept residual table is q minus the reconstruction; the
    distortion is the whole-table mean within 1e-6."""
    # by module path: the index package binds `build` to the function
    build_mod, km, qm = (importlib.import_module(f"repro_torch.index.{m}")
                         for m in ("build", "kmeans", "quantization"))
    monkeypatch.setattr(km, "ROW_BLOCK", 7)
    monkeypatch.setattr(qm, "ROW_BLOCK", 7)
    q = torch.from_numpy(np.random.default_rng(0).standard_normal((50, 12))
                         .astype(np.float32))
    g_new, g_old = _gen(2), _gen(2)
    new = build_mod.build(g_new, q, kind=kind, k=4, iters=3,
                          keep_residuals=False)
    full = qm.fit(kind, g_old, q, 4, 3)
    old = dataclasses.replace(build_mod.from_quantization(full),
                              residuals=q.new_zeros((0, 12)))
    _assert_bitwise(new, old)
    assert torch.equal(g_new.get_state(), g_old.get_state())
    recon = qm.reconstruct(kind, full.codebook1, full.codebook2,
                           full.assign1, full.assign2)
    assert torch.equal(full.residuals, q - recon)
    res = km.kmeans(_gen(5), q, 4, 3)
    whole = torch.mean(torch.sum((q - res.centroids[res.assignments]) ** 2,
                                 dim=-1))
    assert abs(float(res.distortion) - float(whole)) <= 1e-6 * float(whole)


def _restore_fp32_then_cast(cfg, root, like_index):
    """The restore as it stood before the serving load: every leaf into
    fp32, then the engine's cast."""
    like_p = init_params(cfg, torch.Generator(), device="meta")
    params, index, _ = restore_serving_state(root, like_p, like_index,
                                             device="cpu")
    return tserve.Engine(cfg, params, index=index, device="cpu")


@pytest.mark.parametrize("arch", ("qwen3-14b", "qwen2-moe-a2.7b",
                                  "whisper-tiny"))
def test_from_checkpoint_is_bitwise_the_restore_into_fp32(arch, tmp_path):
    """From the engine's own checkpoint (bf16 block weights) and from an
    fp32 export (a training run's): the restored engine's params and
    index are those of the fp32 restore and cast, and its block weights
    come back in the compute dtype."""
    cfg = _cfg(arch)
    eng = tserve.Engine(cfg, device="cpu", seed=4)
    eng.save_checkpoint(str(tmp_path / "bf16"))
    fp32 = init_params(cfg, _gen(9), device="cpu")
    save_serving_state(str(tmp_path / "fp32"), 3, fp32, eng.index)
    for root in (tmp_path / "bf16", tmp_path / "fp32"):
        new = tserve.Engine.from_checkpoint(cfg, str(root), device="cpu")
        old = _restore_fp32_then_cast(cfg, str(root), eng.index)
        _assert_bitwise(new.params, old.params)
        _assert_bitwise(new.index, old.index)
        assert new.params["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    _assert_bitwise(
        tserve.Engine.from_checkpoint(cfg, str(tmp_path / "bf16"),
                                      device="cpu").params, eng.params)
    _assert_bitwise(
        tserve.Engine.from_checkpoint(cfg, str(tmp_path / "fp32"),
                                      device="cpu").params,
        cast_blocks(cfg, fp32))


def _requests(mod, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, tokens=rng.integers(0, vocab, size=plen)
                        .astype(np.int32), max_new=n, seed=3)
            for i, (plen, n) in enumerate(SHAPES)]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_configs_greedy_full_head_match_the_reference_engine(arch):
    """qk-norm at GQA (qwen3-14b), LayerNorm and tanh-GELU (starcoder2-15b),
    tied embeddings (smollm-135m): reduced, fp32, the reference's params
    carried by the bridge; every request's tokens equal."""
    jc, tc = (dataclasses.replace(mod.get_config(arch).reduced(),
                                  dtype="float32")
              .with_head(decode_temperature=0.0)
              .with_serve(max_slots=3, page_size=4, max_seq=20)
              for mod in (jcfg, tcfg))
    jp = jinit(jc, jax.random.PRNGKey(5))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jres = jserve.Engine(jc, jp, head="full").run(
        _requests(jserve, jc.vocab_size))
    teng = tserve.Engine(tc, tp, head="full", device="cpu")
    tres = teng.run(_requests(tserve, tc.vocab_size))
    assert teng.stats.waves >= 2
    for rid, (_, n) in enumerate(SHAPES):
        assert tres[rid].status == "ok"
        assert tres[rid].tokens.shape == (n,)
        np.testing.assert_array_equal(tres[rid].tokens, jres[rid].tokens,
                                      err_msg=f"{arch} rid {rid}")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_serve_cli_builds_the_dense_configs_through_the_load(arch):
    out = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "3", "--tokens", "4"])
    assert out["verified"] == 2
    assert all(r.status == "ok" for r in out["results"].values())
