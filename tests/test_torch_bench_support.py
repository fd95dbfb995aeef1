"""The modules the benchmark twins read, against the JAX package on the
CPU: the RecSys and XMC generators (bitwise, the same arguments and
seeds), the seven ranking / load / speculative metrics (integer outputs
exactly, the rest within 1e-6), `global_batch_iterator`'s batches
(bitwise), the `core` re-export shims (the reference's names and
`__all__`, bound to the port's index, K-means and quantizer code),
`make_sampler` for every name of `SAMPLER_NAMES` (the port's
`make_proposal` with the same knobs: equal states, draws and log q), the
shared-negative `sampled_softmax_from_embeddings`, and the shims importing
with jax blocked. Inputs come from numpy seeds."""
import dataclasses
import importlib
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import samplers as jsamplers
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.utils import metrics as jmetrics
import repro_torch.core as tcore
from repro_torch.core import samplers as tsamplers
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import synthetic as tsynthetic
from repro_torch.index import quantization as tquant
from repro_torch.proposals import registry
from repro_torch.serve.engine import EngineStats
from repro_torch.utils import metrics as tmetrics

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
SHIMS = ("index", "kmeans", "quantization", "samplers")
KNOBS = dict(k=8, kmeans_iters=3, alpha=50.0, rff_dim=16, rff_tau=2.0,
             lsh_tables=4, lsh_bits=3)
N, D = 96, 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- generators
@pytest.mark.parametrize("args", [dict(num_users=7, num_items=50, seq_len=9),
                                  dict(num_users=3, num_items=200, seq_len=4,
                                       d_latent=8, seed=5)])
def test_recsys_interactions_are_the_references(args):
    got = tsynthetic.recsys_interactions(**args)
    want = jsynthetic.recsys_interactions(**args)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [dict(num_samples=20, num_labels=40,
                                       feat_dim=30),
                                  dict(num_samples=9, num_labels=300,
                                       feat_dim=64, nnz=5, num_clusters=4,
                                       seed=3)])
def test_xmc_dataset_is_the_references(args):
    (fg, lg), (fw, lw) = (tsynthetic.xmc_dataset(**args),
                          jsynthetic.xmc_dataset(**args))
    assert fg.dtype == fw.dtype == np.float32 and lg.dtype == np.int32
    np.testing.assert_array_equal(fg, fw)
    np.testing.assert_array_equal(lg, lw)
    assert ((fg != 0).sum(axis=1) <= args.get("nnz", 20)).all()


def test_the_data_package_exports_the_references_names():
    import repro.data as jdata
    import repro_torch.data as tdata
    names = {n for n in vars(jdata) if not n.startswith("_")
             and n not in ("synthetic", "pipeline")}
    assert names <= set(vars(tdata))


@pytest.mark.parametrize("global_batch,shards,seed,start", [
    (8, 2, 0, 0), (12, 3, 5, 7), (4, 1, 2, 100)])
def test_global_batch_iterator_yields_the_references_batches(
        global_batch, shards, seed, start):
    corpus = np.random.default_rng(1).integers(
        0, 500, size=(40, 17)).astype(np.int32)
    got = tpipeline.global_batch_iterator(corpus, global_batch, shards, seed,
                                          start)
    want = jpipeline.global_batch_iterator(corpus, global_batch, shards, seed,
                                           start)
    for _ in range(4):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in w:
            assert g[k].dtype == w[k].dtype
            assert g[k].shape == (global_batch, 16)
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------- metrics
def _scores(seed=0, b=32, n=50, ties=True):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n)).astype(np.float32)
    if ties:
        s[:, 10:20] = np.round(s[:, 10:20], 1)     # tied scores
    return s, rng.integers(0, n, size=b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranking_metrics_equal_the_references(seed):
    scores, targets = _scores(seed)
    got = tmetrics.rank_of_target(scores, targets)
    want = jmetrics.rank_of_target(scores, targets)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for k in (1, 5, 10, 50):
        for fn in ("recall_at_k", "ndcg_at_k"):
            a = getattr(tmetrics, fn)(scores, targets, k)
            b = getattr(jmetrics, fn)(scores, targets, k)
            assert isinstance(a, float) and abs(a - b) <= 1e-6, (fn, k)
    rng = np.random.default_rng(seed + 10)
    label_sets = [set(rng.integers(0, 50, size=rng.integers(1, 6)).tolist())
                  for _ in range(len(scores))]
    for k in (1, 3, 5):
        a = tmetrics.precision_at_k(scores, label_sets, k)
        b = jmetrics.precision_at_k(scores, label_sets, k)
        assert abs(a - b) <= 1e-6
    for ce in (0.0, 1.7, 6.25):
        assert abs(tmetrics.perplexity(ce) - jmetrics.perplexity(ce)) \
            <= 1e-6 * jmetrics.perplexity(ce)


def _results(seed):
    rng = np.random.default_rng(seed)
    statuses = ("ok", "ok", "ok", "shed", "timeout", "ok")
    return {i: SimpleNamespace(
        status=st, tokens=np.arange(rng.integers(1, 9)),
        latencies_s=list(rng.uniform(0.001, 0.2, size=rng.integers(1, 9))))
        for i, st in enumerate(statuses)}


@pytest.mark.parametrize("deadline_ms", [None, 50.0, 0.5])
def test_serving_load_summary_equals_the_references(deadline_ms):
    for seed in (0, 1):
        res = _results(seed)
        got = tmetrics.serving_load_summary(res, 1.37, deadline_ms)
        want = jmetrics.serving_load_summary(res, 1.37, deadline_ms)
        assert sorted(got) == sorted(want)
        for k in ("admitted", "shed", "timeouts", "tokens"):
            assert got[k] == want[k], k
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), k


def test_spec_decode_summary_equals_the_references():
    from repro.serve.engine import EngineStats as JStats
    for drafted, accepted, waves in ((0, 0, 0), (40, 13, 10), (7, 7, 2)):
        t, j = EngineStats(), JStats()
        for s in (t, j):
            s.spec_waves, s.spec_drafted, s.spec_accepted = \
                waves, drafted, accepted
        got = tmetrics.spec_decode_summary(t)
        want = jmetrics.spec_decode_summary(j)
        assert sorted(got) == sorted(want)
        for k in ("spec_waves", "spec_drafted", "spec_accepted"):
            assert got[k] == want[k]
        assert abs(got["accept_rate"] - want["accept_rate"]) <= 1e-6


# ---------------------------------------------------------------- shims
@pytest.mark.parametrize("shim", SHIMS)
def test_shims_carry_the_references_names(shim):
    j = importlib.import_module(f"repro.core.{shim}")
    t = importlib.import_module(f"repro_torch.core.{shim}")
    assert t.__all__ == j.__all__
    for name in t.__all__:
        assert hasattr(t, name), name


def test_shims_bind_the_ports_index_code():
    # by module path: the packages bind `build` and `kmeans` to functions
    cindex, ckmeans, cquant, tbuild, tkmeans = (
        importlib.import_module(f"repro_torch.{m}") for m in (
            "core.index", "core.kmeans", "core.quantization", "index.build",
            "index.kmeans"))
    for name in cindex.__all__:
        assert getattr(cindex, name) is getattr(tbuild, name)
    for name in ckmeans.__all__:
        assert getattr(ckmeans, name) is getattr(tkmeans, name)
    for name in cquant.__all__:
        assert getattr(cquant, name) is getattr(
            tkmeans if name == "_assign" else tquant, name)
    assert tsamplers.SAMPLER_NAMES == jsamplers.SAMPLER_NAMES
    assert tsamplers.Sampler is registry.Proposal


def test_core_package_exports_the_references_names_lazily():
    public = {n for n in vars(jcore) if not n.startswith("_")}
    public -= {"alias", "index", "kmeans", "quantization", "sampled_softmax",
               "learnable", "samplers", "midx_multi"}      # submodules
    for name in public | {"make_sampler", "Sampler", "SAMPLER_NAMES"}:
        assert hasattr(tcore, name), name
    assert tcore.make_sampler is tsamplers.make_sampler
    with pytest.raises(AttributeError):
        tcore.no_such_name


def test_assign_new_assigns_against_the_fitted_codebooks():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    new = torch.from_numpy(rng.standard_normal((17, D)).astype(np.float32))
    for kind in ("pq", "rq"):
        quant = tquant.fit(kind, torch.Generator().manual_seed(1), q, 8, 3)
        a1, a2 = tquant.assign_new(quant, new)
        b1, b2 = tquant.assign_against(kind, quant.codebook1,
                                       quant.codebook2, new)
        assert torch.equal(a1, b1) and torch.equal(a2, b2)
        r1, r2 = tquant.assign_new(quant, q)           # the fit's own rows
        assert torch.equal(r1, quant.assign1)
        if kind == "pq":
            assert torch.equal(r2, quant.assign2)


def _emb():
    rng = np.random.default_rng(0)
    centers = 2.0 * rng.standard_normal((8, D))
    return torch.from_numpy((centers[rng.integers(0, 8, N)]
                             + 0.1 * rng.standard_normal((N, D)))
                            .astype(np.float32))


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


@pytest.mark.parametrize("name", jsamplers.SAMPLER_NAMES)
def test_make_sampler_is_make_proposal_with_the_same_knobs(name):
    emb, freq = _emb(), np.random.default_rng(1).random(N) + 0.1
    z = torch.from_numpy(np.random.default_rng(3).standard_normal((5, D))
                         .astype(np.float32))
    for knobs in ({}, KNOBS):
        s = tsamplers.make_sampler(name, **knobs)
        p = registry.make_proposal(name, **knobs)
        assert (s.name, s.adaptive, s.trainable) == \
            (p.name, p.adaptive, p.trainable)
        st_s = s.init(torch.Generator().manual_seed(4), emb, freq)
        st_p = p.init(torch.Generator().manual_seed(4), emb, freq)
        assert _same(st_s, st_p)
        keys = torch.arange(5) * 3 + 1
        ds, dp = s.sample(st_s, keys, z, 10), p.sample(st_p, keys, z, 10)
        assert torch.equal(ds.ids, dp.ids) and torch.equal(ds.log_q, dp.log_q)
        assert torch.equal(s.log_prob(st_s, z, ds.ids),
                           p.log_prob(st_p, z, dp.ids))


def test_sampled_softmax_from_embeddings_equals_the_references():
    import jax.numpy as jnp
    from repro.core import sampled_softmax_from_embeddings as jfn
    rng = np.random.default_rng(5)
    table = rng.standard_normal((N, D)).astype(np.float32)
    h = rng.standard_normal((3, 4, D)).astype(np.float32)
    pos = rng.integers(0, N, size=(3, 4)).astype(np.int32)
    for neg_shape in ((9,), (3, 4, 9)):
        neg = rng.integers(0, N, size=neg_shape).astype(np.int32)
        neg.reshape(-1)[0] = pos.reshape(-1)[0]          # a collision
        lq = (-4.0 + rng.standard_normal(neg_shape)).astype(np.float32)
        for mask in (True, False):
            got = tcore.sampled_softmax_from_embeddings(
                torch.from_numpy(h), torch.from_numpy(table),
                torch.from_numpy(pos), torch.from_numpy(neg),
                torch.from_numpy(lq), mask)
            want = jfn(jnp.asarray(h), jnp.asarray(table), jnp.asarray(pos),
                       jnp.asarray(neg), jnp.asarray(lq), mask)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)


def test_shims_and_support_modules_import_with_jax_blocked():
    mods = [f"repro_torch.core.{s}" for s in SHIMS] + [
        "repro_torch.core", "repro_torch.data", "repro_torch.utils.metrics"]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import repro_torch.core as c\n"
            "assert c.make_sampler('uniform').name == 'uniform'\n"
            "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
