"""Chunked prefill and the prompt-prefix cache of the port against the JAX
package on the CPU (ports of `tests/test_serve_prefix.py`), at the
reference test's size.

Bars: `chunk_prefill_step`'s valid hidden rows and pool K/V within 1e-5 of
the reference's on the same page table and pool; the flash route (a chunk
of 128, its plain version on the CPU) within 1e-5 of the plain route; the
decode wave writing no page of a slot still prefilling; chunked prefill
token for token the whole-prompt path's (the MIDX head against the port,
the greedy full head against the reference's whole-prompt engine); a
cache hit bitwise its cold run, with the donor's pages byte for byte
unchanged, at chunk 8 and on the flash route; eviction under page
pressure; the admitted capacity of a shared prefix; the family refusal.
Params and index are the reference's init, carried over through
`repro_torch.bridge`."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs.base import ModelConfig as JModelConfig
from repro.models.decode import chunk_prefill_step as jchunk
from repro_torch import serve as tserve
from repro_torch.bridge import index_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import chunk_prefill_step, init_paged_state

TOL = 1e-5
FIELDS = ("codebook1", "codebook2", "assign1", "assign2", "residuals",
          "sorted_ids", "offsets", "counts", "log_counts")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, **serve_kw):
    cfg = mod(name="prefix-test", family="dense", num_layers=2, d_model=32,
              num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=96,
              head_dim=16, vocab_pad_multiple=16, remat=False,
              dtype="float32")
    cfg = cfg.with_head(midx_k=4, decode_candidates=8, kmeans_iters=2)
    kw = dict(max_slots=2, page_size=4, max_seq=48)
    kw.update(serve_kw)
    return cfg.with_serve(**kw)


@functools.lru_cache(maxsize=None)
def _base():
    """The reference engine's params and index (PRNGKey(5), as the
    reference test) and the port's copies of them."""
    jeng = jserve.Engine(_cfg(JModelConfig), head="midx",
                         init_key=jax.random.PRNGKey(5))
    tp = params_from_numpy(_cfg(TModelConfig),
                           jax.tree_util.tree_map(np.asarray, jeng.params),
                           device="cpu")
    ti = index_from_numpy({"kind": jeng.index.kind,
                           **{f: np.asarray(getattr(jeng.index, f))
                              for f in FIELDS}}, device="cpu")
    return jeng.params, jeng.index, tp, ti


def _engine(cfg, head="midx"):
    _, _, tp, ti = _base()
    return tserve.Engine(cfg, tp, index=ti, head=head, device="cpu")


def _mk(mod, rid, tokens, max_new=4):
    return mod.Request(rid=rid, tokens=np.asarray(tokens, np.int32),
                       max_new=max_new, seed=2)


def test_chunk_prefill_step_matches_reference():
    """Two chunk waves over a shuffled page table, both slots mid-prompt in
    the second: valid hidden rows and every pool page but the trash page
    within 1e-5 of the reference's."""
    jp, _, tp, _ = _base()
    jcfg, tcfg = _cfg(JModelConfig), _cfg(TModelConfig)
    sv = tcfg.serve
    rng = np.random.default_rng(0)
    table = (1 + rng.permutation(sv.resolved_num_pages - 1)
             [:2 * sv.pages_per_slot]).reshape(2, -1).astype(np.int32)
    state = init_paged_state(tcfg, 2, sv.resolved_num_pages, sv.page_size,
                             sv.pages_per_slot, device="cpu")
    state["page_table"].copy_(torch.from_numpy(table).long())
    from repro.models.decode import init_paged_state as jinit_paged
    jstate = jinit_paged(jcfg, 2, sv.resolved_num_pages, sv.page_size,
                         sv.pages_per_slot)
    jstate["page_table"] = jnp.asarray(table)
    waves = [((0, 0), (8, 0)), ((8, 0), (5, 8))]      # (start, length) a slot
    for starts, lens in waves:
        toks = rng.integers(0, 96, size=(2, 8)).astype(np.int32)
        start, length = np.asarray(starts), np.asarray(lens)
        jh, jstate = jchunk(jcfg, jp, jnp.asarray(toks), jnp.asarray(start),
                            jnp.asarray(length), jstate)
        th, state = chunk_prefill_step(
            tcfg, tp, torch.from_numpy(toks).long(),
            torch.from_numpy(start).long(), torch.from_numpy(length).long(),
            state)
        valid = np.arange(8)[None, :] < length[:, None]
        np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid],
                                   atol=TOL, rtol=TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(state[name][:, 1:].numpy(),
                                       np.asarray(jstate[name])[:, 1:],
                                       atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("start", [0, 16, 128])
def test_flash_route_matches_plain_route(start):
    """A chunk of 128 for one slot at `start`: through `flash_attention_op`
    (its plain version on the CPU) and through the masked einsum, the same
    prefix in the pool; hidden and pool within 1e-5."""
    _, _, tp, _ = _base()
    cfg = _cfg(TModelConfig, max_seq=320)
    sv = cfg.serve
    rng = np.random.default_rng(start)
    outs = []
    for solo in ((1, start), None):
        state = init_paged_state(cfg, 2, sv.resolved_num_pages, sv.page_size,
                                 sv.pages_per_slot, device="cpu")
        state["page_table"].copy_(torch.arange(
            1, 1 + 2 * sv.pages_per_slot).reshape(2, -1))
        gen = torch.Generator().manual_seed(1)
        for name in ("k", "v"):        # a prefix already in the pool
            state[name].copy_(torch.randn(state[name].shape, generator=gen))
        toks = torch.from_numpy(rng.integers(0, 96, size=(2, 128))).long()
        rng = np.random.default_rng(start)
        h, state = chunk_prefill_step(
            cfg, tp, toks, torch.tensor([0, start]), torch.tensor([0, 100]),
            state, solo=solo)
        outs.append((h[1, :100], state["k"][:, 1:], state["v"][:, 1:]))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)


def test_decode_wave_writes_no_page_of_a_prefilling_slot():
    """While slot 1 prefills in chunks, slot 0's decode waves route slot
    1's row to the trash page: its pages change only in its own chunks."""
    eng = _engine(_cfg(TModelConfig, prefill_chunk=4))
    rng = np.random.default_rng(3)
    eng.start_run([_mk(tserve, 0, rng.integers(0, 96, size=3), max_new=8),
                   _mk(tserve, 1, rng.integers(0, 96, size=16))])
    eng.tick(0.0)                         # slot 0's only chunk, a decode wave
    seen = 0
    while 1 in eng.sched.active and eng.sched.active[1].prefilling:
        pages = eng.pool.table[1][:4].astype(np.int64)
        before = eng.state["k"][:, pages].clone()
        done = eng.sched.active[1].prefill_pos
        eng._chunk_wave()                 # one chunk of slot 1, then ...
        after_chunk = eng.state["k"][:, pages].clone()
        decoding = {s: ss for s, ss in eng.sched.active.items()
                    if not ss.prefilling}
        if decoding and eng.sched.active[1].prefilling:
            eng._decode_wave(decoding)    # ... slot 0 decodes beside it
            assert torch.equal(eng.state["k"][:, pages], after_chunk)
            seen += 1
        # the chunk wrote only positions past those already prefilled
        flat = lambda x: x.permute(1, 0, 2, 3, 4).reshape(
            x.shape[1] * x.shape[2], -1)
        assert torch.equal(flat(after_chunk)[:done], flat(before)[:done])
    eng.finish_run()
    assert seen >= 2


def test_chunked_prefill_matches_batched():
    """The MIDX head: chunked against the port's whole-prompt path. The
    greedy full head: the port's chunked engine against the reference's
    whole-prompt engine (prompts of 7, 13 and 9 tokens on 2 slots, a long
    prompt prefilling beside a decoding one)."""
    jp, ji, _, _ = _base()
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, 96, size=plen) for plen in (7, 13, 9)]
    ref = _engine(_cfg(TModelConfig)).run(
        [_mk(tserve, i, t) for i, t in enumerate(toks)])
    chk = _engine(_cfg(TModelConfig, prefill_chunk=8))
    got = chk.run([_mk(tserve, i, t) for i, t in enumerate(toks)])
    for i in range(3):
        np.testing.assert_array_equal(ref[i].tokens, got[i].tokens)
    assert chk.stats.prefill_chunks >= 3
    greedy = dict(decode_temperature=0.0)
    jref = jserve.Engine(_cfg(JModelConfig).with_head(**greedy), jp,
                         index=ji, head="full").run(
        [_mk(jserve, i, t, max_new=6) for i, t in enumerate(toks)])
    tgot = _engine(_cfg(TModelConfig, prefill_chunk=8).with_head(**greedy),
                   head="full").run(
        [_mk(tserve, i, t, max_new=6) for i, t in enumerate(toks)])
    for i in range(3):
        np.testing.assert_array_equal(jref[i].tokens, tgot[i].tokens)


@pytest.mark.parametrize("chunk,shared_len,tail", [(8, 12, 5), (128, 132, 90)])
def test_cache_hit_is_bitwise_identical_and_cow(chunk, shared_len, tail):
    """The second request hits the first's cached prefix and resumes at a
    page-aligned start (at chunk 128, on the flash route: 132 is not a
    multiple of the kernel's tile); its tokens are the cold run's bit for
    bit and the donor's cached pages do not change."""
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 96, size=shared_len)
    reqs = [_mk(tserve, 10 + i, np.concatenate(
        [shared, rng.integers(0, 96, size=tail)])) for i in range(2)]
    cfg = _cfg(TModelConfig, prefix_cache=True, prefill_chunk=chunk,
               max_seq=pad(shared_len + tail + 4, 4))
    eng = _engine(cfg)
    res = eng.run([reqs[0]])
    cached = sorted({n.page for n in eng.cache._nodes.values()})
    before = [eng.state[n][:, cached].clone() for n in ("k", "v")]
    res.update(eng.run([reqs[1]]))
    assert eng.cache.counters()["cache_hits"] > 0
    for name, b in zip(("k", "v"), before):
        assert torch.equal(eng.state[name][:, cached], b), name
    cold = _engine(dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, prefix_cache=False)))
    for r in reqs:
        np.testing.assert_array_equal(
            cold.run([dataclasses.replace(r)])[r.rid].tokens,
            res[r.rid].tokens)
    eng.cache.drop()
    assert eng.pool.free_pages == eng.pool.num_pages - 1


def pad(n, mult):
    return -(-n // mult) * mult


def test_eviction_unblocks_admission_under_pressure():
    rng = np.random.default_rng(3)
    eng = _engine(_cfg(TModelConfig, prefix_cache=True, prefill_chunk=4,
                       max_slots=1, num_pages=10))
    for i in range(3):
        out = eng.run([_mk(tserve, 100 + i, rng.integers(0, 96, size=12))])
        assert out[100 + i].status == "ok"
    c = eng.cache.counters()
    assert c["cache_evictions"] > 0, c
    eng.cache.drop()
    assert eng.pool.free_pages == eng.pool.num_pages - 1


def test_shared_prefix_multiplies_admitted_capacity():
    """At a fixed pool, a shared-prefix tenant mix admits >= 2x the prompts
    once the prefix is cached (shared pages do not draw on the free
    list)."""
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 96, size=16)

    def tenant(rid):
        return _mk(tserve, rid, np.concatenate(
            [shared, rng.integers(0, 96, size=4)]), max_new=3)

    def mk_cfg(**kw):
        return _cfg(TModelConfig, max_slots=8, num_pages=14, page_size=4,
                    max_seq=32, **kw)

    cold = _engine(mk_cfg())
    for i in range(8):
        cold.sched.submit(tenant(i))
    admitted_cold = len(cold.sched.admit(0.0))
    assert admitted_cold == 2                      # 13 // 6
    warm = _engine(mk_cfg(prefix_cache=True))
    warm.run([tenant(100)])                        # seeds the cache (4 pages)
    for i in range(8):
        warm.sched.submit(tenant(i))
    assert len(warm.sched.admit(0.0)) >= 2 * admitted_cold


def test_prefix_cache_requires_attention_family():
    ssm = dataclasses.replace(_cfg(TModelConfig, prefill_chunk=8),
                              family="ssm", ssm_state=16, ssm_head_dim=16)
    with pytest.raises(ValueError, match="chunked prefill"):
        tserve.Engine(ssm, head="midx", device="cpu")
    with pytest.raises(ValueError, match="dense and moe families"):
        chunk_prefill_step(ssm, {}, torch.zeros((1, 4), dtype=torch.long),
                           torch.zeros(1, dtype=torch.long),
                           torch.zeros(1, dtype=torch.long), {})
    moe = get_config("granite-moe-1b-a400m").reduced().with_serve(
        prefix_cache=True, max_slots=2, page_size=4, max_seq=32)
    eng = tserve.Engine(moe, head="midx", device="cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, moe.vocab_size, size=8)
    reqs = [_mk(tserve, i, np.concatenate(
        [prefix, rng.integers(0, moe.vocab_size, size=3)]))
        for i in range(3)]
    res = eng.run(reqs[:1])
    res.update(eng.run(reqs[1:]))
    assert all(res[r.rid].tokens.shape == (4,) for r in reqs)
    assert eng.cache.counters()["cache_hits"] >= 2
