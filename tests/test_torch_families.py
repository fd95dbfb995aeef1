"""The hybrid (zamba2-7b), vlm (llama-3.2-vision-11b) and audio
(whisper-tiny) families of the port against the JAX package on the CPU, at
their reduced configs in fp32; the paged serving of every family; the
bridge and checkpoints of the four new families.

Bars: `forward`'s hidden, `prefill`'s hidden and every cache piece (K/V,
the ssm carries, the hybrid's per-application shared K/V, the cross K/V),
paged decode steps at per-slot positions and the state after them within
1e-4 (the hybrid with a window of 4 under 6-token prompts: ring entries
evicted); one train step's loss within 1e-5 and every gradient within
1e-4 given the same negatives; teacher-forced decode against `forward`
and paged decode with slot recycling against `forward` at 5e-2 in the
configs' bf16 (reference `tests/test_models.py:74`,
`tests/test_serve.py:107`); interleaved serving equal to solo replays;
the bridge and both packages' checkpoints bit for bit both ways. The vlm
gates start at 0 (tanh 0 = 0 hides the cross-attention), so the parity
cases set them to seeded nonzero values in the reference's params before
the bridge carries them. The vlm departure (ROADMAP Queue 3 fact f) is
held by two tests: the reference's paged `write_prefill` fails at two
cross blocks, and the port's paged serve there follows the reference's
slot-major decode within 1e-4. Inputs come from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint import CheckpointManager as JManager
from repro.core import midx as jmidx
from repro.models import decode as jdecode
from repro.models import heads as jheads
from repro.models.model import forward as jforward
from repro.models.model import init_params as jinit
from repro_torch import configs as tcfg
from repro_torch import serve as tserve
from repro_torch.bridge import (index_from_numpy, params_from_numpy,
                                params_to_numpy)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import midx, noise
from repro_torch.launch import steps
from repro_torch.models import decode as tdecode
from repro_torch.models import init_params
from repro_torch.models.model import forward as tforward
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.serve.kv_pool import PagePool

TOL, LOSS_TOL = 1e-4, 1e-5
ARCHS = ("zamba2-7b", "llama-3.2-vision-11b", "whisper-tiny")
FAMILY_ARCHS = ("smollm-135m", "qwen2-moe-a2.7b", "mamba2-370m", "zamba2-7b",
                "llama-3.2-vision-11b", "whisper-tiny")
NEW_ARCHS = ("granite-moe-1b-a400m",) + ARCHS
FIELDS = ("kind", "codebook1", "codebook2", "assign1", "assign2",
          "residuals", "sorted_ids", "offsets", "counts", "log_counts")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    j = dataclasses.replace(jcfg.get_config(arch).reduced(), dtype="float32",
                            **kw)
    t = dataclasses.replace(tcfg.get_config(arch).reduced(), dtype="float32",
                            **kw)
    return j, t


def _params(jc, tc, seed):
    """The reference's init, its vlm gates set to seeded nonzero values,
    and the port's copy."""
    jp = jinit(jc, jax.random.PRNGKey(seed))
    if jc.family == "vlm":
        rng = np.random.default_rng(seed)
        n = jp["cross_blocks"]["gate_attn"].shape[0]
        cb = dict(jp["cross_blocks"])
        for g in ("gate_attn", "gate_mlp"):
            cb[g] = jnp.asarray(rng.uniform(0.5, 1.0, n), jnp.float32)
        jp = {**jp, "cross_blocks": cb}
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


def _media(cfg, b, seed):
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "vlm":
        return {"image_emb": 0.1 * rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": 0.1 * rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, 0)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 16))
    media = _media(jc, 2, 0)
    jo = jforward(jc, jp, jnp.asarray(toks, jnp.int32),
                  **{k: jnp.asarray(v) for k, v in media.items()})
    to = tforward(tc, tp, _t(toks).long(),
                  **{k: _t(v) for k, v in media.items()})
    assert to["hidden"].shape == (2, 16, tc.d_model)
    _close(to["hidden"], jo["hidden"], "hidden")
    assert float(to["aux_loss"]) == float(jo["aux_loss"]) == 0.0
    if jc.family == "vlm":          # the cross blocks move the output
        zero = {**tp, "cross_blocks": [
            {**cb, "gate_attn": torch.zeros(()), "gate_mlp": torch.zeros(())}
            for cb in tp["cross_blocks"]]}
        off = tforward(tc, zero, _t(toks).long(), image_emb=_t(
            media["image_emb"]))["hidden"]
        assert float((off - to["hidden"]).abs().max()) > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_paged_decode_match_reference(arch):
    """Prefill 6 and 5 tokens into slots 0 and 1 of a paged state (the
    hybrid: window 4, so its ring of 4 evicts), then 4 paged decode steps
    at per-slot positions: hidden states and every state piece within
    1e-4 of the reference's."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, 1)
    window = 4 if jc.family == "hybrid" else None
    rng = np.random.default_rng(1)
    page, pps, n_pages = 4, 4, 9
    table = np.arange(1, n_pages, dtype=np.int32).reshape(2, pps)
    jstate = jdecode.init_paged_state(jc, 2, n_pages, page, pps,
                                      window=window)
    tstate = tdecode.init_paged_state(tc, 2, n_pages, page, pps,
                                      device="cpu", window=window)
    if "page_table" in tstate:
        jstate["page_table"] = jnp.asarray(table)
        tstate["page_table"][:] = _t(table).long()
    for slot, plen in enumerate((6, 5)):
        toks = rng.integers(0, jc.vocab_size, (1, plen))
        media = _media(jc, 1, slot)
        jh, jcache = jdecode.prefill(
            jc, jp, jnp.asarray(toks, jnp.int32), window=window,
            **{k: jnp.asarray(v) for k, v in media.items()})
        th, tcache = tdecode.prefill(tc, tp, _t(toks).long(), window=window,
                                     **{k: _t(v) for k, v in media.items()})
        _close(th, jh, f"prefill {slot} hidden")
        assert sorted(tcache) == sorted(jcache)
        for name in tcache:
            _close(tcache[name], jcache[name], f"prefill {slot} {name}")
        jstate = jdecode.write_prefill(jc, jstate, jcache, [slot], plen=plen)
        tdecode.write_prefill(tc, tstate, tcache, torch.tensor([slot]),
                              plen=plen)
    pos = np.asarray([6, 5])
    for step in range(4):
        tok = rng.integers(0, jc.vocab_size, 2)
        jh, jstate = jdecode.paged_decode_step(
            jc, jp, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
            jstate, window=window)
        th, tstate = tdecode.paged_decode_step(tc, tp, _t(tok).long(),
                                               _t(pos).long(), tstate,
                                               window=window)
        _close(th, jh, f"decode {step}")
        pos = pos + 1
    for name, t in tstate.items():
        j = np.asarray(jstate[name])
        if name in ("k", "v"):
            t, j = t[:, 1:], j[:, 1:]          # not the trash page
        if name in ("cross_k", "cross_v"):
            j = j[:t.shape[0]]                 # the reference's L rows
        if t.dtype == torch.long:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
        else:
            _close(t, j, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced slot-major decode steps reproduce forward() at the
    config's bf16 (reference `test_models.py:74`): 5e-2."""
    cfg = tcfg.get_config(arch).reduced()
    params = init_params(cfg, device="cpu")
    toks = _t(np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                (2, 8))).long()
    media = {k: _t(v) for k, v in _media(cfg, 2, 2).items()}
    ref = tforward(cfg, params, toks, **media)["hidden"].float()
    state = tdecode.init_decode_state(cfg, 2, 8, device="cpu", params=params,
                                      **media)
    outs = []
    for t in range(8):
        h, state = tdecode.decode_step(cfg, params, toks[:, t],
                                       torch.full((2,), t), state)
        outs.append(h.float())
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_match_reference(monkeypatch, arch):
    """The port's pooled MIDX loss through `make_loss_fn` (media from the
    batch) and every gradient against the reference's, its draw replaced
    by the port's negatives with log q from its own proposal table; then
    one AdamW step through `make_train_step` is finite and moves the
    params."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, 3)
    jidx = jheads.init_head_state(jc, jp, jax.random.PRNGKey(4))
    tidx = index_from_numpy({f: (getattr(jidx, f) if f == "kind"
                                 else np.asarray(getattr(jidx, f)))
                             for f in FIELDS}, device="cpu")
    rng = np.random.default_rng(3)
    b, s = 2, 16
    toks = rng.integers(0, jc.vocab_size, (b, s))
    labels = rng.integers(0, jc.vocab_size, (b, s))
    media = _media(jc, b, 3)
    batch = {"tokens": _t(toks).long(), "labels": _t(labels).long(),
             **{k: _t(v) for k, v in media.items()}}
    keys = noise.train_keys(0, 3, b * s)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    loss, _ = steps.make_loss_fn(tc)(leaves, tidx, batch, keys)
    flat = tree_leaves(leaves)
    got = iter(torch.autograd.grad(loss, flat))
    grads = tree_map(lambda _: next(got), leaves)

    hidden = tforward(tc, tp, batch["tokens"],
                      **{k: batch[k] for k in media})["hidden"]
    draw = midx.sample_pooled(tidx, hidden.float(), tc.head.num_negatives,
                              noise.sequence_keys(keys, s))
    ids = jnp.asarray(draw.ids.numpy().astype(np.int32))
    kk = jidx.codebook1.shape[0]
    cluster = jidx.assign1[ids] * kk + jidx.assign2[ids]

    def same_negatives(index, key, flat_log, m, member_fn=None):
        lse = jax.nn.logsumexp(flat_log, axis=-1, keepdims=True)
        log_q = (jnp.take_along_axis(flat_log, cluster, axis=-1)
                 - index.log_counts.reshape(-1)[cluster] - lse)
        return jmidx.Draw(ids, log_q)

    monkeypatch.setattr(jmidx, "_shared_draw", same_negatives)

    def jloss(p):
        out = jforward(jc, p, jnp.asarray(toks, jnp.int32),
                       **{k: jnp.asarray(v) for k, v in media.items()})
        return jheads.loss_midx(jc, p, jidx, out["hidden"],
                                jnp.asarray(labels, jnp.int32),
                                jax.random.PRNGKey(0), fused=False)

    jl, jg = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    a = params_to_numpy(tc, grads)
    bt = jax.tree_util.tree_map(np.asarray, jg)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(bt)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree_util.tree_leaves(bt)):
        np.testing.assert_allclose(x, y, atol=TOL, rtol=TOL,
                                   err_msg=jax.tree_util.keystr(path))

    from repro_torch.optim import adamw
    opt = adamw(1e-3)
    before = [p.clone() for p in tree_leaves(tp)]
    _, _, m = steps.make_train_step(tc, opt)(tp, opt.init(tp), tidx, batch,
                                             keys)
    assert np.isfinite(float(m["loss"])) and m["skipped"] == 0.0
    assert not all(torch.equal(x, y) for x, y in zip(before, tree_leaves(tp)))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_paged_decode_matches_forward(arch):
    """Prefill + slot-packed paged decode at different per-slot positions
    reproduces forward() in the config's bf16, then a recycled slot serves
    a fresh request (reference `test_serve.py:107`, moe at capacity factor
    4.0 there too: dropping makes a moe forward non-causal): 5e-2."""
    cfg = tcfg.get_config(arch).reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    params = init_params(cfg, device="cpu")
    s, page, pps, nslots = 8, 4, 3, 3
    state = tdecode.init_paged_state(cfg, nslots, nslots * pps + 1, page,
                                     pps, device="cpu")
    pool = PagePool(nslots * pps + 1, page, pps, nslots)
    rng = np.random.default_rng(4)

    def request():
        toks = _t(rng.integers(0, cfg.vocab_size, (1, s))).long()
        media = {k: _t(v) for k, v in
                 _media(cfg, 1, int(rng.integers(1000))).items()}
        return toks, media, tforward(cfg, params, toks, **media)["hidden"]

    def admit(slot, toks, media, plen):
        if "page_table" in state:
            pool.alloc(slot, s)
            state["page_table"].copy_(_t(pool.table.astype(np.int64)))
        _, cache = tdecode.prefill(cfg, params, toks[:, :plen], **media)
        tdecode.write_prefill(cfg, state, cache, torch.tensor([slot]),
                              plen=plen)

    def close(got, want):
        np.testing.assert_allclose(torch.stack(got).float().numpy(),
                                   want.float().numpy(), atol=5e-2,
                                   rtol=5e-2)

    (ta, ma, ra), (tb, mb, rb) = request(), request()
    plen_a, plen_b = 5, 3
    admit(0, ta, ma, plen_a)
    admit(2, tb, mb, plen_b)
    outs_a, outs_b = [], []
    for t in range(s - plen_a):
        pos = torch.tensor([plen_a + t, 0, plen_b + t])
        tok = torch.stack([ta[0, plen_a + t], torch.tensor(0),
                           tb[0, plen_b + t]])
        h, state = tdecode.paged_decode_step(cfg, params, tok, pos, state)
        outs_a.append(h[0])
        outs_b.append(h[2])
    close(outs_a, ra[0, plen_a:])
    close(outs_b, rb[0, plen_b:plen_b + len(outs_b)])
    tdecode.reset_slot(state, 0)
    if "page_table" in state:
        pool.free(0)
    tc_, mc, rc = request()
    admit(0, tc_, mc, 4)
    outs_c = []
    for t in range(4, s):
        h, state = tdecode.paged_decode_step(
            cfg, params, torch.stack([tc_[0, t], torch.tensor(0),
                                      torch.tensor(0)]),
            torch.tensor([t, 0, 0]), state)
        outs_c.append(h[0])
    close(outs_c, rc[0, 4:])


def _vlm_two_cross():
    """The reduced vlm at 4 layers: two cross-attention blocks."""
    return _cfgs("llama-3.2-vision-11b", num_layers=4)


def test_reference_paged_vlm_cache_cannot_take_two_cross_blocks():
    """The reference sizes its paged cross cache by num_layers (4 here)
    while `prefill` builds one entry a cross block (2): its
    `write_prefill` cannot broadcast them (ROADMAP Queue 3 fact f)."""
    jc, tc = _vlm_two_cross()
    jp = jinit(jc, jax.random.PRNGKey(5))
    media = _media(jc, 1, 5)
    toks = jnp.asarray(np.random.default_rng(5).integers(0, jc.vocab_size,
                                                         (1, 6)), jnp.int32)
    _, cache = jdecode.prefill(jc, jp, toks,
                               image_emb=jnp.asarray(media["image_emb"]))
    assert cache["cross_k"].shape[0] == 2
    state = jdecode.init_paged_state(jc, 2, 9, 4, 4)
    assert state["cross_k"].shape[0] == 4
    state["page_table"] = jnp.asarray(
        np.arange(1, 9, dtype=np.int32).reshape(2, 4))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jdecode.write_prefill(jc, state, cache, [0], plen=6)
    assert tdecode.init_paged_state(tc, 2, 9, 4, 4, device="cpu")[
        "cross_k"].shape[0] == 2


def test_paged_vlm_two_cross_blocks_matches_reference_slot_major():
    """At two cross blocks the port's paged serve (prefill of 6 and 5
    tokens into slots 0 and 1, 4 paged decode steps) against the
    reference's slot-major `init_decode_state` + `write_prefill` +
    `decode_step`: hidden states and cross K/V within 1e-4."""
    jc, tc = _vlm_two_cross()
    jp, tp = _params(jc, tc, 6)
    rng = np.random.default_rng(6)
    emb = _media(jc, 2, 6)["image_emb"]
    jstate = jdecode.init_decode_state(jc, jp, 2, 16,
                                       image_emb=jnp.asarray(emb))
    tstate = tdecode.init_paged_state(tc, 2, 9, 4, 4, device="cpu")
    tstate["page_table"][:] = torch.arange(1, 9).reshape(2, 4)
    for slot, plen in enumerate((6, 5)):
        toks = rng.integers(0, jc.vocab_size, (1, plen))
        img = emb[slot:slot + 1]
        jh, jcache = jdecode.prefill(jc, jp, jnp.asarray(toks, jnp.int32),
                                     image_emb=jnp.asarray(img))
        th, tcache = tdecode.prefill(tc, tp, _t(toks).long(),
                                     image_emb=_t(img))
        _close(th, jh, f"prefill {slot}")
        jstate = jdecode.write_prefill(jc, jstate, jcache, [slot], plen=plen)
        tdecode.write_prefill(tc, tstate, tcache, torch.tensor([slot]),
                              plen=plen)
    pos = np.asarray([6, 5])
    for step in range(4):
        tok = rng.integers(0, jc.vocab_size, 2)
        jh, jstate = jdecode.decode_step(jc, jp, jnp.asarray(tok, jnp.int32),
                                         jnp.asarray(pos, jnp.int32), jstate)
        th, tstate = tdecode.paged_decode_step(tc, tp, _t(tok).long(),
                                               _t(pos).long(), tstate)
        _close(th, jh, f"decode {step}")
        pos = pos + 1
    for name in ("cross_k", "cross_v"):
        _close(tstate[name], jstate[name], name)


@pytest.mark.parametrize("arch,window", [("zamba2-7b", 6),
                                         ("llama-3.2-vision-11b", None),
                                         ("whisper-tiny", None)])
def test_engine_interleaved_matches_single(arch, window):
    """Requests of different lengths (and their media) interleaved on 2
    slots give each request's solo replay, token for token; the hybrid
    with a window under the prompts (ring entries evicted)."""
    cfg = tcfg.get_config(arch).reduced().with_serve(max_slots=2, page_size=4,
                                                     max_seq=32)
    rng = np.random.default_rng(0)
    reqs = []
    for i, (n, m) in enumerate([(6, 5), (9, 7), (6, 3), (11, 6)]):
        media = {k: v[0] for k, v in _media(cfg, 1, i).items()}
        reqs.append(tserve.Request(
            rid=i, tokens=rng.integers(0, cfg.vocab_size, size=n)
            .astype(np.int32), max_new=m, seed=3, **media))
    eng = tserve.Engine(cfg, head="midx", window=window, device="cpu", seed=1)
    res = eng.run(reqs)
    assert eng.stats.waves >= 2
    for r in reqs:
        assert res[r.rid].tokens.shape == (r.max_new,)
        np.testing.assert_array_equal(res[r.rid].tokens,
                                      eng.replay_single(r))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_bridge_and_checkpoints_round_trip(tmp_path, arch):
    """Each family's params with their extra nodes (the MoE experts and
    router, the shared block, the cross blocks, the encoder) cross the
    bridge both ways bit for bit, and a checkpoint of either package
    restores in the other bit for bit."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, 7)
    ref = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(tc, tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    mine = CheckpointManager(str(tmp_path / "port"))
    mine.save(1, tp, metadata={"arch": arch})
    got = JManager(str(tmp_path / "port")).restore(
        1, jax.tree_util.tree_map(jnp.zeros_like, jp), verify=True)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    JManager(str(tmp_path / "ref")).save(1, jp, metadata={"arch": arch})
    like = init_params(tc, device="cpu")
    restored = CheckpointManager(str(tmp_path / "ref")).restore(
        1, like, device="cpu")
    got = params_to_numpy(tc, restored)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert [len(x) for x in (restored["blocks"],
                             restored.get("cross_blocks", []),
                             restored.get("encoder", {}).get("blocks", []))] \
        == [tc.num_layers, len(tp.get("cross_blocks", [])),
            tc.encoder_layers]


def test_train_cli_refuses_media_families():
    """vlm and audio batches carry media the CLI's token stream does not:
    the CLI says to train them through make_train_step."""
    from repro_torch.launch import train as train_cli
    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        with pytest.raises(SystemExit, match="make_train_step"):
            train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--steps", "1"])
