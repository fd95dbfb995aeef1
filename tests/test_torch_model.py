"""The dense backbone's serving path against the JAX package, from the same
params carried across by `repro_torch.bridge`: batched prefill (hidden and
K/V cache), its write into the paged pool, then 4 paged decode steps at
per-slot positions — and, at each step, the MIDX head's IS-corrected
candidate logits for the reference's own draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import midx as jmidx
from repro.models import decode as jdecode
from repro.models import heads as jheads
from repro.models.model import forward as jforward
from repro.models.model import init_params as jinit
from repro_torch import configs as tcfg
from repro_torch.bridge import index_from_numpy, params_from_numpy
from repro_torch.core import midx
from repro_torch.models import decode as tdecode
from repro_torch.models import heads
from repro_torch.models.model import forward as tforward

FIELDS = ("kind", "codebook1", "codebook2", "assign1", "assign2",
          "residuals", "sorted_ids", "offsets", "counts", "log_counts")
PAGE, PPS = 4, 4                     # page size, pages per slot
PLENS = (6, 5)                       # slot 0 and slot 1 prompt lengths
STEPS = 4


def _cfgs(arch, reduced, dtype):
    j = jcfg.get_config(arch)
    t = tcfg.get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    return (dataclasses.replace(j, dtype=dtype),
            dataclasses.replace(t, dtype=dtype))


def _run_both(arch, reduced, dtype, seed=0):
    """Yield (stage, jax_array, torch_tensor) pairs along the serving path."""
    jc, tc = _cfgs(arch, reduced, dtype)
    jp = jinit(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    rng = np.random.default_rng(seed)
    n_pages = 2 * PPS + 1
    table = np.arange(1, n_pages, dtype=np.int32).reshape(2, PPS)
    jstate = jdecode.init_paged_state(jc, 2, n_pages, PAGE, PPS)
    jstate["page_table"] = jnp.asarray(table)
    tstate = tdecode.init_paged_state(tc, 2, n_pages, PAGE, PPS,
                                      device="cpu")
    tstate["page_table"][:] = torch.from_numpy(table.astype(np.int64))
    out = []
    for slot, plen in enumerate(PLENS):
        toks = rng.integers(0, jc.vocab_size, (1, plen)).astype(np.int32)
        jh, jcache = jdecode.prefill(jc, jp, jnp.asarray(toks))
        th, tcache = tdecode.prefill(tc, tp, torch.from_numpy(toks).long())
        out += [("prefill hidden", jh, th), ("prefill k", jcache["k"],
                                            tcache["k"]),
                ("prefill v", jcache["v"], tcache["v"])]
        jstate = jdecode.write_prefill(jc, jstate, jcache, [slot], plen=plen)
        tdecode.write_prefill(tc, tstate, tcache, torch.tensor([slot]),
                              plen=plen)
    pos = np.asarray(PLENS, np.int32)
    for step in range(STEPS):
        tok = rng.integers(0, jc.vocab_size, 2).astype(np.int32)
        jh, jstate = jdecode.paged_decode_step(jc, jp, jnp.asarray(tok),
                                               jnp.asarray(pos), jstate)
        th, tstate = tdecode.paged_decode_step(
            tc, tp, torch.from_numpy(tok).long(),
            torch.from_numpy(pos).long(), tstate)
        out.append((f"decode {step} hidden", jh, th))
        pos = pos + 1
    out += [("pool k", jstate["k"][:, 1:], tstate["k"][:, 1:]),
            ("pool v", jstate["v"][:, 1:], tstate["v"][:, 1:])]
    return out, (jc, tc, jp, tp)


@pytest.mark.parametrize("arch,reduced", [("paper-lm", False),
                                          ("llama3.2-1b", True),
                                          ("smollm-135m", True),
                                          ("qwen3-14b", True),
                                          ("starcoder2-15b", True)])
def test_prefill_and_paged_decode_match_fp32(arch, reduced):
    """fp32 end to end: within 1e-4 (summation order over the layers
    differs between the two frameworks' CPU kernels)."""
    pairs, _ = _run_both(arch, reduced, "float32")
    for name, j, t in pairs:
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_forward_and_slot_major_decode_match_fp32():
    """`model.forward` equals the reference's, and the slot-major
    `decode_step` (no page table) tracks the reference's over 3 steps at
    per-slot positions, to the same 1e-4."""
    jc, tc = _cfgs("llama3.2-1b", True, "float32")
    jp = jinit(jc, jax.random.PRNGKey(4))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jc.vocab_size, (2, 7)).astype(np.int32)
    jh = jforward(jc, jp, jnp.asarray(toks))["hidden"]
    th = tforward(tc, tp, torch.from_numpy(toks).long())["hidden"]
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)
    jstate = jdecode.init_decode_state(jc, jp, 2, 8)
    tstate = tdecode.init_decode_state(tc, 2, 8, device="cpu")
    pos = np.asarray([0, 2], np.int32)
    for step in range(3):
        tok = rng.integers(0, jc.vocab_size, 2).astype(np.int32)
        jh, jstate = jdecode.decode_step(jc, jp, jnp.asarray(tok),
                                         jnp.asarray(pos), jstate)
        th, tstate = tdecode.decode_step(tc, tp, torch.from_numpy(tok).long(),
                                         torch.from_numpy(pos).long(), tstate)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {step}")
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(tstate[name].numpy(),
                                   np.asarray(jstate[name]), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_prefill_and_paged_decode_match_bf16():
    """bf16 (the configs' working type): within 5e-2 absolute and
    relative. bf16 keeps 8 mantissa bits (relative step 2^-8 ~ 4e-3), and
    the two frameworks round intermediates at different places, so a few
    steps' worth of that step is the bar."""
    pairs, _ = _run_both("llama3.2-1b", True, "bfloat16", seed=1)
    for name, j, t in pairs:
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   atol=5e-2, rtol=5e-2, err_msg=name)


def test_midx_head_corrected_logits_match_each_decode_step():
    jc, tc = _cfgs("paper-lm", False, "float32")
    jp = jinit(jc, jax.random.PRNGKey(2))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jidx = jheads.init_head_state(jc, jp, jax.random.PRNGKey(3))
    tidx = index_from_numpy({f: (getattr(jidx, f) if f == "kind"
                                 else np.asarray(getattr(jidx, f)))
                             for f in FIELDS}, device="cpu")
    pairs, _ = _run_both("paper-lm", False, "float32", seed=2)
    hiddens = [j for name, j, _ in pairs if name.startswith("decode")]
    temp, m = 0.7, 16
    for step, h in enumerate(hiddens):
        draw = jmidx.sample_twostage(jidx, jax.random.PRNGKey(10 + step),
                                     h.astype(jnp.float32), m)
        table = jp["embed"]
        jlogits = jnp.einsum("bd,bmd->bm", h, table[draw.ids]) / temp
        jcorr = np.asarray(jlogits - draw.log_q)
        th = torch.from_numpy(np.array(h))
        ids = torch.from_numpy(np.asarray(draw.ids).astype(np.int64))
        lq = midx.log_prob(tidx, th, ids)
        tcorr = heads.candidate_logits(tc, tp, th, ids, lq, temp)
        np.testing.assert_allclose(tcorr.numpy(), jcorr, atol=1e-5,
                                   rtol=1e-5, err_msg=f"step {step}")


def test_bridge_carries_bf16_leaves_bit_for_bit():
    jc, tc = _cfgs("paper-lm", True, "bfloat16")
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                jinit(jc, jax.random.PRNGKey(6)))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    assert tree["embed"].dtype.name == "bfloat16"
    tp = params_from_numpy(tc, tree, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert len(tp["blocks"]) == tc.num_layers
    for li in range(tc.num_layers):
        for name in ("wq", "wo"):
            want = tree["blocks"]["attn"][name][li].view(np.uint16)
            got = tp["blocks"][li]["attn"][name].view(torch.int16).numpy()
            np.testing.assert_array_equal(got.view(np.uint16), want)
