"""MIDX proposals (the paper's contribution) behind the Proposal protocol.

Mirrors `src/repro/proposals/midx.py:18-60`. The state is the
`MultiIndex` itself (midx-pq / midx-rq) or {index, emb} for the exact
Theorem-1 variant (midx-exact-*). The fast contenders draw through the
two-stage O(K) sampler with the proposal tables from the midx_probs
kernel (`kernels.midx_probs.ops.proposal_tables`: the CUDA kernel on the
card, its plain version on the CPU), as every other MIDX draw of the port
does; the training and decode fast lanes do not call `sample` at all:
`heads.loss_sampled` / `proposal_decode_head` short-circuit midx-named
proposals to `heads.loss_midx` / `midx_decode_head`.

Departures: init and refresh take a `torch.Generator`; `sample` takes one
counter-hash key per query row (`core.midx.sample_twostage`, which takes
z [T, D]: a [..., D] query is flattened and its draws reshaped back).
"""
from __future__ import annotations

from repro_torch.core import midx as midx_mod
from repro_torch.index.build import build, refresh
from repro_torch.kernels.midx_probs.ops import proposal_tables
from repro_torch.proposals.base import Draw, snapshot, take_along


def midx_init_factory(kind: str, k: int, iters: int = 10):
    def init(gen, class_emb, class_freq=None):
        return build(gen, class_emb.float(), kind=kind, k=k, iters=iters)
    return init


def twostage_draw(index, keys, z, m) -> Draw:
    """The two-stage draw (identical distribution to the flat K²
    categorical) for z [..., D] and keys [...] -> Draw [..., m]."""
    lead = z.shape[:-1]
    draw = midx_mod.sample_twostage(index, z.reshape(-1, z.shape[-1]).float(),
                                    m, keys.reshape(-1),
                                    tables_fn=proposal_tables)
    return Draw(draw.ids.reshape(*lead, m), draw.log_q.reshape(*lead, m))


def midx_sample(state, keys, z, m):
    return twostage_draw(state, keys, z, m)


def midx_log_prob(state, z, ids):
    return midx_mod.log_prob(state, z, ids)


def midx_refresh(state, gen, class_emb):
    return refresh(state, gen, class_emb.float())


def midx_exact_init_factory(kind: str, k: int, iters: int = 10):
    def init(gen, class_emb, class_freq=None):
        idx = build(gen, class_emb.float(), kind=kind, k=k, iters=iters)
        return {"index": idx, "emb": snapshot(class_emb)}
    return init


def midx_exact_sample(state, keys, z, m):
    return midx_mod.sample_exact(state["index"], keys, z, state["emb"], m)


def midx_exact_log_prob(state, z, ids):
    return take_along(midx_mod.exact_log_prob(state["index"], z,
                                              state["emb"]), ids)


def midx_exact_refresh(state, gen, class_emb):
    return {"index": refresh(state["index"], gen, class_emb.float()),
            "emb": snapshot(class_emb)}
