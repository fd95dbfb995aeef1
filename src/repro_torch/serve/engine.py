"""Serving engine: continuous batching around the MIDX decode head.

Mirrors `src/repro/serve/engine.py` (`Engine` :153) for what the port
serves: the dense and ssm (mamba2) families, `head` 'midx', 'full' or a
ported registry
proposal ('rff', 'rff-fused': the generic candidate-rescore head
`heads.proposal_decode_head`, its state initialised from the params when
none is given, reference :159-166, :200-202), whole-prompt batched
prefill (one `prefill` per prompt-length group, padded to max_slots rows)
and single-token decode waves over all `max_slots` slots (inactive slots
ride along masked and write only the trash page; an ssm state has no page
table, and its inactive slots' carries are overwritten at admission, as
in the reference, :444, :498). The loop is factored as
in the reference: `start_run` / `tick` / `finish_run`, composed by `run`.
`from_checkpoint` / `save_checkpoint` (:327-352) restore and write a
serving checkpoint, `{"params", "index"}` in the reference's format, so
the engine serves what either package's `train_loop` exported to
`<ckpt>/serve`; with cfg.head.table_dtype int8 / fp8 the MIDX head serves
from a `QuantHeadState` (its draw scores the low-bit codebooks, its
candidates are rescored from PQ codes) and `from_checkpoint` restores
one. Speculative decoding, chunked prefill, the prefix cache,
index hot-swap and the unported proposals raise NotImplementedError (see
ROADMAP.md). The greedy rule of the reference (:188-191) is kept:
temperature <= 0 needs head='full'.

Departures:
  - randomness: the token drawn after consuming position p of request r is
    keyed by `core.noise.row_keys(seed, r.rid, p)` — counter-based noise in
    place of fold_in(fold_in(PRNGKey(seed), rid), p) — and every draw is a
    function of that key alone, so batch composition never changes a
    request's tokens;
  - the MIDX and proposal heads run once per wave over all max_slots rows
    (one midx_probs or rff_sample launch), not vmapped per slot;
  - the KV pool is updated in place (`models/decode.py`), not donated;
  - `replay_single` replays a request alone in an engine of the SAME
    max_slots (the reference uses max_slots=1): every launch then has the
    batched run's shapes, so a GEMM library cannot pick another algorithm
    for another row count and change a row's rounding;
  - `device=None` means the card, and the engine raises without one;
  - the engine shares the params tensors it is given (block weights in
    the compute dtype are cast copies): a train step updates params in
    place (`launch/steps.py`), so a caller that trains on after handing
    params to an engine clones them first;
  - `save_checkpoint` writes the engine's params as it serves them: block
    matmul weights in the compute dtype (bf16 for llama3.2-1b and
    mamba2-370m; tree.json records it), which a restore casts back to
    fp32 exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.checkpoint import (CheckpointManager, restore_serving_state,
                                   save_serving_state)
from repro_torch.configs.base import ModelConfig
from repro_torch.core import noise
from repro_torch.index.build import MultiIndex
from repro_torch.index.quantized import (QuantHeadState, resolve_table_dtype,
                                         storage_dtype)
from repro_torch.models import (cast_blocks, heads, init_paged_state,
                                init_params, logits_full, paged_decode_step,
                                params_to, prefill, reset_slot, write_prefill)
from repro_torch.models.model import require_ported
from repro_torch.proposals import registry as proposals_registry
from repro_torch.serve.kv_pool import PagePool
from repro_torch.serve.scheduler import Request, Scheduler, SlotState
from repro_torch.utils import metrics as metrics_mod


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray              # generated ids (may be partial)
    latencies_s: list               # per-token wall latency
    status: str = "ok"              # 'ok' | 'shed' | 'timeout'
    reason: str = ""                # rejection reason when status != 'ok'


@dataclasses.dataclass
class EngineStats:
    generated: int = 0
    wall_s: float = 0.0
    waves: int = 0
    steps: int = 0
    shed: int = 0                   # structured admission rejections
    timeouts: int = 0               # deadline retirements (partial results)
    latencies_s: list = dataclasses.field(default_factory=list)

    def counters(self) -> dict:
        return {"shed": self.shed, "timeouts": self.timeouts}

    def health(self) -> dict:
        """ok=True means no request was shed or timed out since the last
        reset."""
        return {"ok": not (self.shed or self.timeouts), **self.counters()}

    def summary(self) -> dict:
        out = {"generated": self.generated, "wall_s": round(self.wall_s, 3),
               "waves": self.waves, "steps": self.steps,
               "tok_s": round(self.generated / max(self.wall_s, 1e-9), 1)}
        out.update({k: round(v, 3) for k, v in metrics_mod.latency_summary(
            self.latencies_s, counters=self.counters()).items()})
        return out


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet; "
                               "see ROADMAP.md Queue 1 item 6")


class Engine:
    """Continuous-batching serving engine over the paged KV pool."""

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 index=None, head: str = "midx",
                 window: Optional[int] = None, device=None, seed: int = 0):
        proposals_registry.validate_mode(head)
        # 'midx'/'full' keep their dedicated decode paths; a registered
        # contender serves through the generic proposal head
        self.proposal = (None if head in ("midx", "full")
                         else proposals_registry.from_config(cfg.head, head))
        require_ported(cfg)
        sv = cfg.serve
        if sv.spec_decode:
            raise _unported("speculative decoding (spec_decode)")
        if sv.prefill_chunk:
            raise _unported("chunked prefill (prefill_chunk)")
        if sv.prefix_cache:
            raise _unported("the prompt-prefix cache")
        if cfg.head.decode_temperature <= 0 and head != "full":
            raise ValueError("greedy decoding (decode_temperature <= 0) "
                             "needs head='full'")
        self.cfg = cfg
        self.head = head
        self.window = window
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if params is None:
            params = init_params(cfg, gen, device=self.device)
        self.params = cast_blocks(cfg, params_to(params, self.device))
        self.index = index
        if head == "midx" and self.index is None:
            self.index = heads.init_head_state(cfg, self.params, gen)
        elif self.proposal is not None and self.index is None:
            self.index = heads.init_proposal_state(cfg, self.params, gen,
                                                   self.proposal)
        self.pool = PagePool(sv.resolved_num_pages, sv.page_size,
                             sv.pages_per_slot, sv.max_slots)
        self.sched = Scheduler(sv.max_slots, self.pool,
                               max_queue=sv.max_queue or None)
        self.state = init_paged_state(cfg, sv.max_slots,
                                      sv.resolved_num_pages, sv.page_size,
                                      sv.pages_per_slot, device=self.device)
        self.stats = EngineStats()
        self._results: dict[int, RequestResult] = {}
        self._t_start = 0.0
        self._waves0 = 0
        self._solo: Optional["Engine"] = None
        # per-slot stream identity (seed, rid), bound at admission
        self._seed = np.zeros(sv.max_slots, np.int64)
        self._rid = np.zeros(sv.max_slots, np.int64)

    # ------------------------------------------------------------ sampling
    def _sample(self, hidden: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """Next token per row. hidden [B, D], keys [B] row stream keys."""
        cfg = self.cfg
        if self.proposal is not None:
            return heads.proposal_decode_head(cfg, self.params, self.proposal,
                                              self.index, hidden, keys).token
        if self.head == "midx":
            return heads.midx_decode_head(cfg, self.params, self.index,
                                          hidden, keys).token
        logits = logits_full(cfg, self.params, hidden)[:, : cfg.vocab_size]
        t = cfg.head.decode_temperature
        if t <= 0:
            return torch.argmax(logits, dim=-1)
        col = torch.arange(cfg.vocab_size, device=hidden.device)
        g = noise.gumbel_noise(keys[:, None], noise.ROLE_FULL, 0, col)
        return torch.argmax(logits / t + g, dim=-1)

    def _upload(self, *rows) -> torch.Tensor:
        """One host->device copy of equal-length int rows -> [n, B] int64."""
        return torch.as_tensor(np.stack(rows).astype(np.int64),
                               device=self.device)

    # ------------------------------------------------------------ admission
    def _prefill_wave(self, admitted: list[SlotState]) -> None:
        """Prefill newly admitted slots: one batched `prefill` per
        prompt-length group, padded to max_slots rows, written straight into
        the paged pool. First-token latency is charged per group."""
        if "page_table" in self.state:
            self.state["page_table"].copy_(torch.from_numpy(
                self.pool.table.astype(np.int64)))
        for ss in admitted:
            self._seed[ss.slot] = ss.request.seed
            self._rid[ss.slot] = ss.request.rid
        groups: dict[int, list[SlotState]] = {}
        for ss in admitted:
            groups.setdefault(len(ss.request.tokens), []).append(ss)
        b = self.cfg.serve.max_slots
        for plen, sss in groups.items():
            t0 = time.perf_counter()
            # padding rows duplicate row 0: a row's arithmetic never depends
            # on the others, so padding cannot change any request's output
            pad = sss + [sss[0]] * (b - len(sss))
            toks = self._upload(*[ss.request.tokens for ss in pad])
            with record_function("engine.prefill"):
                hidden, cache = prefill(self.cfg, self.params, toks,
                                        window=self.window)
            ids = self._upload([ss.slot for ss in pad],
                               [ss.request.seed for ss in pad],
                               [ss.request.rid for ss in pad])
            write_prefill(self.cfg, self.state, cache, ids[0], plen=plen)
            keys = noise.row_keys(ids[1], ids[2], plen - 1)
            first = self._sample(hidden[:, -1], keys).cpu().numpy()
            for ss, tok in zip(sss, first):
                ss.out.append(int(tok))
                ss.prefill_pos = plen
            dt = time.perf_counter() - t0
            for ss in sss:
                ss.latencies.append(dt)
            self.stats.latencies_s.extend(dt for _ in sss)
        self.stats.generated += len(admitted)

    def warmup(self, prompt_lens) -> None:
        """One prefill per prompt-length bucket plus decode waves (and, on
        the card, the kernel build and first launches), then reset stats so
        later runs report steady-state throughput and latency."""
        reqs = [Request(rid=0x7FFF0000 + i, tokens=np.zeros(plen, np.int32),
                        max_new=2)
                for i, plen in enumerate(sorted(set(prompt_lens)))]
        self.run(reqs)
        self.stats = EngineStats()

    # ------------------------------------------------------------ main loop
    def start_run(self, requests: list[Request]) -> dict[int, RequestResult]:
        """Submit `requests` (shedding bad traffic as structured results)
        and arm the run clock. Drive with `tick`; close with `finish_run`."""
        self._results = {}
        for r in requests:
            rej = self.sched.submit(r)
            if rej is not None:
                self.stats.shed += 1
                self._results[r.rid] = RequestResult(
                    r.rid, np.zeros(0, np.int32), [],
                    status="shed", reason=f"{rej.reason}: {rej.detail}")
        self._t_start = time.perf_counter()
        self._waves0 = self.sched.waves
        return self._results

    def tick(self, now: float) -> str:
        """One engine iteration at wall-time `now` (seconds since
        `start_run`): 'prefill', 'work' (a decode wave), 'idle' (waiting on
        an arrival) or 'done'."""
        for req in self.sched.drop_expired(now):
            self.stats.timeouts += 1
            self._results[req.rid] = RequestResult(
                req.rid, np.zeros(0, np.int32), [],
                status="timeout", reason="expired before admission")
        self._expire(now)
        admitted = self.sched.admit(now)
        if admitted:
            self._prefill_wave(admitted)
            self._retire()            # max_new == 1 finishes at prefill
            return "prefill"
        if self.sched.active:
            self._decode_wave(dict(self.sched.active))
            self._retire()
            return "work"
        return "done" if self.sched.done else "idle"

    def finish_run(self) -> dict[int, RequestResult]:
        self.stats.wall_s += time.perf_counter() - self._t_start
        self.stats.waves += self.sched.waves - self._waves0
        return self._results

    def run(self, requests: list[Request]) -> dict[int, RequestResult]:
        """Drive all requests to completion; open-loop arrivals honored
        against wall-clock time since `run` started."""
        self.start_run(requests)
        while not self.sched.done:
            now = time.perf_counter() - self._t_start
            if self.tick(now) == "idle":
                nxt = self.sched.next_arrival()
                if nxt is not None and nxt > now:
                    time.sleep(min(nxt - now, 0.05))
        return self.finish_run()

    # ------------------------------------------------------------ decode waves
    def _decode_wave(self, decoding: dict[int, SlotState]) -> None:
        """One slot-packed single-token decode step over all slots."""
        b = self.cfg.serve.max_slots
        tokens = np.zeros(b, np.int64)
        pos = np.zeros(b, np.int64)
        active = np.zeros(b, np.int64)
        for slot, ss in decoding.items():
            tokens[slot] = ss.out[-1]
            pos[slot] = ss.pos
            active[slot] = 1
        t0 = time.perf_counter()
        packed = self._upload(tokens, pos, active, self._seed, self._rid)
        with record_function("engine.decode_backbone"):
            hidden, self.state = paged_decode_step(
                self.cfg, self.params, packed[0], packed[1], self.state,
                window=self.window)
        with record_function("engine.decode_head"):
            keys = noise.row_keys(packed[3], packed[4], packed[1])
            nxt = torch.where(packed[2].bool(), self._sample(hidden, keys),
                              0)
        nxt = nxt.cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats.steps += 1
        for slot, ss in decoding.items():
            ss.out.append(int(nxt[slot]))
            ss.pos += 1
            ss.latencies.append(dt)
            self.stats.latencies_s.append(dt)
            self.stats.generated += 1

    # ------------------------------------------------------------ retirement
    def _retire(self) -> None:
        for slot in [s for s, ss in self.sched.active.items() if ss.done]:
            ss = self.sched.finish(slot)
            reset_slot(self.state, slot)
            self._results[ss.request.rid] = RequestResult(
                ss.request.rid, np.asarray(ss.out, np.int32), ss.latencies)

    def _expire(self, now: float) -> None:
        """Retire active slots whose deadline passed: the tokens generated so
        far come back as a partial 'timeout' result."""
        expired = [s for s, ss in self.sched.active.items()
                   if ss.request.deadline is not None
                   and now > ss.request.deadline]
        for slot in expired:
            ss = self.sched.finish(slot)
            reset_slot(self.state, slot)
            self.stats.timeouts += 1
            self._results[ss.request.rid] = RequestResult(
                ss.request.rid, np.asarray(ss.out, np.int32), ss.latencies,
                status="timeout",
                reason=f"deadline {ss.request.deadline:.3f}s exceeded at "
                       f"{now:.3f}s with {len(ss.out)}/{ss.request.max_new} "
                       "tokens")

    # ------------------------------------------------------------ verification
    def replay_single(self, req: Request) -> np.ndarray:
        """Run one request alone with the same weights, index and stream —
        the reference the batched output must match exactly. The solo
        engine keeps max_slots (see the module docstring) and is cached."""
        if self._solo is None:
            self._solo = Engine(self.cfg, self.params, index=self.index,
                                head=self.head, window=self.window,
                                device=self.device)
        res = self._solo.run([dataclasses.replace(req, arrival=0.0)])
        return res[req.rid].tokens

    # ------------------------------------------------------------ checkpoints
    @classmethod
    def from_checkpoint(cls, cfg: ModelConfig, root: str, *,
                        step: Optional[int] = None, **kw) -> "Engine":
        """Restore params and head state saved by `save_checkpoint` (or by
        either package's `train_loop` serving export) and build an engine
        around them; `kw` as for `Engine` (head, window, device, seed).
        With step=None the newest checkpoint that verifies is used."""
        head = kw.get("head", "midx")
        proposals_registry.validate_mode(head)
        device = resolve_device(kw.get("device"))
        # restore targets: only their structure and dtypes are read, so
        # they are built on the meta device
        like_p = init_params(cfg, torch.Generator(), device="meta")
        if head in ("midx", "full"):
            f32, i64 = torch.float32, torch.int64
            like_i = MultiIndex(cfg.head.quantizer, *(
                torch.empty(0, dtype=d, device="meta")
                for d in (f32, f32, i64, i64, f32, i64, i64, i64, f32)))
            fmt = resolve_table_dtype(cfg.head.table_dtype)
            if fmt != "bf16":       # the quantized head's state around it
                q = storage_dtype(fmt)
                like_i = QuantHeadState(fmt, like_i, *(
                    torch.empty(0, dtype=d, device="meta")
                    for d in (q, f32, q, f32, q, f32, f32, torch.int8)))
            # the full head reads no index: a training run's export carries
            # the run's MultiIndex, as the reference's does, while an
            # engine serving the full head saves none
            mgr = CheckpointManager(root)
            newest = mgr.latest_step() if step is None else step
            if head == "full" and newest is not None and not mgr.matches(
                    newest, {"params": like_p, "index": like_i}):
                like_i = None
        else:
            like_i = heads.init_proposal_state(
                cfg, like_p, torch.Generator(),
                proposals_registry.from_config(cfg.head, head))
        params, index, _ = restore_serving_state(root, like_p, like_i, step,
                                                 device=device)
        return cls(cfg, params, index=index, **{**kw, "device": device})

    def save_checkpoint(self, root: str, step: int = 0) -> str:
        """Write the engine's params and head state as serving checkpoint
        `step` under `root`."""
        return save_serving_state(root, step, self.params, self.index,
                                  metadata={"arch": self.cfg.name,
                                            "head": self.head})

    # ------------------------------------------------------------ unported
    def swap_index(self, *args, **kw):
        raise _unported("index hot-swap (Engine.swap_index)")

    def schedule_swap(self, *args, **kw):
        raise _unported("index hot-swap (Engine.schedule_swap)")
