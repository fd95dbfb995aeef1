"""Serving engine: continuous batching around the MIDX decode head.

Mirrors `src/repro/serve/engine.py` (`Engine` :153) for every model
family (dense, moe, ssm, hybrid, vlm, audio; a vlm or audio request
carries its stubbed media, `Request.image_emb` / `frames`, stacked into
its prefill group as the reference does, :464-467), `head` 'midx',
'full' or any
registry proposal mode ('uniform', 'unigram', 'sphere', 'rff', 'rff-fused',
'lsh', 'tapas', 'midx-learnable': the generic candidate-rescore head
`heads.proposal_decode_head`, which sends the learnable contender's index
down the MIDX head; the state initialised from the params when none is
given, reference :159-166, :200-202), and single-token decode
waves over all `max_slots` slots (inactive slots ride along masked and
write only the trash page; an ssm state has no page table, and its
inactive slots' carries are overwritten at admission, as in the reference,
:444, :498). Prefill runs two ways, as in the reference (:169-191,
:494-548):
  - whole-prompt batched prefill, one `prefill` per prompt-length group
    padded to max_slots rows;
  - with `cfg.serve.prefill_chunk` (or the prefix cache, whose chunk
    defaults to the page size), page-aligned chunks on the absolute token
    grid through `decode.chunk_prefill_step`, one chunk a wave, each
    followed by the wave of the slots already decoding, so a long prompt
    never stalls them (`tick`, :590-629). A chunk of a multiple of 128
    tokens runs its attention through the flash kernel at q_offset =
    the chunk's start. The dense and moe families only (ssm, hybrid, vlm,
    audio: ValueError, as the reference's `_CHUNK_FAMILIES`, :71).
With `cfg.serve.prefix_cache` the scheduler matches each prompt against
the refcounted `kv_pool.PrefixCache`: a hit maps the donor's full prompt
pages read-only into the slot's page table and starts its prefill at the
end of them; a prompt's pages are inserted at its last chunk. With
`cfg.serve.spec_decode = k` (head 'midx', dense or moe), each wave drafts k
tokens a slot from ONE two-stage MIDX draw on the hidden that predicted
the slot's last committed token (`heads.midx_spec_draft`: the midx_probs
kernel, or its int8 / fp8 mode), runs them through one chunked backbone
pass and verifies them with one batched full-head pass
(`heads.spec_verify`), committing 1..k tokens (`_spec_wave`, :679-709);
the first token then comes from the full head (:242-248), and greedy
decoding (temperature <= 0) is allowed. The scheduler budgets k − 1
scratch positions a request (`token_slack`). Otherwise greedy decoding
needs head='full' (:188-191). The loop is factored as in the reference:
`start_run` / `tick` / `finish_run`, composed by `run`, which
`serve.router.Router` drives for several replicas. `from_checkpoint` /
`save_checkpoint` (:327-352) restore and write a serving checkpoint,
`{"params", "index"}` in the reference's format, so the engine serves
what either package's `train_loop` exported to `<ckpt>/serve`; with
cfg.head.table_dtype int8 / fp8 the MIDX head serves from a
`QuantHeadState` (its draw scores the low-bit codebooks, its candidates
are rescored from PQ codes) and `from_checkpoint` restores one.

Index hot-swap (reference :355-407, DESIGN §8): `swap_index` installs a
new head state between waves behind the validation gate (a degenerate
state is refused, counted in `stats.swap_rejected`, and `health()["ok"]`
turns False); `schedule_swap(state, at_step)` installs it just before the
decode or speculative wave at decode step `at_step` (`stats.steps`), never
mid-wave; `rebuild_index()` rebuilds the head state from the engine's
params. Every reader of the head state (the MIDX head, the speculative
draft and verify, a chunked prompt's first token, the int8 / fp8 head)
reads `self.index`, so the next wave samples through the swapped state,
and the solo replay engine follows the swap.

Departures:
  - randomness: the token drawn after consuming position p of request r is
    keyed by `core.noise.row_keys(seed, r.rid, p)` — counter-based noise in
    place of fold_in(fold_in(PRNGKey(seed), rid), p) — and every draw is a
    function of that key alone, so batch composition never changes a
    request's tokens; a speculative wave salts the key of its start
    position by role (`noise.ROLE_SPEC_*`) where the reference folds 1, 2
    and 3 into its wave key (:292-294);
  - the MIDX and proposal heads, the speculative draft and the verify run
    once per wave over all max_slots rows (one midx_probs or rff_sample
    launch), not vmapped per slot; a chunked prompt's first token is
    sampled from its last hidden repeated over max_slots rows, so every
    head call has the shape of a decode wave's;
  - the KV pool is updated in place (`models/decode.py`), not donated;
  - the decode wave routes the rows of slots still prefilling in chunks to
    the trash page (`paged_decode_step(active=...)`): the reference packs
    them at position 0 (:651-668) and writes into their first page;
  - `replay_single` replays a request alone in an engine of the SAME
    config and max_slots (the reference uses max_slots=1): every launch
    then has the batched run's shapes, so a GEMM library cannot pick
    another algorithm for another row count and change a row's rounding;
  - `device=None` means the card, and the engine raises without one;
  - the engine shares the params tensors it is given (block weights in
    the compute dtype are cast copies): a train step updates params in
    place (`launch/steps.py`), so a caller that trains on after handing
    params to an engine clones them first;
  - `save_checkpoint` writes the engine's params as it serves them: block
    matmul weights in the compute dtype (bf16 for llama3.2-1b and
    mamba2-370m; tree.json records it), which a restore casts back to
    fp32 exactly;
  - `rebuild_index(gen=None)` takes a `torch.Generator` where the
    reference takes a key; by default it replays the state the engine's
    generator had when the boot head state was built (after any params
    init), so that unchanged params rebuild the boot state bit for bit,
    the quantized twins included.
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
from repro_torch.configs.base import ModelConfig, pad_to
from repro_torch.core import noise
from repro_torch.index.build import MultiIndex
from repro_torch.index.quantized import (QuantHeadState, resolve_table_dtype,
                                         storage_dtype)
from repro_torch.models import (cast_blocks, chunk_prefill_step, heads,
                                init_paged_state, init_params, logits_full,
                                paged_decode_step, params_to, prefill,
                                reset_slot, write_prefill)
from repro_torch.models.model import torch_dtype
from repro_torch.proposals import registry as proposals_registry
from repro_torch.resilience.validate import validate_state
from repro_torch.serve.kv_pool import PagePool, PrefixCache
from repro_torch.serve.scheduler import Request, Scheduler, SlotState
from repro_torch.utils import metrics as metrics_mod

#: families whose paged attention cache makes speculative rollback free
#: (stale draft K/V past the committed position is overwritten before it
#: is ever attended) and that run the chunked backbone pass the verify and
#: the chunked prefill go through (reference :70-71). A moe verify pass of
#: k <= 4 tokens dispatches at capacity >= 4, which never binds (each
#: token picks distinct experts), so its greedy tokens are plain greedy's.
_CHUNK_FAMILIES = ("dense", "moe")


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
    swap_rejected: int = 0          # degenerate head states refused
    swaps: int = 0                  # successful head-state installs
    spec_waves: int = 0             # speculative waves run
    spec_drafted: int = 0           # draft tokens proposed
    spec_accepted: int = 0          # draft tokens accepted by the verifier
    prefill_chunks: int = 0         # chunked-prefill waves run
    latencies_s: list = dataclasses.field(default_factory=list)

    def counters(self) -> dict:
        return {"shed": self.shed, "timeouts": self.timeouts,
                "swap_rejected": self.swap_rejected, "swaps": self.swaps}

    def health(self) -> dict:
        """ok=True means no request was shed or timed out and no swap was
        refused since the last reset."""
        return {"ok": not (self.shed or self.timeouts or self.swap_rejected),
                **self.counters()}

    def accept_rate(self) -> float:
        return self.spec_accepted / max(self.spec_drafted, 1)

    def summary(self) -> dict:
        out = {"generated": self.generated, "wall_s": round(self.wall_s, 3),
               "waves": self.waves, "steps": self.steps,
               "tok_s": round(self.generated / max(self.wall_s, 1e-9), 1)}
        if self.spec_drafted:
            out["accept_rate"] = round(self.accept_rate(), 4)
            out["spec_waves"] = self.spec_waves
        if self.prefill_chunks:
            out["prefill_chunks"] = self.prefill_chunks
        out.update({k: round(v, 3) for k, v in metrics_mod.latency_summary(
            self.latencies_s, counters=self.counters()).items()})
        return out


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
        sv = cfg.serve
        self.spec_k = int(sv.spec_decode or 0)
        chunk = int(sv.prefill_chunk or 0)
        if sv.prefix_cache and chunk == 0:
            chunk = sv.page_size   # a cache hit resumes mid-prompt: chunked
        self.chunk = pad_to(chunk, sv.page_size) if chunk else 0
        if self.spec_k:
            if head != "midx":
                raise ValueError("spec_decode drafts through the MIDX index; "
                                 f"head={head!r} has no two-stage draw")
            if cfg.family not in _CHUNK_FAMILIES:
                raise ValueError(
                    f"spec_decode needs a rollback-free paged attention "
                    f"cache ({'/'.join(_CHUNK_FAMILIES)}), not {cfg.family}")
        if self.chunk and cfg.family not in _CHUNK_FAMILIES:
            raise ValueError(f"chunked prefill / prefix cache support the "
                             f"{'/'.join(_CHUNK_FAMILIES)} families, not "
                             f"{cfg.family}")
        if (cfg.head.decode_temperature <= 0 and self.spec_k == 0
                and head != "full"):
            raise ValueError("greedy decoding (decode_temperature <= 0) "
                             "needs head='full' or spec_decode > 0")
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
        # rebuild_index() replays the generator from here: unchanged params
        # rebuild the boot head state bit for bit
        self._index_gen_state = gen.get_state()
        self._pending_swap = None     # (at decode step, head state) | None
        if head == "midx" and self.index is None:
            self.index = heads.init_head_state(cfg, self.params, gen)
        elif self.proposal is not None and self.index is None:
            self.index = heads.init_proposal_state(cfg, self.params, gen,
                                                   self.proposal)
        self.pool = PagePool(sv.resolved_num_pages, sv.page_size,
                             sv.pages_per_slot, sv.max_slots)
        self.cache = PrefixCache(self.pool) if sv.prefix_cache else None
        self.sched = Scheduler(sv.max_slots, self.pool,
                               max_queue=sv.max_queue or None,
                               cache=self.cache,
                               token_slack=max(0, self.spec_k - 1))
        self.state = init_paged_state(cfg, sv.max_slots,
                                      sv.resolved_num_pages, sv.page_size,
                                      sv.pages_per_slot, device=self.device,
                                      window=window)
        self.stats = EngineStats()
        self._results: dict[int, RequestResult] = {}
        self._t_start = 0.0
        self._waves0 = 0
        self._solo: Optional["Engine"] = None
        self._prefill_fifo: list[int] = []   # chunked-prefill slot order
        # per-slot stream identity (seed, rid), bound at admission
        self._seed = np.zeros(sv.max_slots, np.int64)
        self._rid = np.zeros(sv.max_slots, np.int64)
        # per-slot draft hidden of a speculative engine: the backbone state
        # that predicted the slot's last committed token (set at prefill,
        # moved by each wave)
        self._hdraft = torch.zeros((sv.max_slots, cfg.d_model),
                                   dtype=torch_dtype(cfg), device=self.device)

    # ------------------------------------------------------------ sampling
    def _sample(self, hidden: torch.Tensor, keys: torch.Tensor, *,
                full: bool = False) -> torch.Tensor:
        """Next token per row. hidden [B, D], keys [B] row stream keys;
        `full` samples the exact full head whatever the engine's head."""
        cfg = self.cfg
        if not full and self.proposal is not None:
            return heads.proposal_decode_head(cfg, self.params, self.proposal,
                                              self.index, hidden, keys).token
        if not full and self.head == "midx":
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

    def _bind(self, admitted: list[SlotState]) -> None:
        """Push the host page table and bind the admitted slots' streams."""
        if "page_table" in self.state:
            self.state["page_table"].copy_(torch.from_numpy(
                self.pool.table.astype(np.int64)))
        for ss in admitted:
            self._seed[ss.slot] = ss.request.seed
            self._rid[ss.slot] = ss.request.rid

    # ------------------------------------------------------------ admission
    def _prefill_wave(self, admitted: list[SlotState]) -> None:
        """Prefill newly admitted slots: one batched `prefill` per
        prompt-length group, padded to max_slots rows, written straight into
        the paged pool. First-token latency is charged per group."""
        self._bind(admitted)
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
                                        window=self.window,
                                        **self._media(pad))
            ids = self._upload([ss.slot for ss in pad],
                               [ss.request.seed for ss in pad],
                               [ss.request.rid for ss in pad])
            write_prefill(self.cfg, self.state, cache, ids[0], plen=plen)
            if self.spec_k:    # the last prompt hidden seeds the first draft
                self._hdraft[ids[0]] = hidden[:, -1].to(self._hdraft.dtype)
            keys = noise.row_keys(ids[1], ids[2], plen - 1)
            first = self._sample(hidden[:, -1], keys,
                                 full=bool(self.spec_k)).cpu().numpy()
            for ss, tok in zip(sss, first):
                ss.out.append(int(tok))
                ss.prefill_pos = plen
            dt = time.perf_counter() - t0
            for ss in sss:
                ss.latencies.append(dt)
            self.stats.latencies_s.extend(dt for _ in sss)
        self.stats.generated += len(admitted)

    def _media(self, sss: list[SlotState]) -> dict:
        """The group's stacked media for `prefill`: `image_emb` (vlm) or
        `frames` (audio), [G, N, D] on the card; {} for the other
        families."""
        name = {"vlm": "image_emb", "audio": "frames"}.get(self.cfg.family)
        if name is None:
            return {}
        rows = np.stack([getattr(ss.request, name) for ss in sss])
        return {name: torch.as_tensor(rows, device=self.device)}

    def _admit_chunked(self, admitted: list[SlotState]) -> None:
        """Chunked-mode admission: bind streams and queue the slots for
        prefill chunks; no forward work happens here. A cache hit starts
        the slot's `prefill_pos` at the end of the reused prefix."""
        self._bind(admitted)
        self._prefill_fifo.extend(ss.slot for ss in admitted)

    def _chunk_wave(self) -> None:
        """One page-aligned prefill chunk (<= `self.chunk` tokens) for the
        oldest prefilling slot. Chunk boundaries live on the absolute token
        grid, so a cache-hit resume replays exactly the chunk shapes a cold
        run uses for the same suffix: bitwise the same output."""
        slot = self._prefill_fifo[0]
        ss = self.sched.active[slot]
        req = ss.request
        plen = len(req.tokens)
        start = ss.prefill_pos
        end = min(plen, (start // self.chunk + 1) * self.chunk)
        b = self.cfg.serve.max_slots
        toks = np.zeros((b, self.chunk), np.int64)
        toks[slot, :end - start] = req.tokens[start:end]
        starts = np.zeros(b, np.int64)
        starts[slot] = start
        lens = np.zeros(b, np.int64)
        lens[slot] = end - start
        t0 = time.perf_counter()
        meta = self._upload(starts, lens)
        toks = torch.as_tensor(toks, device=self.device)
        with record_function("engine.prefill_chunk"):
            hidden, self.state = chunk_prefill_step(
                self.cfg, self.params, toks, meta[0], meta[1], self.state,
                window=self.window, solo=(slot, start))
        ss.prefill_pos = end
        self.stats.prefill_chunks += 1
        if end == plen:
            self._prefill_fifo.pop(0)
            if self.cache is not None:
                self.cache.insert(req.tokens, self.pool.table[slot])
            h = hidden[slot, end - start - 1]
            if self.spec_k:
                self._hdraft[slot] = h.to(self._hdraft.dtype)
            key = noise.row_keys(req.seed, req.rid, plen - 1).to(self.device)
            # the last hidden repeated over max_slots rows: the head runs at
            # a decode wave's shape
            first = self._sample(h.expand(b, -1), key.expand(b),
                                 full=bool(self.spec_k))[0]
            ss.out.append(int(first))
            self.stats.generated += 1
        dt = time.perf_counter() - t0
        ss.prefill_s += dt
        if not ss.prefilling:
            # first-token latency spans every chunk wave the prompt took
            ss.latencies.append(ss.prefill_s)
            self.stats.latencies_s.append(ss.prefill_s)

    def warmup(self, prompt_lens) -> None:
        """One prefill per prompt-length bucket plus decode (or speculative)
        waves (and, on the card, the kernel build and first launches), then
        reset stats so later runs report steady-state throughput and
        latency."""
        rng = np.random.default_rng(0)
        cfg = self.cfg
        reqs = []
        for i, plen in enumerate(sorted(set(prompt_lens))):
            kw = {}      # the media, drawn as the reference's (:559-565)
            if cfg.family == "vlm":
                kw["image_emb"] = 0.1 * rng.standard_normal(
                    (cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
            if cfg.family == "audio":
                kw["frames"] = 0.1 * rng.standard_normal(
                    (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
            reqs.append(Request(rid=0x7FFF0000 + i,
                                tokens=np.zeros(plen, np.int32),
                                max_new=max(2, self.spec_k + 1), **kw))
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
        `start_run`): 'prefill' (a batched prefill wave), 'work' (a chunk
        and/or a decode or speculative wave), 'idle' (waiting on an
        arrival) or 'done'."""
        for req in self.sched.drop_expired(now):
            self.stats.timeouts += 1
            self._results[req.rid] = RequestResult(
                req.rid, np.zeros(0, np.int32), [],
                status="timeout", reason="expired before admission")
        self._expire(now)
        admitted = self.sched.admit(now)
        if admitted:
            if self.chunk:
                self._admit_chunked(admitted)
            else:
                self._prefill_wave(admitted)
                self._retire()        # max_new == 1 finishes at prefill
                return "prefill"
        worked = False
        if self._prefill_fifo:
            # one prefill chunk a wave, then the decode wave below: a long
            # prompt never stalls the slots already decoding
            self._chunk_wave()
            self._retire()            # max_new == 1 finishes at its last chunk
            worked = True
        decoding = {slot: ss for slot, ss in self.sched.active.items()
                    if not ss.prefilling}
        if decoding:
            # the hot-swap window: between waves, never mid-wave
            self._maybe_swap()
            if self.spec_k:
                self._spec_wave(decoding)
            else:
                self._decode_wave(decoding)
            self._retire()
            worked = True
        if worked:
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
    def _pack(self, decoding: dict[int, SlotState]) -> torch.Tensor:
        """[5, B] on the card: last token, position, active, seed, rid."""
        b = self.cfg.serve.max_slots
        tokens = np.zeros(b, np.int64)
        pos = np.zeros(b, np.int64)
        active = np.zeros(b, np.int64)
        for slot, ss in decoding.items():
            tokens[slot] = ss.out[-1]
            pos[slot] = ss.pos
            active[slot] = 1
        return self._upload(tokens, pos, active, self._seed, self._rid)

    def _decode_wave(self, decoding: dict[int, SlotState]) -> None:
        """One slot-packed single-token decode step over all slots."""
        t0 = time.perf_counter()
        packed = self._pack(decoding)
        active = packed[2].bool()
        with record_function("engine.decode_backbone"):
            hidden, self.state = paged_decode_step(
                self.cfg, self.params, packed[0], packed[1], self.state,
                window=self.window, active=active)
        with record_function("engine.decode_head"):
            keys = noise.row_keys(packed[3], packed[4], packed[1])
            nxt = torch.where(active, self._sample(hidden, keys), 0)
        nxt = nxt.cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats.steps += 1
        for slot, ss in decoding.items():
            ss.out.append(int(nxt[slot]))
            ss.pos += 1
            ss.latencies.append(dt)
            self.stats.latencies_s.append(dt)
            self.stats.generated += 1

    def _spec_wave(self, decoding: dict[int, SlotState]) -> None:
        """One speculative wave: k MIDX drafts a slot, one chunked backbone
        pass over [last token, drafts[:-1]] and one batched verify,
        committing 1..k tokens a slot (capped at max_new). The wave's
        latency is charged per committed token (the wave's time over its
        committed count: the steady streaming rate)."""
        cfg, k = self.cfg, self.spec_k
        t0 = time.perf_counter()
        packed = self._pack(decoding)
        active = packed[2].bool()
        keys = noise.row_keys(packed[3], packed[4], packed[1])  # wave keys
        with record_function("engine.spec_draft"):
            d = heads.midx_spec_draft(cfg, self.params, self.index,
                                      self._hdraft, keys, k)
        with record_function("engine.spec_backbone"):
            # input j is the token at position pos + j (the last committed
            # token, then the drafts), so output j is the exact target state
            # that verifies draft j
            chunk = torch.cat([packed[0][:, None], d.tokens[:, :-1]], dim=1)
            hiddens, self.state = chunk_prefill_step(
                cfg, self.params, chunk, packed[1], packed[2] * k,
                self.state, window=self.window)              # [B, k, D]
        with record_function("engine.spec_verify"):
            ver = heads.spec_verify(cfg, self.params, self.index,
                                    hiddens.transpose(0, 1), d.tokens.T,
                                    d.log_q.T, d.s1, d.s2, d.lse, keys)
            # the state that predicted this wave's last committed token
            # seeds the next wave's draft
            rows = torch.arange(hiddens.shape[0], device=hiddens.device)
            nh = hiddens[rows, ver.n_commit - 1].to(self._hdraft.dtype)
            self._hdraft = torch.where(active[:, None], nh, self._hdraft)
        out = torch.cat([ver.tokens, ver.n_commit[None],
                         ver.n_accept[None]]).cpu().numpy()       # [k+2, B]
        dt = time.perf_counter() - t0
        self.stats.steps += k
        self.stats.spec_waves += 1
        for slot, ss in decoding.items():
            c = min(int(out[k, slot]), ss.request.max_new - len(ss.out))
            acc = int(out[k + 1, slot])
            ss.out.extend(int(t) for t in out[:c, slot])
            ss.pos += c
            ss.drafted += k
            ss.accepted += acc
            self.stats.spec_drafted += k
            self.stats.spec_accepted += acc
            per_tok = dt / max(c, 1)
            ss.latencies.extend(per_tok for _ in range(c))
            self.stats.latencies_s.extend(per_tok for _ in range(c))
            self.stats.generated += c

    # ------------------------------------------------------------ retirement
    def _drop_prefilling(self, slot: int) -> None:
        if slot in self._prefill_fifo:
            self._prefill_fifo.remove(slot)

    def _retire(self) -> None:
        for slot in [s for s, ss in self.sched.active.items() if ss.done]:
            ss = self.sched.finish(slot)
            self._drop_prefilling(slot)
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
            self._drop_prefilling(slot)
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
        """Run one request alone with the same weights, index, stream and
        media — the reference the batched output must match exactly. The
        solo engine keeps max_slots (see the module docstring) and is
        cached."""
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
            # a proposal state's structure and dtypes do not depend on the
            # vocabulary: built on the CPU from a small table (some
            # contenders' builds have no meta-device kernels)
            like_i = proposals_registry.from_config(cfg.head, head).init(
                torch.Generator(), torch.randn((2 * cfg.head.midx_k,
                                                cfg.d_model)))
        params, index, _ = restore_serving_state(root, like_p, like_i, step,
                                                 device=device)
        return cls(cfg, params, index=index, **{**kw, "device": device})

    def save_checkpoint(self, root: str, step: int = 0) -> str:
        """Write the engine's params and head state as serving checkpoint
        `step` under `root`."""
        return save_serving_state(root, step, self.params, self.index,
                                  metadata={"arch": self.cfg.name,
                                            "head": self.head})

    # ------------------------------------------------------------ index swap
    def swap_index(self, index, validate: bool = True) -> bool:
        """Install a new head state (DESIGN §8). The state is read only
        inside a wave, so installing one between waves leaves in-flight
        slots' pages, positions and streams untouched, and the next wave
        samples through it; a state rebuilt from unchanged params keeps
        every token. The validation gate (DESIGN §11) refuses a degenerate
        state (NaN codebooks, an empty CSR, another structure): the live
        state stays, `stats.swap_rejected` counts it, False comes back."""
        if validate:
            reasons = validate_state(index, like=self.index)
            if reasons:
                self.stats.swap_rejected += 1
                print(f"[engine] swap_index rejected: {'; '.join(reasons)}")
                return False
        self.index = index
        self.stats.swaps += 1
        if self._solo is not None:
            self._solo.index = index
        return True

    def schedule_swap(self, index, at_step: int) -> None:
        """Install `index` just before the wave at decode step `at_step`
        (counted by `stats.steps`) of a later run: the mid-stream swap."""
        self._pending_swap = (at_step, index)

    def rebuild_index(self, gen: Optional[torch.Generator] = None, *,
                      table: Optional[torch.Tensor] = None):
        """The head state (MIDX index, quantized state or proposal state)
        rebuilt from the engine's current params, or fit to `table` in
        place of their class table (a stale state: where the table was).
        The default generator replays the one the boot state was built
        with, so unchanged params give the boot state bit for bit; a
        trainer pushing new params passes its own."""
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.set_state(self._index_gen_state)
        params = self.params
        if table is not None:
            params = {**params,
                      "embed" if self.cfg.tie_embeddings else "head": table}
        if self.proposal is not None:
            return heads.init_proposal_state(self.cfg, params, gen,
                                             self.proposal)
        return heads.init_head_state(self.cfg, params, gen)

    def _maybe_swap(self) -> None:
        if self._pending_swap is not None and \
                self.stats.steps >= self._pending_swap[0]:
            self.swap_index(self._pending_swap[1])
            self._pending_swap = None
