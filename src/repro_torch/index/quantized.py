"""Low-bit class table for the head's hot path (DESIGN §12).

Mirrors `src/repro/index/quantized.py:44-312`: `TABLE_DTYPES`,
`resolve_table_dtype` (:51), `storage_dtype` (:65), `quantize_rows` (:73),
`dequantize` (:93), `QuantizedTable` (:98), `dequant_rows` (:123, the
straight-through gather), `quantized_query_scores` (:156), `ResidualCodes`
(:180), `resolve_n_sub` (:197), `fit_residual_codes` (:205),
`residual_scores` (:223), `code_scores` (:240), `QuantHeadState` (:259),
`quantize_head_state` (:291) and `unwrap_index` (:310).

  quantize_rows    per-row symmetric quantization to int8 / fp8-e4m3
                   (`torch.float8_e4m3fn`) with fp32 scales, in the
                   reference's order of operations: the same bits.
  dequant_rows     gather + dequantize; the master table is a dead input
                   whose gradient is the row cotangents scattered onto it
                   (straight-through), so the optimizer keeps updating the
                   master precision while the forward reads 1-byte rows.
  ResidualCodes    PQ codes of the residual r_i = e_i − recon(k1, k2),
                   scored by per-subspace look-up tables (ADC): a candidate
                   costs n_sub code bytes instead of a D-wide row.
  QuantHeadState   the MultiIndex plus the low-bit twins the hot path reads
                   (table, codebooks, residual codes), re-derived on
                   refresh when `quantize_on_refresh`.

Departures: `fit_residual_codes` takes a `torch.Generator` and runs the
port's `index/kmeans.py` on a generator of its own per subspace, seeded
by hash(seed drawn from `gen`, subspace), where the reference folds the
subspace into a JAX key, so a cold fit picks other points than the
reference's. `residual_scores` builds its look-up table as one
(1 × D/n_sub) @ (D/n_sub × ksub) product per (row, subspace) and adds the
subspaces' entries in ascending order, so that a row's score depends on
that row alone (the serving engine's batched == solo).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import noise
from repro_torch.index.build import MultiIndex
from repro_torch.index.kmeans import kmeans
from repro_torch.index.quantization import reconstruct

TABLE_DTYPES = ("bf16", "int8", "fp8")

# symmetric quantization range per format (fp8 = e4m3: max finite 448)
_QMAX = {"int8": 127.0, "fp8": 448.0}


def resolve_table_dtype(table_dtype: str) -> str:
    """Validate cfg.head.table_dtype; raises at init and at step build,
    never falls back."""
    if table_dtype not in TABLE_DTYPES:
        raise ValueError(f"head.table_dtype must be one of {TABLE_DTYPES}, "
                         f"got {table_dtype!r}")
    return table_dtype


def storage_dtype(fmt: str) -> torch.dtype:
    if fmt == "int8":
        return torch.int8
    if fmt == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"no low-bit storage dtype for {fmt!r}")


def quantize_rows(x: torch.Tensor, fmt: str):
    """Per-row symmetric quantization: [N, D] -> (q [N, D], scale [N, 1]).
    scale = max(amax, 1e-30) / Qmax (an all-zero row stays finite and
    quantizes to zero); int8 rounds half to even and clips, fp8 clips to
    ±448 and the cast rounds. Dequantization is q.float() * scale."""
    x = x.float()
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    qmax = _QMAX[fmt]
    scale = torch.clamp(amax, min=1e-30) / qmax
    y = x / scale
    if fmt == "int8":
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(y, -qmax, qmax).to(storage_dtype(fmt))
    return q, scale


def dequantize(data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Whole-table dequantization (tests and tooling, not the hot path)."""
    return data.float() * scale


@dataclasses.dataclass(frozen=True)
class QuantizedTable:
    fmt: str                  # 'int8' | 'fp8'
    data: torch.Tensor        # [V, D] int8 / float8_e4m3fn
    scale: torch.Tensor       # [V, 1] fp32 per-row scales

    @property
    def num_rows(self) -> int:
        return self.data.shape[0]

    def dequantize(self) -> torch.Tensor:
        return dequantize(self.data, self.scale)


# ------------------------------------------------ straight-through gather
class _DequantRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, master, data, scale, ids):
        ctx.save_for_backward(ids)
        ctx.master = (master.shape, master.dtype)
        return data[ids].float() * scale[ids]

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        shape, dtype = ctx.master
        dmaster = torch.zeros(shape, dtype=torch.float32, device=g.device)
        dmaster.index_add_(0, ids.reshape(-1),
                           g.float().reshape(-1, *shape[1:]))
        return dmaster.to(dtype), None, None, None


def dequant_rows(master: torch.Tensor, data: torch.Tensor,
                 scale: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """rows = data[ids] * scale[ids] (fp32) [..., D], with d(rows)/d(master)
    the gather: the row cotangents are added onto zeros of the master's
    shape (`index_add_`) and cast to its dtype. The master is never read;
    `data`, `scale` and `ids` get no gradient (the low-bit copy is derived
    state, refreshed by quantize_on_refresh, never trained)."""
    return _DequantRows.apply(master, data, scale, ids)


def quantized_query_scores(kind: str, qcb1, sc1, qcb2, sc2,
                           z: torch.Tensor):
    """`query_scores` over the low-bit codebooks; the scales apply after
    the dot, z @ (q·s)ᵀ = (z @ qᵀ)·sᵀ, the midx_probs kernel's order."""
    zf = z.float()
    if kind == "pq":
        d = zf.shape[-1]
        z1, z2 = zf[..., : d // 2], zf[..., d // 2:]
    else:
        z1 = z2 = zf
    s1 = (z1 @ qcb1.float().T) * sc1.float().reshape(1, -1)
    s2 = (z2 @ qcb2.float().T) * sc2.float().reshape(1, -1)
    return s1, s2


# ------------------------------------------- PQ codes of the residual term
@dataclasses.dataclass(frozen=True)
class ResidualCodes:
    sub_codebooks: torch.Tensor   # [n_sub, ksub, D/n_sub] fp32
    codes: torch.Tensor           # [V, n_sub] int8 sub-codeword ids

    @property
    def n_sub(self) -> int:
        return self.sub_codebooks.shape[0]

    @property
    def ksub(self) -> int:
        return self.sub_codebooks.shape[1]


def resolve_n_sub(d: int, n_sub: int) -> int:
    """Largest divisor of D not exceeding the requested subspace count."""
    n = max(1, min(n_sub, d))
    while d % n:
        n -= 1
    return n


def fit_residual_codes(gen: torch.Generator, residual: torch.Tensor, *,
                       n_sub: int = 16, ksub: int = 16,
                       iters: int = 4) -> ResidualCodes:
    """PQ-code the residual table: D split into n_sub subspaces, k-means
    with ksub centroids in each (codes fit in int8), subspace s on a
    generator seeded by hash(a seed drawn from `gen`, s). Runs at refresh
    cadence, never per step."""
    v, d = residual.shape
    n_sub = resolve_n_sub(d, n_sub)
    parts = residual.float().reshape(v, n_sub, d // n_sub)
    base = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                             device=gen.device).item())
    cbs, codes = [], []
    for s in range(n_sub):
        g = torch.Generator(device=residual.device)
        g.manual_seed(int(noise.hash_bits(base, s, 0, 0)))
        r = kmeans(g, parts[:, s], ksub, iters)
        cbs.append(r.centroids)
        codes.append(r.assignments.to(torch.int8))
    return ResidualCodes(torch.stack(cbs), torch.stack(codes, dim=-1))


def residual_scores(rc: ResidualCodes, z: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """ADC scores of the coded residual term: z [T, D], ids [T, M] ->
    z·r̃_i per candidate [T, M]. One [n_sub, ksub] table a row, then n_sub
    code gathers a candidate, added in ascending subspace order."""
    n_sub, ksub, dsub = rc.sub_codebooks.shape
    zs = z.float().reshape(*z.shape[:-1], n_sub, 1, dsub)
    lut = torch.matmul(zs, rc.sub_codebooks.transpose(-1, -2))[..., 0, :]
    codes = rc.codes[ids].long()                                # [T,M,S]
    picked = torch.gather(lut[..., None, :, :].expand(
        *codes.shape, ksub), -1, codes[..., None])[..., 0]      # [T,M,S]
    out = picked[..., 0]
    for s in range(1, n_sub):
        out = out + picked[..., s]
    return out


def code_scores(index: MultiIndex, rc: ResidualCodes, z: torch.Tensor,
                ids: torch.Tensor, s1: torch.Tensor,
                s2: torch.Tensor) -> torch.Tensor:
    """Candidate scores from codes only (Theorem 1, paper §4.1):
    o_i ≈ s1[k1(i)] + s2[k2(i)] + ADC(z, codes_i), with s1/s2 [T, K] the
    stage tables the draw already computed: 2 assignments and n_sub code
    bytes a candidate, never a [V, D] row."""
    coarse = (torch.gather(s1, -1, index.assign1[ids])
              + torch.gather(s2, -1, index.assign2[ids]))
    return coarse + residual_scores(rc, z, ids)


# ---------------------------------------------------- the quantized state
@dataclasses.dataclass(frozen=True)
class QuantHeadState:
    """The MultiIndex plus the low-bit twins the hot path reads. Its data
    fields are in the reference's order (its checkpoint layout)."""
    fmt: str                      # 'int8' | 'fp8'
    index: MultiIndex
    qdata: torch.Tensor           # [V, D] low-bit class table
    qscale: torch.Tensor          # [V, 1] fp32 per-row scales
    qcb1: torch.Tensor            # [K, Dc] low-bit stage-1 codebook
    qcb1_scale: torch.Tensor      # [K, 1] fp32 per-codeword scales
    qcb2: torch.Tensor            # [K, Dc] low-bit stage-2 codebook
    qcb2_scale: torch.Tensor      # [K, 1]
    sub_codebooks: torch.Tensor   # [n_sub, ksub, D/n_sub] fp32 residual PQ
    codes: torch.Tensor           # [V, n_sub] int8 residual codes

    @property
    def qtable(self) -> QuantizedTable:
        return QuantizedTable(self.fmt, self.qdata, self.qscale)

    @property
    def residual_codes(self) -> ResidualCodes:
        return ResidualCodes(self.sub_codebooks, self.codes)


QUANT_FIELDS = ("index", "qdata", "qscale", "qcb1", "qcb1_scale", "qcb2",
                "qcb2_scale", "sub_codebooks", "codes")


def quantize_head_state(index: MultiIndex, table: torch.Tensor, fmt: str, *,
                        gen: torch.Generator, n_sub: int = 16,
                        ksub: int = 16, code_iters: int = 4
                        ) -> QuantHeadState:
    """The quantized head state of a (rebuilt) index and the current master
    table: the table and both codebooks quantized per row, the
    reconstruction residual PQ-coded. Runs at init and on refresh."""
    t32 = table.float()
    qdata, qscale = quantize_rows(t32, fmt)
    qcb1, qcb1_s = quantize_rows(index.codebook1, fmt)
    qcb2, qcb2_s = quantize_rows(index.codebook2, fmt)
    resid = t32 - reconstruct(index.kind, index.codebook1, index.codebook2,
                              index.assign1, index.assign2)
    rc = fit_residual_codes(gen, resid, n_sub=n_sub, ksub=ksub,
                            iters=code_iters)
    return QuantHeadState(fmt, index, qdata, qscale, qcb1, qcb1_s, qcb2,
                          qcb2_s, rc.sub_codebooks, rc.codes)


def unwrap_index(state):
    """The MultiIndex inside either head-state flavour."""
    return state.index if isinstance(state, QuantHeadState) else state
