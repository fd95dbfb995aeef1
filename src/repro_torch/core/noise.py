"""Counter-based noise: the port's replacement for per-request JAX keys.

The reference engine makes a batched run token-identical to a solo replay
by drawing each slot's randomness under fold_in(fold_in(PRNGKey(seed), rid),
pos) (`src/repro/serve/engine.py:22-27`); torch has no counterpart. The port
instead hashes counters: this is its own copy of the xorshift-multiply hash
of `src/repro/kernels/rff_sample/ref.py:25-55` (`_mix`, `gumbel_noise`),
and every draw of the decode head is a pure function of
(seed, rid, pos, role, draw, column). A slot's draws therefore depend only
on its own request, on the CPU and on the card alike.

The reference computes in int32 with wrapping multiplies and
`shift_right_logical`. Torch's `>>` on int32 is arithmetic, so here every
value is a uint32 held in int64, and each multiply is split into 16-bit
halves so no intermediate leaves int64's range. The hash bits and the
uniforms match the reference's bit for bit; the Gumbel transform then goes
through torch's `log`, which may differ from XLA's float32 log by an ulp.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# The reference's int32 constants, as uint32 bit patterns. They are taken
# from its literals (-1640531535, ...), not from the hex spellings in its
# comments, two of which name other numbers.
_C_T = -1640531535 & _M32
_C_J = -2049568137 & _M32
_C_N = -1028477379 & _M32
_M1 = 0x7FEB352D
_M2 = -2073287029 & _M32

#: Roles salt the draws of one (request, position) apart. ROLE_SHARED_*
#: salt a sequence's shared negatives (pooled and mixture proposals),
#: ROLE_CATEGORICAL the generic proposals' categorical draws. A speculative
#: wave salts its wave key (the row key of the wave's start position) by
#: ROLE_SPEC_DRAFT for its k draft draws, ROLE_SPEC_ACCEPT for the accept
#: test's uniform of draft j and ROLE_SPEC_CORRECT for the correction draw
#: at the first rejected draft. The static and TAPAS contenders
#: (`proposals/`) draw under their own roles: the uniform proposal's ids
#: (ROLE_UNIFORM_IDS), the alias table's bin and flip (ROLE_ALIAS_BIN,
#: ROLE_ALIAS_FLIP), TAPAS's ε-branch, its uniform ids and its pool
#: categorical (ROLE_TAPAS_BRANCH, ROLE_TAPAS_UNIFORM, ROLE_TAPAS_POOL) and
#: its pass-1 pool's Gumbels (ROLE_TAPAS_PASS1); the learnable proposal's
#: auxiliary loss subsamples rows under ROLE_AUX_ROWS. Roles are appended,
#: never renumbered: a new number would change every existing draw's bits.
(ROLE_K1, ROLE_K2, ROLE_MEMBER, ROLE_PICK, ROLE_FULL, ROLE_SHARED_PAIR,
 ROLE_SHARED_MEMBER, ROLE_CATEGORICAL, ROLE_SPEC_DRAFT, ROLE_SPEC_ACCEPT,
 ROLE_SPEC_CORRECT, ROLE_UNIFORM_IDS, ROLE_ALIAS_BIN, ROLE_ALIAS_FLIP,
 ROLE_TAPAS_BRANCH, ROLE_TAPAS_UNIFORM, ROLE_TAPAS_POOL, ROLE_TAPAS_PASS1,
 ROLE_AUX_ROWS) = range(19)
#: Elements of the [T, draws, N] noise block one step of
#: `gumbel_max_draws` materialises.
DRAW_CHUNK = 1 << 22
#: Streams salt a row key by its use: a serving row, or a training token.
STREAM_SERVE, STREAM_TRAIN = range(2)


def _u32(x) -> torch.Tensor:
    """Any int tensor (or Python int) -> its uint32 bit pattern in int64."""
    return torch.as_tensor(x).to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 x and constant c, without overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def hash_bits(seed, t_ids, d_ids, n_ids) -> torch.Tensor:
    """The reference's three-stage hash of (seed, t, d, n) as uint32 in
    int64. Arguments broadcast against each other."""
    h = _mix(_u32(seed) ^ _mul32(_u32(t_ids), _C_T))
    h = _mix(h ^ _mul32(_u32(d_ids), _C_J))
    return _mix(h ^ _mul32(_u32(n_ids), _C_N))


def uniform_noise(seed, t_ids, d_ids, n_ids) -> torch.Tensor:
    """float32 uniforms in (0, 1) from the top 24 hash bits."""
    u24 = (hash_bits(seed, t_ids, d_ids, n_ids) >> 8).to(torch.float32)
    return u24 * (1.0 / (1 << 24)) + (1.0 / (1 << 25))


def uniform_ids(seed, t_ids, d_ids, n: int) -> torch.Tensor:
    """Uniform int64 ids in [0, n) from the full 32 hash bits (column 0)
    by a multiply-high, (h · n) >> 32: the bias between ids is at most
    n / 2^32, where floor(u · n) over the 24-bit uniforms would give some
    ids (n / 2^24 + 1) / (n / 2^24) times the mass of others."""
    return (hash_bits(seed, t_ids, d_ids, 0) * n) >> 32


def gumbel_noise(seed, t_ids, d_ids, n_ids) -> torch.Tensor:
    """Deterministic Gumbel(0,1) noise, as the reference's `gumbel_noise`."""
    return -torch.log(-torch.log(uniform_noise(seed, t_ids, d_ids, n_ids)))


def gumbel_max_draws(logits: torch.Tensor, seeds, t_ids,
                     m: int) -> torch.Tensor:
    """m Gumbel-max draws per row of logits [T, N]: draw d of row t is
    argmax_n logits[t, n] + gumbel_noise(seeds[t], t_ids[t], d, n), the
    first (lowest) column among equal maxima. `seeds` / `t_ids` are [T]
    int tensors or ints. Loops over the draws in chunks of at most
    `DRAW_CHUNK` noise elements, so [T, m, N] is never materialised.
    Returns int64 ids [T, m]."""
    t, n = logits.shape
    dev = logits.device
    seed = _u32(seeds).to(dev).reshape(-1, 1, 1)
    row = _u32(t_ids).to(dev).reshape(-1, 1, 1)
    col = torch.arange(n, device=dev).reshape(1, 1, n)
    step = max(1, DRAW_CHUNK // max(1, t * n))
    ids = torch.empty((t, m), dtype=torch.int64, device=dev)
    for d0 in range(0, m, step):
        draw = torch.arange(d0, min(m, d0 + step), device=dev)
        g = gumbel_noise(seed, row, draw.reshape(1, -1, 1), col)
        ids[:, d0:d0 + draw.numel()] = torch.argmax(logits[:, None, :] + g,
                                                    dim=-1)
    return ids


def row_keys(seed, rid, pos) -> torch.Tensor:
    """Per-row stream key for the token drawn after consuming position
    `pos` of request `rid` under `seed` (broadcasting int tensors)."""
    return hash_bits(seed, rid, pos, STREAM_SERVE)


def train_keys(seed, step, n: int, device=None) -> torch.Tensor:
    """Per-row stream keys [n] of train step `step`: row t (the flat token
    index b·S + s) gets hash(seed, step, t). A function of (seed, step, t)
    alone, so a step replayed after a restart draws the same negatives, on
    the CPU and on the card alike."""
    rows = torch.arange(n, device=device)
    return hash_bits(seed, step, rows, STREAM_TRAIN)


def sequence_keys(token_keys: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Per-sequence keys [B] from a step's token keys [B·S]: sequence b
    takes the key of its first token, hash(seed, step, b·S). Its shared
    draws (under ROLE_SHARED_PAIR / ROLE_SHARED_MEMBER, which no per-token
    draw uses) are then a function of (seed, step, b) at a given S, never
    of B or of the other sequences in the batch."""
    return token_keys.reshape(-1, seq_len)[:, 0]
