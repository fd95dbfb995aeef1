"""repro_torch.dist — the vocab-parallel part of the distribution subsystem.

Mirrors what `src/repro/dist/` gives the vocab-parallel MIDX head (DESIGN
§9): `collectives` (the all-reduces the head's ranks exchange, with the
gradient each must carry, and `all_gather_rows`), `sharding` (the rows of
the class table and of the index each rank owns) and `vocab_parallel`
(the sharded index, the owner-locating sampler, the embedding lookup and
the loss). The data-parallel pieces (`param_specs`, `zero1_specs`,
`batch_spec`, the compressed transports `psum_bf16` / `psum_int8_ef`,
`dist/decode.py`) are not ported yet (ROADMAP.md Queue 1 item 13).

Where the reference runs one program over a `vocab` mesh axis inside
`shard_map`, the port runs one process per shard over a
`torch.distributed` process group (`launch.mesh.VocabGroup`): every
collective is an `all_reduce` (SUM or MAX), so the same code runs on
NCCL and on gloo with CUDA tensors (ranks sharing one card).
"""
from repro_torch.dist.collectives import (all_gather_rows, all_gather_stack,
                                          copy_to_vocab_region, pmax, psum,
                                          psum_no_grad)
from repro_torch.dist.sharding import (gather_params, head_rows_per_shard,
                                       refresh_rows_per_shard, shard_params,
                                       shard_rows, vocab_param_names)
from repro_torch.dist.vocab_parallel import (VocabShardedIndex, embed_lookup,
                                             local_index, loss_midx_vp,
                                             sample_twostage_vp, shard_index,
                                             stack_local_indexes,
                                             unshard_index)

__all__ = [
    "all_gather_rows", "all_gather_stack", "copy_to_vocab_region", "pmax",
    "psum", "psum_no_grad", "gather_params", "head_rows_per_shard",
    "refresh_rows_per_shard", "shard_params", "shard_rows",
    "vocab_param_names", "VocabShardedIndex", "embed_lookup", "local_index",
    "loss_midx_vp", "sample_twostage_vp", "shard_index",
    "stack_local_indexes", "unshard_index",
]
