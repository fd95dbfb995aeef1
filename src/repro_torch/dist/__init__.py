"""repro_torch.dist — the distribution subsystem's runtime part.

Mirrors what `src/repro/dist/` gives the train and serve paths:
`collectives` (the all-reduces of the vocab-parallel head, with the
gradient each must carry, `all_gather_rows`, and the data-parallel
gradient transports `pmean`, `psum_bf16` and `psum_int8_ef`, DESIGN §4),
`sharding` (the rows of the class table and of the index each vocab rank
owns, the batch rows each data rank trains on), `vocab_parallel` (the
sharded index, the owner-locating sampler, the embedding lookup and the
loss, DESIGN §9) and `decode` (the sequence-sharded decode attention with
its LSE merge, DESIGN §5). `param_specs`, `zero1_specs` /
`opt_state_specs`, `decode_cache_specs` and the MoE shard_map dispatch
reach only the reference's compile-only dry run and are not ported
(ROADMAP.md Queue 1, the dry-run item).

Where the reference runs one program over mesh axes inside `shard_map`,
the port runs one process per shard over `torch.distributed` process
groups (`launch.mesh.RankGrid`: a data group and a vocab group a rank):
every collective is an `all_reduce` (SUM or MAX), so the same code runs on
NCCL and on gloo with CUDA tensors (ranks sharing one card).
"""
from repro_torch.dist.collectives import (all_gather_rows, all_gather_stack,
                                          copy_to_vocab_region, pmax, pmean,
                                          psum, psum_bf16, psum_int8_ef,
                                          psum_no_grad)
from repro_torch.dist.decode import flash_decode_seq_sharded
from repro_torch.dist.sharding import (data_rows, gather_params,
                                       head_rows_per_shard,
                                       refresh_rows_per_shard, shard_params,
                                       shard_rows, vocab_param_names)
from repro_torch.dist.vocab_parallel import (VocabShardedIndex, embed_lookup,
                                             local_index, loss_midx_vp,
                                             sample_twostage_vp, shard_index,
                                             stack_local_indexes,
                                             unshard_index)

__all__ = [
    "all_gather_rows", "all_gather_stack", "copy_to_vocab_region", "pmax",
    "pmean", "psum", "psum_bf16", "psum_int8_ef", "psum_no_grad",
    "flash_decode_seq_sharded", "data_rows", "gather_params",
    "head_rows_per_shard", "refresh_rows_per_shard", "shard_params", "shard_rows", "vocab_param_names", "VocabShardedIndex",
    "embed_lookup", "local_index", "loss_midx_vp", "sample_twostage_vp",
    "shard_index", "stack_local_indexes", "unshard_index",
]
