"""repro_torch.dist — the distribution subsystem.

Mirrors `src/repro/dist/`: `collectives` (the all-reduces of the
vocab-parallel head and of the model axis, with the gradient each must
carry, `all_gather_rows` / `all_gather_dim`, the data-parallel gradient
transports `pmean`, `psum_bf16` and `psum_int8_ef`, DESIGN §4, and the
recording groups and counting the dry run's plan and the chip smoke read),
`sharding` (the spec trees `param_specs`, `zero1_specs`, `batch_spec`,
`index_specs`, `decode_cache_specs` with `shard_by_spec` /
`gather_by_spec`; the rows of the class table and of the index each vocab
rank owns, the batch rows each data rank trains on), `tensor_parallel`
(the model axis: Megatron's column / row split of attention, the MLP and
the MoE experts, DESIGN §4), `vocab_parallel` (the sharded index, the
owner-locating sampler, the embedding lookup and the losses, DESIGN §9)
and `decode` (the sequence-sharded decode attention with its LSE merge,
DESIGN §5). `optim.opt_state_specs` / `optim.zero1` (ZeRO-1 moments) and
the MoE sharded dispatch (`models.moe.set_moe_group`) use them. The
reference runs these in its multi-device tests (`tests/test_dist.py:87`,
`:122`, `:149`) and its dry run; the port runs them in its ranks and
plans them on the meta device (`launch.dryrun`).

Where the reference runs one program over mesh axes inside `shard_map`,
the port runs one process per shard over `torch.distributed` process
groups (`launch.mesh.RankGrid`: a data group and a model or vocab group
a rank): every collective is an `all_reduce` (SUM or MAX), so the same
code runs on NCCL and on gloo with CUDA tensors (ranks sharing one card).
"""
from repro_torch.dist.collectives import (RecordingGroup, all_gather_dim,
                                          all_gather_rows, all_gather_stack,
                                          copy_to_vocab_region, counting,
                                          pmax, pmean, psum, psum_bf16,
                                          psum_int8_ef, psum_no_grad)
from repro_torch.dist.decode import flash_decode_seq_sharded
from repro_torch.dist.sharding import (batch_spec, data_rows,
                                       decode_cache_specs, gather_by_spec,
                                       gather_params, head_rows_per_shard,
                                       index_specs, param_specs,
                                       refresh_rows_per_shard, shard_by_spec,
                                       shard_params, shard_rows,
                                       vocab_param_names, zero1_specs)
from repro_torch.dist.vocab_parallel import (VocabShardedIndex, embed_lookup,
                                             local_index, loss_full_vp,
                                             loss_midx_vp,
                                             sample_twostage_vp, shard_index,
                                             stack_local_indexes,
                                             unshard_index)

__all__ = [
    "RecordingGroup", "all_gather_dim", "all_gather_rows",
    "all_gather_stack", "copy_to_vocab_region", "counting", "pmax",
    "pmean", "psum", "psum_bf16", "psum_int8_ef", "psum_no_grad",
    "flash_decode_seq_sharded", "batch_spec", "data_rows",
    "decode_cache_specs", "gather_by_spec", "gather_params",
    "head_rows_per_shard", "index_specs", "param_specs",
    "refresh_rows_per_shard", "shard_by_spec", "shard_params", "shard_rows",
    "vocab_param_names", "zero1_specs", "VocabShardedIndex", "embed_lookup",
    "local_index", "loss_full_vp", "loss_midx_vp", "sample_twostage_vp",
    "shard_index", "stack_local_indexes", "unshard_index",
]
