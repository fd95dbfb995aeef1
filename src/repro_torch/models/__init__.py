"""Every family's backbone (dense, moe, ssm, hybrid, vlm, audio), the
decode paths and the decode heads.

Mirrors `src/repro/models/__init__.py`."""
from repro_torch.models.model import (init_params, forward, logits_full,
                                      class_embeddings, cast_blocks,
                                      init_serving_params, params_to)
from repro_torch.models.decode import (init_decode_state, decode_step,
                                       prefill, init_paged_state,
                                       paged_decode_step, reset_slot,
                                       write_prefill, chunk_prefill_step)
from repro_torch.models import heads
