"""Dense and mamba2 backbones, decode paths and the MIDX decode head.

Mirrors `src/repro/models/__init__.py` for what the port has so far."""
from repro_torch.models.model import (init_params, forward, logits_full,
                                      class_embeddings, cast_blocks,
                                      params_to)
from repro_torch.models.decode import (init_decode_state, decode_step,
                                       prefill, init_paged_state,
                                       paged_decode_step, reset_slot,
                                       write_prefill)
from repro_torch.models import heads
