"""Checkpoints in the reference's on-disk format (mirrors
`src/repro/checkpoint/`)."""
from repro_torch.checkpoint.manager import (CheckpointError,
                                            CheckpointManager,
                                            restore_serving_state,
                                            restore_sharded, save_gathered,
                                            save_serving_state)
