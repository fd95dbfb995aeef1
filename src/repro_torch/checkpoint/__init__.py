"""Checkpoints in the reference's on-disk format (mirrors
`src/repro/checkpoint/`)."""
from repro_torch.checkpoint.manager import (CheckpointError,
                                            CheckpointManager,
                                            restore_serving_state,
                                            save_serving_state)
