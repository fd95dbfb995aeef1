"""In-place optimizers, gradient accumulation and LR schedules over the
port's params dict (mirrors `src/repro/optim/`)."""
from repro_torch.optim.accumulate import accumulate_gradients
from repro_torch.optim.optimizers import (Optimizer, OptState, adamw,
                                          clip_by_global_norm, sgd)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup
