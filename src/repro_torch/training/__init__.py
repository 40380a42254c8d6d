"""Training (port of ``repro.training``): AdamW and its schedules, the
train step with microbatching and router statistics, synthetic data,
checkpoints with atomic commit, int8 gradient compression."""
from .optimizer import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    wsd_schedule,
)
from .train_step import TrainState, init_train_state, make_train_step  # noqa: F401
from .data import synthetic_batch, SyntheticDataConfig  # noqa: F401
from .checkpoint import latest_step, restore, save  # noqa: F401
from .compression import compress_int8, decompress_int8  # noqa: F401
