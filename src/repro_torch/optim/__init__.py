from repro_torch.optim.optimizers import (  # noqa: F401
    OptimizerConfig, adamw, clip_by_global_norm, init_opt_state, opt_update,
    sgd_momentum,
)
from repro_torch.optim.schedule import ScheduleConfig, make_schedule  # noqa: F401
