from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, adamw, clip_by_global_norm, global_norm, make_optimizer,
    momentum, sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine_warmup, linear_warmup,
)
