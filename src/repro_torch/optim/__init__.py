"""Tree optimizers in torch (the port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgd,
)
