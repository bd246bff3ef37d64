"""npz checkpoints of parameter and state trees (the port of ``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import (
    CheckpointError,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
