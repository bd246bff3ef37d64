"""Device busy milliseconds a round inside the program's ``mamba_mixer``
ranges on the device's timeline (``repro_torch.models.model``: each
Mamba-2 mixer's forward, its recompute under remat, and its backward,
whose range the backward opens; ``obs.profile.ranged``)."""
from bench import spans


def read(ctx):
    return spans.device_busy_ms_per_round(ctx["view"], ("mamba_mixer",))
