"""repro_torch — the PyTorch/CUDA port of ``repro`` (QCCF wireless FL).

Module names mirror ``src/repro/`` so each port sits beside its
counterpart. The package imports torch and numpy only; the numpy host
maths (channel, KKT, GA, bounds, data) are kept as copies of the JAX
package's modules, and the wire kernels are CUDA C++ built at first use
(``repro_torch.kernels.build``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (``repro_torch.device.resolve_device``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
