from repro_torch.kernels import ops
from repro_torch.kernels.stochastic_quant import (
    aggregate, aggregate_plain, dequantize, dequantize_plain, launches,
    plane_in_range, quantize, quantize_plain, reset_launches,
)
