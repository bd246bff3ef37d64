"""The ``moe_wgrad_gemm_kernel`` launches' share of their roofline
(``repro_torch.kernels.moe_grouped``: the held experts' weight gradients,
each a sum over its sorted rows), in %, as ``moe_rows_gemm_roofline``
reads it: 3 products of 2 D F a routed slot."""
from bench.metrics import _grouped


def read(ctx):
    return _grouped.roofline(ctx, "moe_wgrad_gemm_kernel", "WGRAD_PRODUCTS")
