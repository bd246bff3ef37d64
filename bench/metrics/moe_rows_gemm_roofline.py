"""The ``moe_rows_gemm_kernel`` launches' share of their roofline
(``repro_torch.kernels.moe_grouped``: the held experts' products over
their sorted rows), in %: the least time of the round's operations at the
card's fp32 peak (or of its bytes at HBM bandwidth, the larger), over the
launches' summed time in the traced call. The operations count the slots
the call routed to the held experts (the program's counters, which the
driver's call names a range after: ``model_round.ROUTED``): 9 products of
2 D F a slot (``bench.counts.model_flops``)."""
from bench.metrics import _grouped


def read(ctx):
    return _grouped.roofline(ctx, "moe_rows_gemm_kernel", "ROWS_PRODUCTS")
