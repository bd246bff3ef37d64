"""The QCCF controller's host-side numpy maths (copies of ``repro.core``)
and the stochastic model quantization of ``core/quantization.py`` in torch
(``quantize_array`` of the fleet's downlink, the object runtime's
``quantize_pytree``/``quantize_upload`` and the wire format of
``quantize_indices``/``dequantize_indices``).
"""
from repro_torch.core.bounds import BoundConstants, data_term, quant_term
from repro_torch.core.controller import QCCFController, auto_epsilons
from repro_torch.core.genetic import (
    Decision,
    GAConfig,
    RoundContext,
    SystemParams,
    evaluate_assignment,
    run_ga,
)
from repro_torch.core.kkt import ClientDecision, ClientEnv, solve_client
from repro_torch.core.lyapunov import LyapunovState
from repro_torch.core.quantization import (
    QuantizedUpload,
    dequantize_indices,
    payload_bits,
    pytree_size,
    quantize_array,
    quantize_indices,
    quantize_pytree,
    quantize_upload,
    variance_bound,
)
