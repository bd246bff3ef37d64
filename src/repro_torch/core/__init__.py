"""Host-side numpy maths of the QCCF controller (copies of ``repro.core``).

``quantization`` holds only what the fleet round calls (``quantize_array``
of the downlink, ``payload_bits``, ``variance_bound``); the wire quantisers
live in ``repro_torch.kernels``.
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
