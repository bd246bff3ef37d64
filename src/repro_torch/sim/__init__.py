"""repro_torch.sim — the fleet simulator's QCCF round on the device."""
from repro_torch.sim.channel import SimChannel, draw_rates
from repro_torch.sim.engine import FleetSim, SimResult, build_sim
from repro_torch.sim.entropy import DeviceEntropy
from repro_torch.sim.fleet import Fleet, build_fleet, ema_update, fleet_local_sgd
from repro_torch.sim.policy import (
    FastDecision, decide, greedy_assign, greedy_assign_host, solve_kkt,
)
