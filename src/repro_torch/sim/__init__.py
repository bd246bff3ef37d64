"""repro_torch.sim — the fleet simulator's round on the device."""
from repro_torch.sim.channel import SimChannel, draw_rates
from repro_torch.sim.engine import DOWNLINK_OFF, DownlinkConfig, FleetSim, SimResult, build_sim
from repro_torch.sim.entropy import DeviceEntropy, FaultDraws, GADraws
from repro_torch.sim.fleet import Fleet, build_fleet, ema_update, fleet_local_sgd
from repro_torch.sim.policy import (
    FastDecision, HostFastPolicy, decide, decide_host, greedy_assign,
    greedy_assign_host, solve_kkt,
)
from repro_torch.sim.scenario import (
    ASSOCIATIONS, FAULTS_OFF, POLICIES, DataSpec, FaultSpec, LyapunovSpec, Scenario,
    Topology, get_scenario, register_scenario, scenario_names,
)
from repro_torch.sim.search import HostGAPolicy, ga_decide, run_ga_host
