from repro_torch.wireless.channel import ChannelModel, ChannelParams
from repro_torch.wireless.energy import comm_energy, comm_latency, comp_energy, comp_latency
from repro_torch.wireless.system import CIFAR10_SYSTEM, FEMNIST_SYSTEM

__all__ = [
    "ChannelModel",
    "ChannelParams",
    "comm_energy",
    "comm_latency",
    "comp_energy",
    "comp_latency",
    "FEMNIST_SYSTEM",
    "CIFAR10_SYSTEM",
]
