from repro_torch.wireless.channel import ChannelModel, ChannelParams
from repro_torch.wireless.system import CIFAR10_SYSTEM, FEMNIST_SYSTEM
