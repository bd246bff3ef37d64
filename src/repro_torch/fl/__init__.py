from repro_torch.fl.client import sgd_step
from repro_torch.fl.experiment import TASKS, task_data_sizes
