from repro_torch.fl.client import FLClient, sgd_step
from repro_torch.fl.experiment import TASKS, build_experiment, run_policy, task_data_sizes
from repro_torch.fl.trainer import ExperimentResult, FLExperiment, Policy
