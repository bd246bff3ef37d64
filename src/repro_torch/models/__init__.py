from repro_torch.models.cnn import (
    CIFAR10_CNN, FEMNIST_CNN, TINY_CNN, CNNConfig, eval_metrics, forward,
    init_params, loss_fn, params_from_numpy,
)
