from repro_torch.obs.profile import scope
