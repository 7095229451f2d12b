from repro_torch.train import optimizer  # noqa: F401
