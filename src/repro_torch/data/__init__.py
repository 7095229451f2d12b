from repro_torch.data import synthetic, text  # noqa: F401
