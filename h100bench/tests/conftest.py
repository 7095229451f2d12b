def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips (naming what is "
        "missing) where torch.cuda.is_available() is False")
