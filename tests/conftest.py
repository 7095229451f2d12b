import os

# Tests must see exactly ONE device (the dry-run sets its own 512-device flag
# in a subprocess); keep any inherited XLA_FLAGS from leaking in.
os.environ.pop("XLA_FLAGS", None)

try:
    from hypothesis import settings
except ModuleNotFoundError:  # property tests importorskip hypothesis themselves
    pass
else:
    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips (naming what is "
        "missing) where torch.cuda.is_available() is False")
