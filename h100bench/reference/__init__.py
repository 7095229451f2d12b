"""The plain reference of the benchmark's configurations: plain PyTorch and
NumPy that import neither JAX, nor the JAX package, nor anything of the
port.  It takes from the program nothing but what it judges; the encoder's
weights it makes again from the seed (``h100bench/inputs.py``).  Each front
end has its reference in ``reference/front_ends/<front_end>.py``."""

from __future__ import annotations

from pathlib import Path

# The control's precision: the nearest below the one the configuration states.
CONTROL_PRECISION = {"bfloat16": "fp8", "float32": "bf16"}
HERE = Path(__file__).resolve().parent


def front_end(config: dict):
    from h100bench.generator import plugin

    return plugin("front_ends", config["front_end"], HERE)


def embedder(config: dict, seed: int, device, quant: str | None = None):
    """sentences -> (N, d) float64 embeddings of the configuration's front
    end, computed in float32 (float64 for bag-of-words), or in ``quant``."""
    return front_end(config).embedder(config, seed, device, quant)


def control_precision(config: dict) -> str:
    return CONTROL_PRECISION[front_end(config).precision(config)]
