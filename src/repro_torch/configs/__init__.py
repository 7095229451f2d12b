"""Architecture registry: importing this package registers every config."""

from repro_torch.configs import (  # noqa: F401
    gemma_2b,
    llama_3_2_vision_11b,
    minitron_8b,
    mixtral_8x22b,
    qwen2_5_32b,
    qwen2_moe_a2_7b,
    sbert_paper,
    tinyllama_1_1b,
    whisper_medium,
    xlstm_1_3b,
    zamba2_2_7b,
)
from repro_torch.configs.base import (  # noqa: F401
    REGISTRY,
    SHAPES,
    ModelConfig,
    ShapeCell,
    get_config,
    shape_applicable,
)

ASSIGNED_ARCHS = (
    "llama-3.2-vision-11b",
    "qwen2-moe-a2.7b",
    "mixtral-8x22b",
    "whisper-medium",
    "zamba2-2.7b",
    "qwen2.5-32b",
    "minitron-8b",
    "gemma-2b",
    "tinyllama-1.1b",
    "xlstm-1.3b",
)
