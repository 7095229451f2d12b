from repro_torch.models.model import (  # noqa: F401
    Model,
    embed_sentences,
    encode,
    forward,
    init_params,
)
