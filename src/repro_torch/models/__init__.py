from repro_torch.models.model import (  # noqa: F401
    Model,
    embed_sentences,
    forward,
    init_params,
)
