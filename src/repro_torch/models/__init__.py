from repro_torch.models.model import (  # noqa: F401
    Model,
    decode_step,
    embed_sentences,
    encode,
    forward,
    init_cache,
    init_params,
    param_tree,
    prefill,
    train_loss,
)
