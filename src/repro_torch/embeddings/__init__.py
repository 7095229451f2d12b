from repro_torch.embeddings.encoder import (  # noqa: F401
    BackboneEncoder,
    HashedBowEncoder,
    problem_from_sentences,
)
from repro_torch.embeddings.serving import (  # noqa: F401
    EncodeFuture,
    EncodeReceipt,
    EncoderStage,
    EncoderStats,
)
