"""gemma-2b [dense]: 18L d2048 8H MQA (kv=1) head_dim 256, GeGLU d_ff 16384,
vocab 256000, tied embeddings.  [arXiv:2403.08295]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        act="gelu",  # GeGLU = gelu-gated MLP
        gated_mlp=True,
        tie_embeddings=True,
        max_seq_len=8192,
        microbatch=4,
    )
)
