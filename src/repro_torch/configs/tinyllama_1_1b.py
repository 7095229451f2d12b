"""tinyllama-1.1b [dense]: 22L d2048 32H (GQA kv=4) d_ff 5632 vocab 32000;
llama2 architecture.  [arXiv:2401.02385]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=5632,
        vocab_size=32000,
        max_seq_len=32768,
        microbatch=2,
    )
)
