"""xlstm-1.3b [ssm]: 48L d2048 4H, no FFN (d_ff=0), vocab 50304.
Blocks: 7 mLSTM (matrix memory, chunk-parallel) + 1 sLSTM (scalar memory,
sequential scan) per 8-layer group, xLSTM[7:1].  [arXiv:2405.04517].
Sub-quadratic: long_500k runs."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        group_size=8,
        slstm_index=7,
        max_seq_len=1 << 20,
        microbatch=4,
    )
)
