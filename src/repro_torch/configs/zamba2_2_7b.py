"""zamba2-2.7b [hybrid]: 54 Mamba2 blocks (d_state 64) + ONE shared attention
block (32H kv=32, d_ff 10240 MLP) re-applied after every 6 Mamba layers,
d_model 2560 vocab 32000.  [arXiv:2411.15242].  Sub-quadratic: long_500k runs."""

from repro_torch.configs.base import ModelConfig, SsmConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,  # mamba2 layers; + shared attn block every group
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,  # MLP width of the shared attention block
        vocab_size=32000,
        group_size=6,
        shared_attn_every=6,
        ssm=SsmConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=32),
        max_seq_len=1 << 20,
        microbatch=8,
    )
)
