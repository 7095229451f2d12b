"""mixtral-8x22b [moe]: 56L d6144 48H (GQA kv=8) 8 experts top-2 d_ff 16384,
vocab 32768, sliding-window attention (4096) -> sub-quadratic, so the
long_500k decode cell RUNS for this arch.  [arXiv:2401.04088]."""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        rope_theta=1000000.0,
        sliding_window=4096,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
        max_seq_len=65536,
        microbatch=16,
    )
)
