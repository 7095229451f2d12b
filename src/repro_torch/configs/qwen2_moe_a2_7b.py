"""qwen2-moe-a2.7b [moe]: 24L d2048 16H (kv=16) MoE 60 routed experts top-4
(d_ff_expert 1408) + shared expert (4x1408=5632), vocab 151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,  # per-expert width (spec); dense layers: none
        vocab_size=151936,
        qkv_bias=True,
        moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408, d_ff_shared=5632),
        max_seq_len=32768,
        microbatch=4,
    )
)
