"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) d_ff 14336 vocab 128256.
Cross-attention image layers every 5th layer (gated, stub patch embeddings);
[hf:meta-llama/Llama-3.2-11B-Vision].  Our grouped scan places the gated
cross-attention layer at the end of each 5-layer super-block (positions
4,9,...,39 vs HF's 3,8,...,38 -- same count/period, shifted by one)."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500000.0,
        group_size=5,
        cross_attn_index=4,
        n_frontend_tokens=1600,  # stub vision patch embeddings (B, 1600, d)
        max_seq_len=131072,
        microbatch=8,
    )
)
