"""whisper-medium [audio]: enc-dec, 24L encoder + 24L decoder, d1024 16H
(kv=16) d_ff 4096 vocab 51865 (padded to 51968 for TP), conv audio frontend
STUBBED per spec -- input_specs provides 1500 precomputed frame embeddings.
[arXiv:2212.04356].  Deviation: RoPE decoder positions instead of learned
absolute (noted in DESIGN.md)."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-medium",
        family="encdec",
        n_layers=24,
        encoder_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        act="gelu",
        gated_mlp=False,
        qkv_bias=True,
        n_frontend_tokens=1500,  # stub conv frontend output frames
        max_seq_len=32768,
        microbatch=4,
    )
)
