"""The paper's own sentence encoder analogue: a small from-scratch LM whose
mean-pooled hidden states provide mu/beta for the Ising pipeline (Sentence-
BERT is not downloadable offline; DESIGN.md deviation 3).  ~100M params --
the scale trained end-to-end by examples/train_tiny_lm.py."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="sbert-paper",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=32000,
        max_seq_len=2048,
    )
)
