"""The front end ``dense_stage``: the configuration's dense causal encoder
(``encoder`` block: the port's dense family at the stated sizes) with the
weights of :func:`h100bench.inputs.encoder_weights` from the seed, served in
the port's ``EncoderStage``, a second pipeline stage in front of the solver
with its own drain thread."""

from __future__ import annotations

import torch

from h100bench import inputs


def build(config: dict, seed: int, device):
    from repro_torch.embeddings import EncoderStage

    enc = config["encoder"]
    cfg, model = encoder_model(enc, seed, device)
    stage = EncoderStage(cfg, model, max_len=enc["max_len"], device=device)
    return stage, stage


def model_config(sizes: dict):
    """The port's ``ModelConfig`` for a dense encoder of ``sizes``."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=sizes["name"], family="dense", n_layers=sizes["num_hidden_layers"],
        d_model=sizes["hidden_size"], n_heads=sizes["num_attention_heads"],
        n_kv_heads=sizes["num_attention_heads"], d_ff=sizes["intermediate_size"],
        vocab_size=sizes["vocab_size"], norm_eps=sizes["layer_norm_eps"],
        rope_theta=sizes["rope_theta"], param_dtype=sizes["dtype"],
        max_seq_len=sizes["max_len"], attn_impl=sizes["attn_impl"], remat=False,
    )


def encoder_model(sizes: dict, seed: int, device):
    """The port's model holding :func:`inputs.encoder_weights` (norm scales
    ones; the unembedding, which pooling never reads, zeros)."""
    from repro_torch.models.model import Model

    cfg = model_config(sizes)
    weights = inputs.encoder_weights(sizes, seed, device, dtype=cfg.dtype)
    with torch.device(device):
        model = Model(cfg)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:  # RMSNorm scales
                p.fill_(1.0)
        model.unembed.zero_()
        model.embed.copy_(weights.pop("embed"))
        for i, blk in enumerate(model.layers):
            pre = f"layers.{i}."
            for name in ("wq", "wk", "wv", "wo"):
                getattr(blk.attn, name).copy_(weights.pop(pre + name))
            for name in ("w_in", "w_gate", "w_out"):
                getattr(blk.mlp, name).copy_(weights.pop(pre + name))
    if weights:
        raise ValueError(f"weights the model has no place for: {sorted(weights)[:4]}")
    return cfg, model
