"""The plain reference of the ``dense_stage`` front end: the float32 forward
of ``reference/encoder.py`` on the weights the seed makes, or ``quant``'s
lower precision for the control."""

from __future__ import annotations


def embedder(config: dict, seed: int, device, quant: str | None = None):
    import torch

    from h100bench import inputs
    from h100bench.reference import encoder

    enc = config["encoder"]
    weights = inputs.encoder_weights(enc, seed, device, dtype=getattr(torch, enc["dtype"]))

    def embed(sentences):
        with torch.no_grad():
            e = encoder.embed_document(enc, weights, sentences, quant)
        return e.cpu().to(torch.float64).numpy()

    return embed


def precision(config: dict) -> str:
    return config["encoder"]["dtype"]
