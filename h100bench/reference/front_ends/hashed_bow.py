"""The plain reference of the ``hashed_bow`` front end: ``reference/bow.py``
in float64, or ``quant``'s lower precision for the control."""

from __future__ import annotations


def embedder(config: dict, seed: int, device, quant: str | None = None):
    from h100bench.reference import bow

    dim, bow_seed = config["bow"]["dim"], config["bow"]["seed"]
    return lambda sentences: bow.embed_document(sentences, dim, bow_seed, quant)


def precision(config: dict) -> str:
    return config["bow"]["dtype"]
