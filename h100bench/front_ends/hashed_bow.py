"""The front end ``hashed_bow``: the engine's hashed bag-of-words encoder on
the host (``bow`` block: width and word seed), run inline on the engine's
driver thread."""

from __future__ import annotations


def build(config: dict, seed: int, device):
    from repro_torch.embeddings import HashedBowEncoder

    bow = config["bow"]
    return HashedBowEncoder(dim=bow["dim"], seed=bow["seed"]), None
