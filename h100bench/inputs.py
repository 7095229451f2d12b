"""The benchmark's inputs, made from ``--seed``: the encoder's weights and
the documents.  Both sides get the same: the program's model is filled from
:func:`encoder_weights`, and the plain reference calls it again with the
same seed.  Nothing here imports the program."""

from __future__ import annotations

import numpy as np
import torch

_TRUNC = 2.0  # truncated normal at +-2 sigma, the port's dense_init


def padded_vocab(vocab: int) -> int:
    """Rows of the embedding table: the vocabulary padded to 256."""
    return ((vocab + 255) // 256) * 256


def weight_layout(sizes: dict) -> list[tuple[str, tuple, float]]:
    """(name, shape, std) of every drawn leaf, in draw order.  Matrices act
    as ``x @ w`` ((in, out)); std is fan-in^-1/2, the embedding's 1."""
    d, f = sizes["hidden_size"], sizes["intermediate_size"]
    layout = [("embed", (padded_vocab(sizes["vocab_size"]), d), 1.0)]
    for i in range(sizes["num_hidden_layers"]):
        p = f"layers.{i}."
        layout += [(p + "wq", (d, d), d ** -0.5), (p + "wk", (d, d), d ** -0.5),
                   (p + "wv", (d, d), d ** -0.5), (p + "wo", (d, d), d ** -0.5),
                   (p + "w_in", (d, f), d ** -0.5), (p + "w_gate", (d, f), d ** -0.5),
                   (p + "w_out", (f, d), f ** -0.5)]
    return layout


def encoder_weights(sizes: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Every matrix of the encoder from one normal draw of a generator on
    ``device`` seeded with ``seed``, cut into leaves, truncated at +-2 sigma,
    scaled and cast to ``dtype`` (the type the weights are served in).  The
    norm scales are ones and are not drawn."""
    layout = weight_layout(sizes)
    total = sum(int(np.prod(shape)) for _, shape, _ in layout)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    flat.clamp_(-_TRUNC, _TRUNC)
    out, off = {}, 0
    for name, shape, std in layout:
        size = int(np.prod(shape))
        out[name] = (flat[off:off + size].view(shape) * std).to(dtype)
        off += size
    return out


TOPICS = [
    "the city council budget vote",
    "the championship final result",
    "the new vaccine trial data",
    "the coastal storm damage",
    "the quarterly earnings report",
    "the wildfire evacuation order",
    "the transit strike negotiations",
    "the satellite launch schedule",
]
TEMPLATES = [
    "Officials said {t} would be reviewed on {d}.",
    "Residents reacted to {t} with a mixture of relief and concern.",
    "Analysts noted that {t} had shifted expectations for {d}.",
    "A spokesperson declined to comment on {t}.",
    "Early reports about {t} were revised later on {d}.",
    "Witnesses described {t} in detail to reporters.",
    "The committee linked {t} to broader regional trends.",
    "Experts cautioned that {t} remained uncertain pending {d}.",
]
DATES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday"]
# The shortest and longest sentence of any document, in UTF-8 bytes.
_LENGTHS = [len(tpl.format(t=t, d=d).encode()) for tpl in TEMPLATES for t in TOPICS
            for d in DATES]
SENTENCE_BYTES = (min(_LENGTHS), max(_LENGTHS))


def synthetic_document(doc_id: int, n_sentences: int) -> list[str]:
    """A news-style article of ``n_sentences`` template sentences about a few
    topics: a frozen copy of ``repro_torch.data.synthetic.synthetic_document``
    (the same text for the same id)."""
    rng = np.random.default_rng(doc_id)
    doc_topics = rng.choice(
        len(TOPICS), size=min(len(TOPICS), max(2, n_sentences // 6)), replace=False
    )
    sents = []
    for _ in range(n_sentences):
        t = TOPICS[int(rng.choice(doc_topics))]
        tpl = TEMPLATES[int(rng.integers(len(TEMPLATES)))]
        d = DATES[int(rng.integers(len(DATES)))]
        sents.append(tpl.format(t=t, d=d))
    return sents


def document_ids(seed: int, count: int) -> np.ndarray:
    """``count`` distinct document ids drawn from the seed (a random base,
    then consecutive ids)."""
    base = int(np.random.default_rng([int(seed) % (2 ** 63), 1]).integers(0, 2 ** 40))
    return base + np.arange(count, dtype=np.int64)


def sizes_sequence(seed: int, lo: int, hi: int, count: int) -> np.ndarray:
    """``count`` sentence counts, uniform over [lo, hi]: blocks that each hold
    every count once, each block shuffled by the seed.  Every seed gets the
    same multiset of sizes (up to the last, partial block), in its own order."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 2])
    span = np.arange(lo, hi + 1)
    blocks = [rng.permutation(span) for _ in range(-(-count // len(span)))]
    return np.concatenate(blocks)[:count]
