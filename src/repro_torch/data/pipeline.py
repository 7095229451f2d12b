"""Training data pipeline: deterministic, shardable, resumable; the twin of
``repro.data.pipeline``, batch for batch.

An index-based design: batch ``i`` is a pure function of (seed, i), so a
restart resumes mid-epoch exactly by step counter, with no iterator state to
checkpoint.  Per-host sharding: each host materialises its rows
[host_id * rows, (host_id + 1) * rows) of every global batch.  Host numpy;
the train step moves a batch to its model's device."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.data.synthetic import synthetic_document
from repro_torch.data.tokenizer import ByteTokenizer


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 256
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1


class SyntheticTextTask:
    """Next-token LM over the synthetic news corpus."""

    def __init__(self, cfg: DataConfig, vocab_size: int):
        self.cfg = cfg
        self.tok = ByteTokenizer()
        if vocab_size < self.tok.vocab_size:
            raise ValueError(f"vocab_size {vocab_size} < the byte tokenizer's "
                             f"{self.tok.vocab_size}")
        self.rows_per_host = cfg.batch_size // cfg.num_hosts

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        tokens = np.zeros((self.rows_per_host, cfg.seq_len + 1), np.int32)
        for r in range(self.rows_per_host):
            global_row = cfg.host_id * self.rows_per_host + r
            doc_seed = int(rng.integers(1 << 31)) + global_row
            sents = synthetic_document(doc_seed, n_sentences=30)
            ids = self.tok.encode(" ".join(sents), eos=True)[: cfg.seq_len + 1]
            tokens[r, : len(ids)] = ids
        return {
            "tokens": tokens[:, :-1],
            "targets": np.where(tokens[:, 1:] > 0, tokens[:, 1:], -1).astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
