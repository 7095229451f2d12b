"""Byte-level tokenizer (no external vocab files; deterministic).  A copy of
``repro.data.tokenizer``: numpy only."""

from __future__ import annotations

from typing import List

import numpy as np

PAD, BOS, EOS, SEP = 0, 1, 2, 3
N_SPECIAL = 4


class ByteTokenizer:
    """Bytes + 4 specials.  vocab_size = 260; ids >= 260 are never produced,
    so any model vocab >= 260 works."""

    vocab_size = 256 + N_SPECIAL

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> List[int]:
        ids = [b + N_SPECIAL for b in text.encode("utf-8")]
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        bs = bytes(i - N_SPECIAL for i in ids if i >= N_SPECIAL)
        return bs.decode("utf-8", errors="replace")

    def encode_sentences(self, sentences: List[str], max_len: int):
        """Pack sentences with SEP; returns (tokens, seg_ids) padded arrays.

        seg_ids[i] = sentence index of token i, -1 on padding/specials --
        the layout `embed_sentences` mean-pools over.
        """
        toks, segs = [BOS], [-1]
        for si, s in enumerate(sentences):
            ids = self.encode(s, bos=False)
            toks.extend(ids + [SEP])
            segs.extend([si] * len(ids) + [-1])
        toks, segs = toks[:max_len], segs[:max_len]
        pad = max_len - len(toks)
        tokens = np.asarray(toks + [PAD] * pad, np.int32)
        seg_ids = np.asarray(segs + [-1] * pad, np.int32)
        return tokens, seg_ids
