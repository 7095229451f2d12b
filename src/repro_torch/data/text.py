"""Text handling: sentence segmentation and document loading.

The pipeline consumes plain documents (lists of sentences).  Real text files
work via :func:`load_documents`; the synthetic corpus generator lives in
``repro_torch.data.synthetic``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, List

_SENT_RE = re.compile(r"(?<=[.!?])\s+(?=[A-Z\"'(])")


def split_sentences(text: str) -> List[str]:
    """Lightweight rule-based sentence splitter (period/!/? + capital)."""
    text = " ".join(text.split())
    if not text:
        return []
    parts = _SENT_RE.split(text)
    return [p.strip() for p in parts if p.strip()]


def load_documents(paths: Iterable[str | Path], min_sentences: int = 2) -> List[List[str]]:
    docs = []
    for path in paths:
        sents = split_sentences(Path(path).read_text())
        if len(sents) >= min_sentences:
            docs.append(sents)
    return docs
