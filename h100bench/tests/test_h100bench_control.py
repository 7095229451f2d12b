"""The control has to come out not correct: the plain reference in the
program's place, one precision below the configuration's (fp8 for the bf16
encoder, bf16 for the float32 bag-of-words and the float32 formulation),
judged by the run's own numbers and limits.  On the card at the cells' own sizes on three seeds;
here at sizes a test run holds."""

from __future__ import annotations

import json

import pytest
import torch

from h100bench import control
from h100bench.tests import tiny

CARD_SEEDS = (3_000_000_101, 3_000_000_102, 3_000_000_103, 3_000_000_104, 3_000_000_105,
              3_000_000_106)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", ["es-bow-cobi.news-batch", "es-bow-cobi.long-decomposed"])
def test_bow_control_fails_at_the_cells_size(cell):
    """Bag-of-words runs on the host, so its control runs at the cell's own
    document sizes here (4 documents of the mix)."""
    w = tiny.cell(cell)
    config = json.loads((tiny.BENCH / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((tiny.BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    out = control.readings(config, mix, tiny.limits(w["config"]), tiny.SEED,
                           torch.device("cpu"), n_docs=4)
    assert out["precision"] == "bf16" and not out["passed"], out


def test_encoder_control_fails_at_a_tiny_size():
    """The bf16 encoder at the tiny widths, its control in fp8."""
    out = control.readings(tiny.config("es-sbert-cobi", dtype=None), tiny.mix("news-batch"),
                           tiny.limits("es-sbert-cobi"), tiny.SEED, torch.device("cpu"),
                           n_docs=4)
    assert out["precision"] == "fp8" and not out["passed"], out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CARD_SEEDS)
def test_encoder_control_fails_on_the_card(card, seed):
    """The full-width encoder's control over a run's sample of 16 documents."""
    w = tiny.cell("es-sbert-cobi.news-batch")
    config = json.loads((tiny.BENCH / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((tiny.BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    out = control.readings(config, mix, tiny.limits(w["config"]), seed, card, n_docs=16)
    print(json.dumps(out))
    assert out["precision"] == "fp8" and not out["passed"], out
