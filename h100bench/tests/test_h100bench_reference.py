"""The plain reference against the port at a small size on the CPU, and the
modules the harness and the reference load."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from h100bench import inputs
from h100bench.generator import plugin
from h100bench.reference import bow, encoder, formulation, scores
from h100bench.tests import tiny

DOC = inputs.synthetic_document(12345, 5)


@pytest.mark.parametrize("sentences", [DOC, inputs.synthetic_document(777, 12)],
                         ids=["fits", "cut"])
def test_reference_encoder_matches_the_port(sentences):
    """The port's EncoderStage (flash route, its plain version here) and the
    reference's float32 forward, on the same seeded weights; the second
    document runs past the 512-token context, so its last sentences get no
    tokens on both sides."""
    from repro_torch.embeddings import EncoderStage

    sizes = tiny.config("es-sbert-cobi")["encoder"]
    sizes = dict(sizes, max_len=512)
    cfg, model = plugin("front_ends", "dense_stage").encoder_model(
        sizes, tiny.SEED, torch.device("cpu"))
    with EncoderStage(cfg, model, max_len=sizes["max_len"], device="cpu") as stage:
        port = stage.encode(sentences).numpy()
    weights = inputs.encoder_weights(sizes, tiny.SEED, torch.device("cpu"), torch.float32)
    ref = encoder.embed_document(sizes, weights, sentences).numpy()
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=2e-5)
    _, segs = encoder.pack_sentences(sentences, sizes["max_len"])
    cut = len(sentences) - len(set(segs[segs >= 0].tolist()))
    assert (np.abs(ref).sum(axis=1) == 0).sum() == cut
    assert (cut > 0) == (len(sentences) == 12)


def test_reference_bow_matches_the_port():
    from repro_torch.embeddings import HashedBowEncoder

    port = HashedBowEncoder(dim=256, seed=0).encode(DOC + ["", "!!"]).numpy()
    ref = bow.embed_document(DOC + ["", "!!"], 256, 0)
    np.testing.assert_allclose(port, ref, atol=1e-6)


def test_reference_scores_and_bounds_match_the_port():
    from repro_torch.core.formulation import EsProblem, es_objective
    from repro_torch.core.metrics import reference_bounds
    from repro_torch.data.synthetic import scores_from_embeddings

    e = np.random.default_rng(5).standard_normal((14, 32))
    e[3] = 0.0
    mu_p, beta_p = scores_from_embeddings(torch.from_numpy(e).float())
    mu, beta = scores.scores(e)
    np.testing.assert_allclose(mu_p.numpy(), mu, atol=1e-6)
    np.testing.assert_allclose(beta_p.numpy(), beta, atol=1e-6)
    prob = EsProblem(mu=mu_p, beta=beta_p, m=4, lam=0.5)
    x = np.zeros(14)
    x[[0, 3, 7, 9]] = 1
    port_obj = float(es_objective(prob, torch.from_numpy(x).float()))
    assert scores.objective(mu, beta, 0.5, x) == pytest.approx(port_obj, abs=1e-5)
    hi, lo, exact = scores.bounds(mu, beta, 0.5, 4)
    b = reference_bounds(prob)
    assert exact and hi == pytest.approx(b.obj_max, abs=1e-5)
    assert lo == pytest.approx(b.obj_min, abs=1e-5)


@pytest.mark.parametrize("n,m", [(30, 5), (20, 10), (7, 7)])
def test_reference_formulation_and_rounding_match_the_port(n, m):
    """The port's improved formulation against the reference's float64 one,
    and the port's stochastic rounding as the reference's properties hold
    it; a rounding at half the range breaks them."""
    from repro_torch import prng
    from repro_torch.core.formulation import EsProblem, improved_ising
    from repro_torch.core.rounding import quantize_ising_many

    mu, beta = scores.scores(np.random.default_rng(n).standard_normal((n, 24)))
    prob = EsProblem(mu=torch.tensor(mu, dtype=torch.float32),
                     beta=torch.tensor(beta, dtype=torch.float32), m=m, lam=0.5)
    ising = improved_ising(prob)
    h_ref, j_ref = formulation.improved_ising(prob.mu.double().numpy(),
                                              prob.beta.double().numpy(), m, 0.5)
    assert formulation.formulation_gap(ising.h.numpy(), ising.j.numpy(), h_ref, j_ref) < 1e-4
    keys = [prng.key(i) for i in range(3)]
    for q in quantize_ising_many(ising, keys, "stochastic", int_range=14):
        assert formulation.rounding_ok(ising.h, ising.j, q.ising.h, q.ising.j, 14)
    for q in quantize_ising_many(ising, keys, "stochastic", int_range=7):
        assert not formulation.rounding_ok(ising.h, ising.j, q.ising.h, q.ising.j, 14)
    h_c, j_c = formulation.improved_ising(mu, beta, m, 0.5, quant="bf16")
    assert formulation.formulation_gap(h_c, j_c, h_ref, j_ref) > 1e-3


def test_the_search_finds_the_enumerated_extremes():
    e = np.random.default_rng(6).standard_normal((24, 16))
    mu, beta = scores.scores(e)
    vals = scores._enumerate(mu, beta, 0.5, 5)
    hi, _ = scores._search(mu, beta, 0.5, 5, 1.0)
    lo, _ = scores._search(mu, beta, 0.5, 5, -1.0)
    assert hi == pytest.approx(vals.max()) and lo == pytest.approx(vals.min())


PROBE = """
import json, sys, time
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import torch
import h100bench.control, h100bench.reference.check, h100bench.reference.encoder
import h100bench.reference.bow, h100bench.reference.formulation
from h100bench import reference
from h100bench.tests import tiny
for name in ("es-sbert-cobi", "es-bow-cobi"):
    reference.embedder(tiny.config(name), 1, torch.device("cpu"))(["One two.", "Three."])
after_reference = sorted({m.split(".")[0] for m in sys.modules})
out = tiny.run("es-bow-cobi.news-batch", seconds=0.6)
after_run = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"reference": after_reference, "run": after_run, "correct": out["correct"]}))
"""


def test_neither_the_reference_nor_a_run_loads_jax_or_the_jax_package():
    """Top-level module names compared whole: ``repro_torch`` is the port,
    ``repro`` the JAX package.  The reference loads nothing of the port."""
    root = str(tiny.BENCH.parent)
    out = subprocess.run([sys.executable, "-c", PROBE, root], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    forbidden = {"jax", "jaxlib", "flax", "repro"}
    assert not forbidden & set(seen["reference"])
    assert "repro_torch" not in seen["reference"]
    assert not forbidden & set(seen["run"]) and "repro_torch" in seen["run"]
    assert seen["correct"]
