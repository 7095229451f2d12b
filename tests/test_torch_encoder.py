"""The port's encoder serving stage and backbone encoder on the CPU,
mirroring tests/test_encoder_stage.py, and held against the JAX package's
stage on weights carried across from the reference.

Bars: a job's embeddings are a pure function of its own texts (bit for bit
against a solo encode); receipts, stats, the empty job, the closed stage
and the query cache behave as the reference's; the stage's embeddings are
within 2e-4 of the JAX stage's (float32, the reference's flash-vs-sdpa
bound); the slice end to end (sentences -> BackboneEncoder ->
problem_from_sentences -> solve_es) reaches normalized objective > 0.8 and
comes within 0.05 of the JAX package's on the same keys.
"""

import copy
import threading
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.core import SolveConfig as JSolveConfig
from repro.core import solve_es as jsolve_es
from repro.core.metrics import normalized_objective, reference_bounds
from repro.embeddings import BackboneEncoder as JBackboneEncoder
from repro.embeddings import EncoderStage as JEncoderStage
from repro.embeddings import problem_from_sentences as jproblem_from_sentences
from repro.models import init_params as jinit_params
from repro_torch.configs.base import get_config
from repro_torch.core import SolveConfig, solve_es
from repro_torch.data.synthetic import scores_from_embeddings, synthetic_document
from repro_torch.embeddings import BackboneEncoder, EncoderStage, problem_from_sentences
from repro_torch.interop import carry_across

EMBED_TOL = 2e-4
# The full-width sbert-paper stage's flash-path embeddings on an H100
# (`python3 chip_smoke.py --save-embeddings PATH`: bf16, 12 layers, random
# weights from the port's init_params(seed 0)), float32, unit rows.
CARD_EMBEDDINGS = Path(__file__).parent / "data" / "encoder_card_embeddings.npz"


def _tiny(**kw):
    return EncoderStage.tiny(device="cpu", **kw)


def _carried(seed=1, **replace):
    """(reference cfg, params), (port cfg, model) on the same weights."""
    jcfg = jget_config("sbert-paper").reduced().replace(**replace)
    tcfg = get_config("sbert-paper").reduced().replace(**replace)
    jparams = jinit_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return (jcfg, jparams), (tcfg, carry_across("params", tree, cfg=tcfg, device="cpu"))


def test_batch_composition_invariance():
    """Same sentences -> bit-identical embeddings (and mu/beta) whatever
    shares the drain."""
    target = synthetic_document(1, 3)
    with _tiny(linger=0.1) as batched_stage:
        futs = [batched_stage.submit(target), batched_stage.submit(synthetic_document(2, 3)),
                batched_stage.submit(synthetic_document(3, 2))]
        batched = futs[0].result(timeout=120)
        receipt = futs[0].receipt()
        [f.result(timeout=120) for f in futs]
    assert receipt.batch_jobs >= 2
    with _tiny() as solo_stage:
        solo = solo_stage.submit(target).result(timeout=120)
    assert torch.equal(batched, solo)
    for a, b in zip(scores_from_embeddings(batched), scores_from_embeddings(solo)):
        assert torch.equal(a, b)


def test_receipts_and_stats_meter_the_stage():
    stage = _tiny()
    fut = stage.submit(synthetic_document(4, 4), tag=77)
    emb = fut.result(timeout=120)
    r = fut.receipt()
    assert emb.shape == (4, stage.cfg.d_model)
    assert r.tag == 77 and r.encoder_seconds > 0.0
    assert r.bytes_h2d > 0 and r.bytes_d2h == 4 * stage.cfg.d_model * 4
    assert r.padded_len in (64, 128) and r.batch_jobs == 1
    s = stage.stats()
    assert s.jobs == 1 and s.launches == 1 and s.busy_seconds > 0.0
    assert stage.estimate_seconds(100) > 0.0
    assert len(stage.busy_intervals()) == 1
    assert stage.encode(["one sentence."]).shape[0] == 1
    e0 = stage.submit([]).result(timeout=10)
    assert e0.shape == (0, stage.cfg.d_model)
    assert stage.prewarm(lengths=[64]) == 1 and stage.stats().prewarmed == 1
    stage.close()
    with pytest.raises(RuntimeError, match="closed"):
        stage.submit(["x."])


def test_prewarm_runs_on_the_drive_thread(monkeypatch):
    """prewarm's passes run on the thread that runs the drains, so state a
    library keeps per thread (cuBLAS handles and workspaces on the card) is
    warm for the first drain; a closed stage refuses to prewarm."""
    from repro_torch.embeddings import serving

    threads = []
    real = serving._embed_batch

    def spy(*args, **kwargs):
        threads.append(threading.current_thread().name)
        return real(*args, **kwargs)

    monkeypatch.setattr(serving, "_embed_batch", spy)
    stage = _tiny()
    assert stage.prewarm(lengths=[64, 128]) == 2
    stage.submit(synthetic_document(4, 2)).result(timeout=120)
    assert threads == ["encoder-stage-drive"] * 3
    assert stage.stats().prewarmed == 2 and stage.stats().launches == 1
    stage.close()
    with pytest.raises(RuntimeError, match="closed"):
        stage.prewarm(lengths=[64])


def test_query_cache_hit_is_bit_identical_and_invalidated_on_params_swap():
    stage = _tiny()
    q = "which sentence answers the question?"
    e1 = stage.submit_query(q).result(timeout=120)
    f2 = stage.submit_query(q, tag=9)
    assert torch.equal(e1, f2.result(timeout=120))
    r2 = f2.receipt()
    assert r2.encoder_seconds == 0.0 and r2.batch_jobs == 0 and r2.tag == 9
    assert stage.cache_stats() == {
        "hits": 1, "misses": 1, "size": 1, "capacity": 256, "hit_rate": 0.5,
    }
    fa = stage.submit_query("a brand new query")
    fb = stage.submit_query("a brand new query")
    assert torch.equal(fa.result(timeout=120), fb.result(timeout=120))
    st = stage.cache_stats()
    assert st["hits"] == 2 and st["misses"] == 2 and st["size"] == 2
    stage.params = copy.deepcopy(stage.params)  # same values, a new object
    e3 = stage.submit_query(q).result(timeout=120)
    st = stage.cache_stats()
    assert st["misses"] == 3 and st["hits"] == 2 and st["size"] == 1
    assert torch.equal(e1, e3)
    stage.close()


@pytest.mark.parametrize("impl", ["flash", "sdpa"])
def test_stage_matches_jax_stage(impl):
    """The same texts through both stages on the same weights; the port's
    flash route (its plain version here) against the JAX stage's Pallas
    kernel in interpret mode, and the naive route against the naive."""
    (jcfg, jparams), (tcfg, model) = _carried()
    docs = [synthetic_document(20 + i, n) for i, n in enumerate((3, 5, 8))]
    with JEncoderStage(jcfg, jparams, max_len=128, attn_impl=impl) as jstage:
        want = [jstage.submit(d).result(timeout=300) for d in docs]
    with EncoderStage(tcfg, model, max_len=128, attn_impl=impl, device="cpu") as stage:
        futs = [stage.submit(d) for d in docs]
        got = [f.result(timeout=300) for f in futs]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=EMBED_TOL, atol=EMBED_TOL)


def test_backbone_encoder_slice_end_to_end():
    """Sentences -> BackboneEncoder -> mu/beta -> solve_es on the CPU,
    against the JAX package's same path on the same weights and keys."""
    (jcfg, jparams), (tcfg, model) = _carried(seed=2, attn_impl="flash")
    sents = synthetic_document(7, 12)
    cfg = dict(solver="cobi", iterations=4, reads=8, int_range=14, steps=300)
    jp = jproblem_from_sentences(sents, 4, encoder=JBackboneEncoder(jcfg, jparams, 1024))
    tp = problem_from_sentences(sents, 4, encoder=BackboneEncoder(tcfg, model, device="cpu"),
                                device="cpu")
    np.testing.assert_allclose(tp.mu.numpy(), np.asarray(jp.mu), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tp.beta.numpy(), np.asarray(jp.beta), rtol=1e-3, atol=1e-3)
    key = jax.random.key(0)
    ref = jsolve_es(jp, key, JSolveConfig(**cfg))
    rep = solve_es(tp, carry_across("key", np.asarray(jax.random.key_data(key))),
                   SolveConfig(**cfg), device="cpu")
    assert rep.selection.sum() == 4
    b = reference_bounds(jp)
    got, want = normalized_objective(rep.objective, b), normalized_objective(ref.objective, b)
    assert got > 0.8
    assert abs(got - want) <= 0.05


@pytest.mark.parametrize("name,seed,n,m", [("direct", 7, 20, 6), ("farm1", 101, 14, 5)])
def test_card_embeddings_solve_as_in_the_jax_package(name, seed, n, m):
    """The card's embeddings of two documents through each package's own
    mu/beta and solve_es(SolveConfig()) on key 0, as chip_smoke.py solves
    them: the port within 0.05 of the JAX package, and above the
    reference's 0.8 bar wherever the JAX package is (farm1 falls short of
    it under these random weights in both)."""
    e = np.load(CARD_EMBEDDINGS)[name]
    sents = synthetic_document(seed, n)
    assert e.shape == (n, 768)
    jp = jproblem_from_sentences(
        sents, m, encoder=types.SimpleNamespace(encode=lambda _s: jnp.asarray(e)))
    tp = problem_from_sentences(
        sents, m, encoder=types.SimpleNamespace(encode=lambda _s: torch.from_numpy(e)),
        device="cpu")
    key = jax.random.key(0)
    ref = jsolve_es(jp, key, JSolveConfig())
    rep = solve_es(tp, carry_across("key", np.asarray(jax.random.key_data(key))),
                   SolveConfig(), device="cpu")
    b = reference_bounds(jp)
    got, want = normalized_objective(rep.objective, b), normalized_objective(ref.objective, b)
    assert rep.selection.sum() == m
    assert abs(got - want) <= 0.05
    assert got > 0.8 or want <= 0.8
