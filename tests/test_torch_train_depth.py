"""Training through the port's public entry points on the CPU, held against
the JAX package: the two halves of what ``chip_smoke.py``'s phase 4i (2)
runs on the card at full size.

(i) ``examples/train_tiny_lm.py``'s flow at its own reduced config
(sbert-paper, 4 layers, d 128, d_ff 256, microbatch 1, float32): one set
of weights in both packages (``carry_across("params")``), then
``train()`` over ``make_train_step(OptConfig(peak_lr=3e-3,
warmup_steps=20, total_steps=200))`` for TINY_STEPS steps of the same
``SyntheticTextTask`` batches in each package; each package's trained
weights in its own ``BackboneEncoder(max_len=512)`` embed
``synthetic_document(3, 16)``, and ``solve_es(SolveConfig(solver="cobi",
iterations=4, reads=8, int_range=14))`` picks 5 sentences.

Bars: every loss within 1e-3 (float32 training: the two packages' sums
run in different orders, and ten AdamW steps carry those roundings into
the weights); mu and beta within rtol 1e-4; the normalized objectives
against exact enumeration within 0.05 of each other (the reference's
port-to-port bar for full anneals), both above 0.8 (the reference's bar).

The optimizer's stochastic-rounding draws (bf16 state), hashed a run of
whole parts at a time to bound their memory, equal the reference's
stacked draw bit for bit at any run length.

(ii) ``make_train_step`` for whisper-medium, zamba2-2.7b, gemma-2b and
xlstm-1.3b at ``.reduced()`` widths with three groups, bf16, remat on and
the registered microbatch (4, 8, 4, 4), two steps of B 8 x S 32 from the
same weights (the port's init stacked into the reference's tree, the
zero-initialised gates, biases and ``dt_bias`` drawn non-zero) and the
same float32 AdamW state, the reference compiled with XLA's
``xla_allow_excess_precision`` off, as ``test_torch_decode_depth.py``
compiles it.

Bars (bf16 keeps 8 significant bits, a unit roundoff u = 2^-8): each
step's loss within u / 2 of the reference's, relative (the forward rounds
every activation to bf16 in both packages, in different summation orders,
and the mean over some hundred tokens averages those roundings; measured
at most 5e-4); the gradient norm within u, relative (a norm over bf16
gradients whose every element carries such roundings; measured at most
5e-4); every updated weight within
2 lr a step of the reference's plus 2^-7 of the leaf's largest
magnitude: AdamW's first steps move a weight by about lr x sign(g), so
an element whose gradient is near zero and flips sign between the
packages moves 2 lr apart, and the final cast to bf16 rounds the rest to
bf16's grade.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.core import SolveConfig as JSolveConfig
from repro.core import solve_es as jsolve_es
from repro.core.metrics import normalized_objective, reference_bounds
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTextTask as JSyntheticTextTask
from repro.data.synthetic import synthetic_document as jsynthetic_document
from repro.embeddings import BackboneEncoder as JBackboneEncoder
from repro.embeddings import problem_from_sentences as jproblem_from_sentences
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro.train import optimizer as jopt
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import train as jtrain
from repro_torch.configs.base import get_config
from repro_torch.core import SolveConfig, solve_es
from repro_torch.data.pipeline import DataConfig, SyntheticTextTask
from repro_torch.data.synthetic import synthetic_document
from repro_torch.embeddings import BackboneEncoder, problem_from_sentences
from repro_torch import prng
from repro_torch.interop import carry_across
from repro_torch.launch import steps as tsteps
from repro_torch.models import init_params, param_tree
from repro_torch.models.common import leaf_parts, stacked_shape, tree_items
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, train

TINY_STEPS = 10
LOSS_TOL, MU_RTOL, OBJ_TOL = 1e-3, 1e-4, 0.05
FAMILIES = ("whisper-medium", "zamba2-2.7b", "gemma-2b", "xlstm-1.3b")
GROUPS, ROWS, SEQ, STEPS, LR = 3, 8, 32, 2, 1e-2
BF16_LOSS_TOL, BF16_NORM_TOL, BF16_WEIGHT_TOL = 2.0**-9, 2.0**-8, 2.0**-7
ZERO_AT_INIT = ("gate", "ffn_gate", "bq", "bk", "bv", "dt_bias")
XLA_OPTIONS = {"xla_allow_excess_precision": False}


def _tiny(cfg):
    return cfg.reduced().replace(n_layers=4, d_model=128, d_ff=256, group_size=1, microbatch=1)


def _carried(jcfg, tcfg, seed):
    """(reference params, port model) on the same weights: the port's init
    stacked into the reference's tree (an eager draw of the reference's
    init costs seconds on the CPU), the zero-initialised leaves drawn
    non-zero first."""
    rng = np.random.default_rng(seed)

    def tree_of(node, key=None):
        if isinstance(node, dict):
            return {k: tree_of(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return np.stack([tree_of(x, key) for x in node])
        x = node.detach().to(torch.float32).numpy()
        if key in ZERO_AT_INIT:
            x = (0.7 * rng.standard_normal(x.shape) + 0.3).astype(np.float32)
        return x

    tree = tree_of(param_tree(init_params(tcfg, seed, device="cpu")))
    shapes = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.key(seed)))
    jparams = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
    return jparams, carry_across("params", tree, cfg=tcfg, device="cpu")


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Each package's run of the example's flow: (losses, problem, report)."""
    jcfg, tcfg = _tiny(jget_config("sbert-paper")), _tiny(get_config("sbert-paper"))
    jparams, model = _carried(jcfg, tcfg, 0)
    kw = dict(peak_lr=3e-3, warmup_steps=20, total_steps=200)
    root = tmp_path_factory.mktemp("train_depth")
    quiet = dict(log=lambda line: None)
    # Not donated, as the example donates them: at float32 the reference's
    # master weights are the parameters' own buffers.
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.OptConfig(**kw)))
    jparams, _, jhist = jtrain(
        jcfg, jstep, jparams, jopt.init(jparams),
        JSyntheticTextTask(JDataConfig(batch_size=8, seq_len=128), jcfg.vocab_size),
        JLoopConfig(total_steps=TINY_STEPS, ckpt_every=50, ckpt_dir=str(root / "ref")), **quiet)
    model, _, thist = train(
        tcfg, tsteps.make_train_step(tcfg, opt.OptConfig(**kw)), model, opt.init(model),
        SyntheticTextTask(DataConfig(batch_size=8, seq_len=128), tcfg.vocab_size),
        LoopConfig(total_steps=TINY_STEPS, ckpt_every=50, ckpt_dir=str(root / "port")), **quiet)
    sents = synthetic_document(3, 16)
    assert jsynthetic_document(3, 16) == sents
    jp = jproblem_from_sentences(sents, 5, lam=0.5,
                                 encoder=JBackboneEncoder(jcfg, jparams, max_len=512))
    tp = problem_from_sentences(sents, 5, lam=0.5, device="cpu",
                                encoder=BackboneEncoder(tcfg, model, max_len=512, device="cpu"))
    solve = dict(solver="cobi", iterations=4, reads=8, int_range=14)
    key = jax.random.key(1)
    jrep = jsolve_es(jp, key, JSolveConfig(**solve))
    trep = solve_es(tp, carry_across("key", np.asarray(jax.random.key_data(key))),
                    SolveConfig(**solve), device="cpu")
    return {"ref": ([h["loss"] for h in jhist], jp, jrep),
            "port": ([h["loss"] for h in thist], tp, trep)}


def test_tiny_lm_losses_match_reference(tiny_runs):
    """Ten train() steps of the example's reduced encoder: every loss within
    1e-3 of the reference's, and the loss falls."""
    want, got = tiny_runs["ref"][0], tiny_runs["port"][0]
    assert len(got) == len(want) == TINY_STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    assert got[-1] < got[0]


def test_trained_encoder_scores_match_reference(tiny_runs):
    """Each package's trained weights embed the same document: mu and beta
    within rtol 1e-4."""
    jp, tp = tiny_runs["ref"][1], tiny_runs["port"][1]
    np.testing.assert_allclose(tp.mu.numpy(), np.asarray(jp.mu), rtol=MU_RTOL, atol=0)
    np.testing.assert_allclose(tp.beta.numpy(), np.asarray(jp.beta), rtol=MU_RTOL, atol=0)


def test_trained_encoder_summary_matches_reference(tiny_runs):
    """solve_es(cobi) on each package's problem: 5 selected, normalized
    objectives (exact enumeration of C(16, 5)) within 0.05 of each other,
    both above 0.8."""
    _, jp, jrep = tiny_runs["ref"]
    _, tp, trep = tiny_runs["port"]
    bounds = reference_bounds(jp)
    assert bounds.exact
    got = normalized_objective(trep.objective, bounds)
    want = normalized_objective(jrep.objective, bounds)
    assert trep.selection.sum() == 5
    assert abs(got - want) <= OBJ_TOL
    assert got > 0.8 and want > 0.8


def _cut(cfg):
    return cfg.reduced().replace(n_layers=GROUPS * cfg.group_size, param_dtype="bfloat16",
                                 remat=True, microbatch=cfg.microbatch)


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _steps(name):
    """STEPS train steps in each package from the same weights and state:
    per step (loss, grad norm) of each, and both updated trees as (name,
    float32 numpy) pairs."""
    base_j, base_t = jget_config(name), get_config(name)
    jcfg, tcfg = _cut(base_j), _cut(base_t)
    assert tcfg.microbatch == base_t.microbatch > 1 and tcfg.remat
    jparams, model = _carried(jcfg, tcfg, 1)
    jstate, state = jopt.init(jparams), opt.init(model)
    data = np.random.default_rng(2)
    tokens = data.integers(0, tcfg.vocab_size, (ROWS, SEQ + 1)).astype(np.int32)
    targets = tokens[:, 1:].copy()
    targets[-1, -5:] = -1
    batch = {"tokens": tokens[:, :-1], "targets": targets}
    if tcfg.n_frontend_tokens:
        batch["frontend"] = data.standard_normal(
            (ROWS, tcfg.n_frontend_tokens, tcfg.d_model)).astype(np.float32)
    jbatch = {k: jnp.asarray(v, jnp.bfloat16 if k == "frontend" else None)
              for k, v in batch.items()}
    tbatch = {k: (torch.from_numpy(v).to(torch.bfloat16) if k == "frontend"
                  else torch.from_numpy(v)) for k, v in batch.items()}
    kw = dict(warmup_steps=1, total_steps=10, peak_lr=LR)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.OptConfig(**kw))).lower(
        jparams, jstate, jbatch).compile(XLA_OPTIONS)
    step = tsteps.make_train_step(tcfg, opt.OptConfig(**kw))
    metrics = []
    for _ in range(STEPS):
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        model, state, m = step(model, state, tbatch)
        metrics.append(((float(jm["loss"]), float(jm["grad_norm"])),
                        (float(m["loss"]), float(m["grad_norm"]))))
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    want = [("/".join(k.key for k in path), np.asarray(x, np.float32)) for path, x in flat]
    got = [("/".join(path), np.stack([_f32(t) for t in leaf_parts(leaf)]).reshape(
        stacked_shape(leaf))) for path, leaf in tree_items(param_tree(model))]
    return metrics, want, got


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_train_steps_match_reference(name):
    """Two microbatched, rematerialised bf16 steps: each step's loss and
    grad norm, then every updated weight, against the reference's."""
    metrics, want, got = _steps(name)
    for i, ((j_loss, j_norm), (t_loss, t_norm)) in enumerate(metrics):
        assert np.isfinite([t_loss, t_norm]).all()
        assert abs(t_loss - j_loss) <= BF16_LOSS_TOL * abs(j_loss), (i, t_loss, j_loss)
        assert abs(t_norm - j_norm) <= BF16_NORM_TOL * abs(j_norm), (i, t_norm, j_norm)
    assert metrics[-1][0][0] < metrics[0][0][0]  # the reference's loss falls on one batch
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, key
        bar = 2 * LR * STEPS + BF16_WEIGHT_TOL * float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= bar, f"{key}: max abs err {err:.3e} > {bar:.3e}"


@pytest.mark.parametrize("draw_elements", [1, 5000, opt.DRAW_ELEMENTS])
def test_sr_draws_in_runs_equal_the_stacked_draw(draw_elements, monkeypatch):
    """Every leaf of a five-layer model: the bits ``apply_updates`` rounds
    each part with, drawn a run of parts at a time, equal the parts of
    ``prng.bits`` over the leaf's stacked shape (the reference's draw)."""
    model = init_params(get_config("tinyllama-1.1b").reduced().replace(n_layers=5), 0,
                        device="cpu")
    monkeypatch.setattr(opt, "DRAW_ELEMENTS", draw_elements)
    keys = prng.split(prng.key(5), len(tree_items(param_tree(model))))
    for (path, leaf), key in zip(tree_items(param_tree(model)), keys):
        want = prng.bits(key, stacked_shape(leaf), device="cpu").reshape(
            (len(leaf_parts(leaf)),) + tuple(leaf_parts(leaf)[0].shape))
        got = list(opt._leaf_bits(key, leaf))
        assert len(got) == len(leaf_parts(leaf)), path
        for g, w in zip(got, want):
            assert torch.equal(g, w), path
