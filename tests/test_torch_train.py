"""The port's training scaffold on the CPU, held against the JAX package:
``train.optimizer`` (twins of tests/test_optimizer.py, and the reference's
own functions on the same inputs), ``train.checkpoint`` and ``train.loop``
(twins of tests/test_checkpoint.py, and checkpoints crossing between the
packages both ways), ``data.pipeline`` (twins of the two pipeline tests of
tests/test_data_serving.py, and its batches against the reference's),
``launch.steps.make_ising_solve_step`` against the reference's, the
inference steps left without autograd after a train step, and the
``launch.train`` CLI.

Bars: ``sr_to_bf16``, ``compress_int8``, the batches, the manifest's names
and config hash, and restored leaves bit for bit; ``apply_updates``
against the reference's within 1e-6 relative (of each element and of its
leaf's largest magnitude: the two libraries' float32 ``pow``, ``cos`` and
norm sums differ by an ulp, which an update near cancellation magnifies),
in float32 and in bf16 stochastic-rounding state (its rounding bits
equal); the Ising step's
spins and energies equal wherever no phase lies within 2e-4 of the readout
boundary (the trajectories' bound at 50 steps, tests/test_kernels_ising.py)
and each returned energy the exact energy of the returned spins.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTextTask as JSyntheticTextTask
from repro.kernels import ref as jkref
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch import prng
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTextTask
from repro_torch.data.synthetic import synthetic_document
from repro_torch.embeddings import EncoderStage
from repro_torch.interop import carry_across
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import init_cache, init_params, param_tree
from repro_torch.models.common import leaf_parts, stacked_shape, tree_items
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, PreemptionError, train

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-6
PHASE_TOL = 2e-4


def _key(seed):
    return prng.key(seed), jax.random.key(seed)


def _np(tree):
    """A port tree as the reference's: {name: stacked numpy}, float32 for
    bf16 leaves."""
    return {"/".join(path): np.stack([t.detach().to(torch.float32).numpy()
                                      for t in leaf_parts(leaf)]).reshape(stacked_shape(leaf))
            for path, leaf in tree_items(tree)}


def _jnp(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(jnp.asarray(x, jnp.float32))
            for path, x in flat}


# ---------------------------------------------------------------------------
# optimizer: twins of tests/test_optimizer.py
# ---------------------------------------------------------------------------


def _np_adamw(w, g, m, v, step, cfg, lr):
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mhat = m / (1 - cfg.b1**step)
    vhat = v / (1 - cfg.b2**step)
    w = w - lr * (mhat / (np.sqrt(vhat) + cfg.eps) + cfg.weight_decay * w)
    return w, m, v


def test_adamw_matches_numpy_reference():
    cfg = opt.OptConfig(peak_lr=1e-2, warmup_steps=0, total_steps=100,
                        clip_norm=1e9, weight_decay=0.01)
    params = {"w": torch.tensor(np.random.default_rng(0).normal(size=(4, 3)), dtype=torch.float32)}
    state = opt.init(params)
    w_np = params["w"].numpy().astype(np.float64)
    m_np = np.zeros_like(w_np)
    v_np = np.zeros_like(w_np)
    for step in range(1, 6):
        g = np.random.default_rng(step).normal(size=(4, 3))
        grads = {"w": torch.tensor(g, dtype=torch.float32)}
        params, state, metrics = opt.apply_updates(params, grads, state, cfg)
        lr = float(opt.schedule(cfg, torch.tensor(step)))
        w_np, m_np, v_np = _np_adamw(w_np, g, m_np, v_np, step, cfg, lr)
        np.testing.assert_allclose(params["w"].numpy(), w_np, rtol=1e-5, atol=1e-6)


def test_clipping_bounds_update():
    cfg = opt.OptConfig(clip_norm=1.0, warmup_steps=0, peak_lr=1.0)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    grads = {"w": torch.full((4,), 1e6)}
    _, _, metrics = opt.apply_updates(params, grads, state, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_schedule_shape():
    cfg = opt.OptConfig(peak_lr=1.0, min_lr=0.1, warmup_steps=10, total_steps=100)
    lrs = [float(opt.schedule(cfg, torch.tensor(s))) for s in [0, 5, 10, 55, 100, 200]]
    assert lrs[1] == pytest.approx(0.5)  # mid-warmup
    assert lrs[2] == pytest.approx(1.0)  # peak
    assert lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)
    assert lrs[5] == pytest.approx(0.1, abs=1e-6)


def test_compression_unbiased_and_bounded():
    g = {"w": torch.tensor(np.random.default_rng(0).normal(size=(64,)), dtype=torch.float32)}
    outs = [opt.compress_int8(g, prng.key(i))["w"].numpy() for i in range(200)]
    mean = np.mean(outs, axis=0)
    np.testing.assert_allclose(mean, g["w"].numpy(), atol=0.02)
    # payload is int8-representable
    scale = np.abs(g["w"].numpy()).max() / 127.0
    assert np.all(np.abs(outs[0] / scale) < 127.5)


def test_bf16_params_fp32_master():
    cfg = opt.OptConfig(warmup_steps=0, peak_lr=1e-3)
    params = {"w": torch.ones(8, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["master"]["w"].dtype == torch.float32
    grads = {"w": torch.full((8,), 1e-3, dtype=torch.bfloat16)}
    new_params, state, _ = opt.apply_updates(params, grads, state, cfg)
    assert new_params["w"].dtype == torch.bfloat16
    # master accumulates finer than bf16 can represent
    assert float(torch.abs(state["master"]["w"] - 1.0).max()) > 0


def test_sr_to_bf16_unbiased():
    """The paper's stochastic rounding applied to optimizer state: the SR
    cast is unbiased."""
    v = torch.tensor(np.random.default_rng(0).normal(size=(2048,)) * 1e-3, dtype=torch.float32)
    outs = np.mean([opt.sr_to_bf16(v, prng.key(i)).to(torch.float32).numpy()
                    for i in range(200)], axis=0)
    rel = np.abs(outs - v.numpy()) / (np.abs(v.numpy()) + 1e-12)
    assert float(rel.mean()) < 5e-4


def test_bf16_sr_state_trains():
    """bf16-SR optimizer state converges on a toy regression (within 5x of
    f32 -- the bf16 params themselves are the floor)."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(128, 16)), dtype=torch.float32)
    y = x @ torch.tensor(rng.normal(size=(16, 2)), dtype=torch.float32)

    def loss_fn(w):
        return torch.mean((x @ w - y) ** 2)

    finals = {}
    for dt in ("float32", "bfloat16"):
        cfg = opt.OptConfig(peak_lr=3e-2, warmup_steps=0, total_steps=200,
                            weight_decay=0.0, state_dtype=dt)
        params = {"w": torch.zeros((16, 2), dtype=torch.bfloat16)}
        st = opt.init(params, cfg)
        assert st["master"]["w"].dtype == getattr(torch, dt)
        for _ in range(200):
            w = params["w"].detach().to(torch.float32).requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(w), [w])
            params, st, _ = opt.apply_updates(params, {"w": g.to(torch.bfloat16)}, st, cfg)
        finals[dt] = float(loss_fn(params["w"].to(torch.float32)))
    assert finals["bfloat16"] < max(5 * finals["float32"], 1e-3)


# ---------------------------------------------------------------------------
# optimizer against the reference's functions
# ---------------------------------------------------------------------------


def test_sr_to_bf16_matches_reference_bitwise():
    v = np.random.default_rng(3).normal(size=(5, 7, 9)).astype(np.float32) * 1e-2
    for seed in (0, 5, 17):
        k, jk = _key(seed)
        got = opt.sr_to_bf16(torch.from_numpy(v), k)
        want = np.asarray(jopt.sr_to_bf16(jnp.asarray(v), jk))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_compress_int8_matches_reference_bitwise():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(6, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(33,)).astype(np.float32),
                  "d": (rng.normal(size=(2, 3, 4)) * 1e-4).astype(np.float32)}}
    k, jk = _key(11)
    got = opt.compress_int8({"a": torch.from_numpy(tree["a"]),
                             "b": {n: torch.from_numpy(x) for n, x in tree["b"].items()}}, k)
    want = jopt.compress_int8(jax.tree.map(jnp.asarray, tree), jk)
    for name, x in _jnp(want).items():
        np.testing.assert_array_equal(_np(got)[name], x, err_msg=name)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(state_dtype):
    """Two AdamW steps on a reduced model's parameter tree (per-layer
    tensors, the reference's stacked leaves), clipped, from the same state:
    weights and state within 1e-6 relative; in bf16 state the stochastic
    rounding draws the reference's bits, leaf for stacked leaf."""
    jcfg = jget_config("tinyllama-1.1b").reduced()
    tcfg = get_config("tinyllama-1.1b").reduced()
    jparams = jinit_params(jcfg, jax.random.key(3))
    model = carry_across("params", jax.tree.map(np.asarray, jparams), cfg=tcfg, device="cpu")
    cfg_kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=5, clip_norm=0.5,
                  state_dtype=state_dtype)
    jstate = jopt.init(jparams, jopt.OptConfig(**cfg_kw))
    state = opt.init(model, opt.OptConfig(**cfg_kw))
    rng = np.random.default_rng(8)
    for _ in range(2):
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), jparams)
        # Op by op, as the port computes: under jit XLA fuses the update and
        # rounds an ulp differently, which flips a stochastic rounding in
        # about one element of 10^4.
        jparams, jstate, jm = jopt.apply_updates(jparams, jax.tree.map(jnp.asarray, grads),
                                                 jstate, jopt.OptConfig(**cfg_kw))
        # The reference's stacked gradients split into per-layer tensors, as
        # carry_across splits a state's trees.
        tgrads = carry_across("opt", {"step": 0, "master": grads, "mu": grads, "nu": grads},
                              cfg=tcfg, device="cpu")["master"]
        model, state, m = opt.apply_updates(model, tgrads, state, opt.OptConfig(**cfg_kw))
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=REL)
        assert float(m["lr"]) == float(jm["lr"])
    assert int(state["step"]) == 2
    for got, want in ((param_tree(model), jparams), (state["master"], jstate["master"]),
                      (state["mu"], jstate["mu"]), (state["nu"], jstate["nu"])):
        want = _jnp(want)
        for name, x in _np(got).items():
            scale = np.abs(want[name]).max()
            np.testing.assert_allclose(x, want[name], rtol=REL, atol=REL * scale, err_msg=name)


# ---------------------------------------------------------------------------
# data pipeline: twins of tests/test_data_serving.py, and the batches
# ---------------------------------------------------------------------------


def test_pipeline_deterministic_and_resumable():
    d1 = SyntheticTextTask(DataConfig(batch_size=2, seq_len=64, seed=3), 512)
    d2 = SyntheticTextTask(DataConfig(batch_size=2, seq_len=64, seed=3), 512)
    b1 = d1.batch(17)
    b2 = d2.batch(17)  # fresh object, same (seed, step) -> same batch
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(d1.batch(18)["tokens"], b1["tokens"])


def test_pipeline_host_sharding_partitions():
    full = SyntheticTextTask(DataConfig(batch_size=4, seq_len=32, num_hosts=1), 512)
    h0 = SyntheticTextTask(DataConfig(batch_size=4, seq_len=32, num_hosts=2, host_id=0), 512)
    h1 = SyntheticTextTask(DataConfig(batch_size=4, seq_len=32, num_hosts=2, host_id=1), 512)
    assert h0.batch(0)["tokens"].shape[0] == 2
    assert h1.batch(0)["tokens"].shape[0] == 2
    assert full.batch(0)["tokens"].shape[0] == 4


@pytest.mark.parametrize("kw", [dict(batch_size=3, seq_len=2048, seed=0),
                                dict(batch_size=4, seq_len=64, seed=9, num_hosts=2, host_id=1)])
def test_pipeline_batches_match_reference(kw):
    for step in (0, 1, 41):
        got = SyntheticTextTask(DataConfig(**kw), 512).batch(step)
        want = JSyntheticTextTask(JDataConfig(**kw), 512).batch(step)
        assert set(got) == set(want)
        for name in got:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])


# ---------------------------------------------------------------------------
# checkpoint: twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def _tree_equal(a, b):
    items_a, items_b = tree_items(a), tree_items(b)
    return [p for p, _ in items_a] == [p for p, _ in items_b] and all(
        torch.equal(x, y) and x.dtype == y.dtype
        for (_, la), (_, lb) in zip(items_a, items_b)
        for x, y in zip(leaf_parts(la), leaf_parts(lb)))


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "s": [torch.full((3,), float(i)) for i in range(2)]}
    ckpt.save(tmp_path, 7, tree)
    like = {"a": torch.empty((2, 3), device="meta"),
            "b": {"c": torch.empty(4, dtype=torch.bfloat16, device="meta")},
            "s": [torch.empty(3, device="meta")] * 2}
    out = ckpt.restore(tmp_path, 7, like, device="cpu")
    assert _tree_equal(tree, out)
    assert out["b"]["c"].dtype == torch.bfloat16


def test_keep_prunes_old(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(tmp_path, s, tree, keep=2)
    assert ckpt.steps_available(tmp_path) == [4, 5]


def test_config_hash_guard(tmp_path):
    cfg1 = get_config("tinyllama-1.1b").reduced()
    cfg2 = get_config("gemma-2b").reduced()
    tree = {"a": torch.zeros(2)}
    ckpt.save(tmp_path, 1, tree, cfg=cfg1)
    with pytest.raises(ValueError, match="different model config"):
        ckpt.restore(tmp_path, 1, tree, cfg=cfg2, device="cpu")


def test_structure_mismatch_guard(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(tmp_path, 1, {"b": torch.zeros(2)}, device="cpu")


def _mini_training(tmp_path, total_steps, failure_at=None):
    cfg = get_config("tinyllama-1.1b").reduced().replace(microbatch=1)
    params = init_params(cfg, 0, device="cpu")
    opt_state = opt.init(params)
    step = tsteps.make_train_step(cfg, opt.OptConfig(total_steps=total_steps, warmup_steps=2))
    data = SyntheticTextTask(DataConfig(batch_size=2, seq_len=64), cfg.vocab_size)
    loop = LoopConfig(total_steps=total_steps, ckpt_every=2, ckpt_dir=str(tmp_path),
                      log_every=100, failure_at_step=failure_at)
    return train(cfg, step, params, opt_state, data, loop, log=lambda s: None)


def test_crash_resume_bitexact(tmp_path):
    """Train 6 steps straight vs crash-at-4 + resume: identical params and
    state."""
    p_straight, s_straight, _ = _mini_training(tmp_path / "a", 6)
    with pytest.raises(PreemptionError):
        _mini_training(tmp_path / "b", 6, failure_at=4)
    p_resumed, s_resumed, hist = _mini_training(tmp_path / "b", 6)  # resumes from step 4
    assert [h["step"] for h in hist] == [5, 6]
    assert _tree_equal(param_tree(p_straight), param_tree(p_resumed))
    assert _tree_equal(s_straight, s_resumed)


def test_elastic_restore_to_a_device(tmp_path):
    """A checkpoint restores onto the device it is given, whatever wrote
    it (the single-device case of the reference's re-sharding restore)."""
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    ckpt.save(tmp_path, 3, tree)
    like = {"w": torch.empty((4, 4), device="meta")}
    out = ckpt.restore(tmp_path, 3, like, device="cpu")
    assert _tree_equal(tree, out)
    assert out["w"].device == torch.device("cpu")


def test_atomicity_no_partial_dirs(tmp_path):
    tree = {"a": torch.zeros(8)}
    ckpt.save(tmp_path, 1, tree)
    leftovers = [p for p in Path(tmp_path).iterdir() if p.name.startswith(".tmp")]
    assert leftovers == []
    assert ckpt.latest_step(tmp_path) == 1


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, state_dtype):
    """The reference's checkpoint of (params, opt) restores into the port as
    what carry_across gives, and the port's into the reference; the
    manifests' names, dtypes and config hashes are equal."""
    name = "llama-3.2-vision-11b"  # two stacked axes: layers and a group's self blocks
    jcfg, tcfg = jget_config(name).reduced(), get_config(name).reduced()
    ocfg = dict(state_dtype=state_dtype)
    jparams = jinit_params(jcfg, jax.random.key(5))
    jstate = jopt.init(jparams, jopt.OptConfig(**ocfg))
    jstate["step"] = jnp.asarray(7, jnp.int32)
    jstate["mu"] = jax.tree.map(lambda x: x + 0.25, jstate["mu"])
    jckpt.save(tmp_path / "ref", 7, {"params": jparams, "opt": jstate}, cfg=jcfg)

    model = carry_across("params", jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                                                jparams), cfg=tcfg, device="cpu")
    state = carry_across("opt", jax.tree.map(np.asarray, jstate), cfg=tcfg, device="cpu")
    like = {"params": init_params(tcfg, 0, device="cpu"), "opt": opt.init(model, opt.OptConfig(
        **ocfg))}
    got = ckpt.restore(tmp_path / "ref", 7, like, cfg=tcfg, device="cpu")
    assert _tree_equal(got["params"], param_tree(model))
    assert _tree_equal(got["opt"], state)

    ckpt.save(tmp_path / "port", 7, {"params": model, "opt": state}, cfg=tcfg)
    manifests = [json.loads((tmp_path / d / "step_00000007" / "manifest.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert ckpt.config_hash(tcfg) == jckpt.config_hash(jcfg)
    jlike = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         {"params": jparams, "opt": jstate})
    back = jckpt.restore(tmp_path / "port", 7, jlike, cfg=jcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves({"params": jparams, "opt": jstate})):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# steps, mesh, launcher
# ---------------------------------------------------------------------------


def test_ising_solve_step_matches_reference():
    """make_ising_solve_step at 50 steps, D 3, R 8, N 20, on chip-integer
    instances scaled by a power of two into the anneal's range (the step
    normalises nothing; the scaling is exact, so every energy is): the best
    read's spins and energy equal the reference's wherever no phase of the
    document lies within the trajectories' bound of the readout boundary,
    and every returned energy is its spins' exact energy."""
    rng = np.random.default_rng(6)
    d, r, n = 3, 8, 20
    u = np.triu(rng.integers(-14, 15, (d, n, n)), 1)
    j = (u + u.transpose(0, 2, 1)).astype(np.float32)
    h = rng.integers(-14, 15, (d, n)).astype(np.float32)
    denom = 2 * np.abs(j).sum(-1).max(-1) + np.abs(h).max(-1)
    scale = (2.0 ** np.ceil(np.log2(denom))).astype(np.float32)
    hs, js = h / scale[:, None], j / scale[:, None, None]
    phi0 = rng.uniform(0, 2 * np.pi, (d, r, n)).astype(np.float32)
    kw = dict(steps=50, dt=0.35, ks_max=1.2)
    want_s, want_e = jax.jit(jsteps.make_ising_solve_step(**kw))(hs, js, phi0)
    got_s, got_e = tsteps.make_ising_solve_step(**kw)(
        torch.from_numpy(hs), torch.from_numpy(js), torch.from_numpy(phi0))
    assert got_s.dtype == torch.int8 and got_s.shape == (d, n) and got_e.shape == (d,)
    s = got_s.numpy().astype(np.float64)
    exact = (np.einsum("dn,dn->d", s, h) + np.einsum("di,dij,dj->d", s, j, s)) / scale
    np.testing.assert_array_equal(got_e.numpy(), exact.astype(np.float32))
    phi = np.stack([np.asarray(jkref.ref_cobi_trajectory(js[i], hs[i], phi0[i], **kw))
                    for i in range(d)])
    clear = (np.abs(np.cos(phi)) > PHASE_TOL * (1 + np.abs(phi))).all(axis=(1, 2))
    assert clear.sum() >= 2
    np.testing.assert_array_equal(got_s.numpy()[clear], np.asarray(want_s)[clear])
    np.testing.assert_array_equal(got_e.numpy()[clear], np.asarray(want_e)[clear])


def test_host_mesh_and_production_mesh():
    """The host mesh runs as no mesh; make_production_mesh raises under any
    world size but 256 (naming what it found); make_train_step takes a
    DeviceMesh and refuses anything else."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    mesh = tmesh.make_host_mesh("cpu")
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")
    cfg = get_config("tinyllama-1.1b").reduced()
    tsteps.make_train_step(cfg, opt.OptConfig(), mesh=mesh)
    with pytest.raises(RuntimeError, match="256 ranks; found no process group"):
        tmesh.make_production_mesh()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with pytest.raises(RuntimeError, match="found a process group of 4 ranks"):
            tmesh.make_production_mesh()
        device_mesh = tmesh.make_mesh((2, 2), ("data", "model"))
        assert callable(tsteps.make_train_step(cfg, opt.OptConfig(), mesh=device_mesh))
    finally:
        dist.destroy_process_group()
    with pytest.raises(TypeError, match="a mesh is None, a HostMesh or a DeviceMesh"):
        tsteps.make_train_step(cfg, opt.OptConfig(), mesh=object())


def test_inference_steps_stay_autograd_free_after_a_train_step():
    cfg = get_config("tinyllama-1.1b").reduced().replace(microbatch=1)
    model = init_params(cfg, 0, device="cpu")
    state = opt.init(model)
    batch = SyntheticTextTask(DataConfig(batch_size=2, seq_len=32), cfg.vocab_size).batch(0)
    model, state, _ = tsteps.make_train_step(cfg, opt.OptConfig())(model, state, batch)
    tokens = torch.from_numpy(batch["tokens"])
    cache = init_cache(cfg, 2, 40, device="cpu")
    logits, cache = tsteps.make_prefill_step(cfg)(model, tokens, cache)
    nt, step_logits, cache = tsteps.make_decode_step(cfg)(
        model, tokens[:, :1], torch.full((2, 1), 32), cache)
    seg = torch.zeros_like(tokens)
    emb = tsteps.make_embed_step(cfg, 2)(model, tokens, seg)
    with EncoderStage(cfg, model, max_len=64, device="cpu") as stage:
        staged = stage.submit(synthetic_document(7, 4)).result(timeout=120)
    for out in (logits, step_logits, emb, staged, *[x for _, x in tree_items(cache)]):
        assert out.grad_fn is None and not out.requires_grad
    assert all(p.grad is None and not p.requires_grad for p in model.parameters())


def test_train_cli_runs_and_resumes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
           "--reduced", "--steps", "4", "--ckpt-every", "2", "--batch", "2", "--seq", "64",
           "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    first = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert first.returncode == 0, first.stderr
    assert ckpt.steps_available(tmp_path) == [2, 4]
    assert "[loop] 4 steps" in first.stdout
    cmd[cmd.index("--steps") + 1] = "6"
    second = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 4" in second.stdout
    assert ckpt.steps_available(tmp_path) == [2, 4, 6]


# The reference's step-input specs and shardings (params_spec through
# step_shardings) are the sharding half of launch/steps.py: ROADMAP's mesh
# item, not this port's single-device steps.
_SHARDING = {"params_spec", "opt_state_spec", "cache_spec", "input_specs", "step_shardings"}


@pytest.mark.parametrize("module", ["train.optimizer", "train.checkpoint", "train.loop",
                                    "data.pipeline", "launch.mesh", "launch.steps",
                                    "launch.train"])
def test_twins_define_the_reference_names(module):
    """Every public function and class the reference's module defines has
    its namesake in the port's twin."""
    import importlib
    import inspect

    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    names = {n for n, obj in vars(ref).items()
             if not n.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
             and obj.__module__ == ref.__name__} - _SHARDING
    assert names
    assert sorted(names - set(vars(port))) == []
