"""The port's mesh and distributed layer on the CPU, held against the JAX
package: sharding rules (``distributed.sharding``), the input specs and
step shardings (``launch.steps``), the production mesh
(``launch.mesh.make_production_mesh``), the activation constraints
(``distributed.context``), the sharded step makers on four gloo ranks and
the dry run (``launch.dryrun``).  The fleet's tests are in
``test_torch_fleet.py``.

Meshes of 256 and 512 ranks are built on the ``fake`` process-group
backend in this process (each test starts its group and tears it down);
multi-rank numerics run in four gloo subprocesses meeting through a file
store under ``tmp_path`` (no TCP port, so xdist workers cannot collide).

Bars: specs, shapes, dtypes and placements equal; the four-rank train
losses and decode logits within 2e-3 (rtol = atol, the reference's own bar
for its 4-device run) of the one-rank port run and of the reference's
single-device run; the bf16 stochastic-rounding state and the restored
checkpoint shards bit for bit.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as jshape_applicable
from repro.distributed import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro.train import optimizer as jopt
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.distributed import context as ctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import init_cache
from repro_torch.models.common import leaf_parts, stacked_shape, tree_items
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-3  # rtol = atol: tests/test_distributed.py's bar for DP 2 x TP 2


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` default process group of ``world`` ranks (this process is
    rank 0), torn down after the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes():
    """The two production meshes (built on fake groups; their names and
    shapes outlive the groups) and the reference's, built from repeated
    ``jax.devices()`` as tests/test_distributed.py builds them."""
    out = {}
    for multi in (False, True):
        with fake_group(512 if multi else 256):
            port = tmesh.make_production_mesh(multi_pod=multi)
        shape, axes = tmesh.PRODUCTION[multi]
        devs = np.array(jax.devices() * math.prod(shape))[:math.prod(shape)].reshape(shape)
        out[multi] = (port, Mesh(devs, axes))
    return out


def _jleaves(tree):
    return [(tuple(getattr(k, "key", k) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _same_stacked(jtree_sh, jtree, port_sh, port_tree):
    """Each reference spec, its stacked leading axes (all None) dropped,
    equals the spec of every per-layer tensor of the port's leaf; the
    reference leaf's shape is the port leaf's stacked shape."""
    jl, pl, ps = _jleaves(jtree_sh), tree_items(port_sh), tree_items(port_tree)
    assert [p for p, _ in jl] == [p for p, _ in pl] == [p for p, _ in ps]
    shapes = dict(_jleaves(jtree))
    for (path, jsh), (_, psh), (_, leaf) in zip(jl, pl, ps):
        assert tuple(shapes[path].shape) == stacked_shape(leaf), path
        spec = tuple(jsh.spec) + (None,) * (len(shapes[path].shape) - len(jsh.spec))
        lead = len(spec) - leaf_parts(leaf)[0].dim()
        assert spec[:lead] == (None,) * lead, (path, spec)
        assert {s.spec for s in leaf_parts(psh)} == {spec[lead:]}, (path, spec, psh)


def _same_flat(jtree_sh, port_sh):
    jl = _jleaves(jtree_sh)
    pl = tree_items(port_sh) if isinstance(port_sh, dict) else [((), port_sh)]
    assert len(jl) == len(pl)
    for (path, jsh), (_, psh) in zip(jl, pl):
        assert tuple(jsh.spec) == psh.spec, (path, tuple(jsh.spec), psh.spec)


# ------------------------------------------------------------- (a) spec parity


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_sharding_matches_reference(arch, multi, meshes):
    """param_sharding (FSDP x TP, and serve=True's TP only) equals the
    reference's spec for every leaf on both production meshes."""
    assert tuple(J_ARCHS) == tuple(ASSIGNED_ARCHS)
    port_mesh, jmesh = meshes[multi]
    jspec, spec = jsteps.params_spec(jget_config(arch)), tsteps.params_spec(get_config(arch))
    for serve in (False, True):
        _same_stacked(jshd.param_sharding(jspec, jmesh, serve=serve), jspec,
                      shd.param_sharding(spec, port_mesh, serve=serve), spec)


@pytest.mark.parametrize("layout", ["heads", "seq"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_sharding_matches_reference(arch, layout, meshes, monkeypatch):
    """cache_sharding at decode_32k in both KV layouts (the mLSTM state's
    special case included), on the 16 x 16 mesh."""
    monkeypatch.setattr(jshd, "KV_CACHE_LAYOUT", layout)
    monkeypatch.setattr(shd, "KV_CACHE_LAYOUT", layout)
    port_mesh, jmesh = meshes[False]
    jcfg, cfg = jget_config(arch), get_config(arch)
    jc = jsteps.cache_spec(jcfg, 128, 32768)
    c = tsteps.cache_spec(cfg, 128, 32768)
    _same_flat(jshd.cache_sharding(jc, jmesh, n_kv_heads=jcfg.n_kv_heads),
               shd.cache_sharding(c, port_mesh, n_kv_heads=cfg.n_kv_heads))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b", "xlstm-1.3b"])
def test_opt_state_sharding_matches_reference(arch, meshes):
    """The ZeRO widening of "data" to ("pod", "data") on the multi-pod
    mesh, and the replicated step."""
    port_mesh, jmesh = meshes[True]
    jcfg, cfg = jget_config(arch), get_config(arch)
    jp, p = jsteps.params_spec(jcfg), tsteps.params_spec(cfg)
    jst, st = jsteps.opt_state_spec(jcfg), tsteps.opt_state_spec(cfg)
    jo = jshd.opt_state_sharding(jst, jshd.param_sharding(jp, jmesh), jmesh)
    o = shd.opt_state_sharding(st, shd.param_sharding(p, port_mesh), port_mesh)
    for name in ("master", "mu", "nu"):
        _same_stacked(jo[name], jst[name], o[name], st[name])
    assert tuple(jo["step"].spec) == o["step"].spec == ()
    widened = [s.spec for _, leaf in tree_items(o["master"]) for s in leaf_parts(leaf)
               if ("pod", "data") in s.spec]
    assert widened


def _cells(arch):
    cfg = jget_config(arch)
    return [c for c in J_SHAPES if jshape_applicable(cfg, c)[0]]


def _port_cell(cell):
    return next(c for c in SHAPES if c.name == cell.name)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_step_shardings_and_input_specs_match_reference(arch, meshes):
    """(a) step_shardings for every applicable cell kind (long_500k's
    batch-1 path strips the batch axes from the cache), on 16 x 16, equal
    the reference's, and (b) input_specs gives jax.eval_shape's shapes and
    dtypes at full size, every tensor on ``meta`` (no storage)."""
    port_mesh, jmesh = meshes[False]
    jcfg, cfg = jget_config(arch), get_config(arch)
    for jcell in _cells(arch):
        cell = _port_cell(jcell)
        jspecs, specs = jsteps.input_specs(jcfg, jcell), tsteps.input_specs(cfg, cell)
        # (b) shapes and dtypes, no storage
        for key in jspecs:
            if key == "params" or key == "opt_state":
                jtree = jspecs[key]
                items = tree_items(specs[key]) if key == "params" else [
                    (path, leaf) for name in ("master", "mu", "nu")
                    for path, leaf in [((name,) + p, lf) for p, lf in
                                       tree_items(specs[key][name])]]
                jitems = _jleaves(jtree if key == "params" else
                                  {n: jtree[n] for n in ("master", "mu", "nu")})
                assert [p for p, _ in jitems] == [p for p, _ in items]
                for (path, jl), (_, leaf) in zip(jitems, items):
                    assert tuple(jl.shape) == stacked_shape(leaf), path
                    assert all(t.is_meta for t in leaf_parts(leaf))
                    assert str(np.dtype(jl.dtype)) == str(leaf_parts(leaf)[0].dtype)[6:], path
                if key == "opt_state":
                    assert specs[key]["step"].is_meta and specs[key]["step"].shape == ()
            else:
                jl, pl = _jleaves(jspecs[key]), (tree_items(specs[key])
                                                 if isinstance(specs[key], dict)
                                                 else [((), specs[key])])
                assert [p for p, _ in jl] == [p for p, _ in pl], key
                for (path, a), (_, t) in zip(jl, pl):
                    assert tuple(a.shape) == tuple(t.shape) and t.is_meta, (key, path)
                    assert str(np.dtype(a.dtype)) == str(t.dtype)[6:], (key, path)
        # (a) the shardings
        (jin, jout) = jsteps.step_shardings(jcfg, jcell, jmesh)
        (pin, pout) = tsteps.step_shardings(cfg, cell, port_mesh)
        _same_stacked(jin[0], jspecs["params"], pin[0], specs["params"])
        if cell.kind == "train":
            for name in ("master", "mu", "nu"):
                _same_stacked(jin[1][name], jspecs["opt_state"][name], pin[1][name],
                              specs["opt_state"][name])
            _same_flat(jin[2], pin[2])
            _same_flat(jout[2], pout[2])
            continue
        for jsh, psh in zip(jin[1:], pin[1:]):
            _same_flat(jsh, psh)
        for jsh, psh in zip(jout, pout):
            _same_flat(jsh, psh)
        if cell.name == "long_500k":
            assert all("data" not in str(s.spec) for _, s in tree_items(pin[-1]))


# -------------------------------------------------------------- (c) the mesh


def test_production_mesh_shapes_and_world_size():
    """The reference's shapes and axis names on fake groups of 256 and 512
    ranks; any other world size raises, naming what it found."""
    with fake_group(256):
        m = tmesh.make_production_mesh()
        assert tuple(m.shape) == (16, 16) and m.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="512 ranks; found a process group of 256"):
            tmesh.make_production_mesh(multi_pod=True)
    with fake_group(512):
        m = tmesh.make_production_mesh(multi_pod=True)
        assert tuple(m.shape) == (2, 16, 16)
        assert m.mesh_dim_names == ("pod", "data", "model")
        assert m.device_type == "cpu"
    with fake_group(8):
        with pytest.raises(RuntimeError, match="found a process group of 8 ranks"):
            tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="found no process group"):
        tmesh.make_production_mesh()


# --------------------------------------------------------- (d) constrain


def test_constrain_identity_and_placements():
    """Without a mesh (or on a plain tensor) constrain returns x itself; on
    a 2 x 2 mesh it gives the logical axes' placements, dropping an axis
    that does not divide its dim."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.ones(4, 6, 8)
    assert ctx.constrain(x, "batch", None, "model") is x
    with fake_group(4):
        mesh = tmesh.make_mesh((2, 2), ("data", "model"))
        with ctx.activation_mesh(mesh):
            assert ctx.current_mesh() is mesh
            assert ctx.constrain(x, "batch", None, "model") is x
            d = distribute_tensor(x, mesh, [Replicate(), Replicate()], src_data_rank=None)
            got = ctx.constrain(d, "batch", None, "model")
            assert list(got.placements) == [Shard(0), Shard(2)]
            assert ctx.constrain(got, "batch", None, "model") is got
            odd = distribute_tensor(torch.ones(3, 6, 8), mesh, [Replicate(), Replicate()],
                                    src_data_rank=None)
            assert list(ctx.constrain(odd, "batch", "model", None).placements) == [
                Replicate(), Shard(1)]
        assert ctx.current_mesh() is None


# ------------------------------------------------- (g) sharded steps, 4 ranks

WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world)
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.interop import carry_across
    from repro_torch.launch import mesh as tmesh, steps as S
    from repro_torch.models import init_cache, param_tree, train_loss
    from repro_torch.models.common import leaf_parts, tree_items
    from repro_torch.train import checkpoint as ckpt, optimizer as opt

    work = json.loads(open(work).read())
    shape = (2, world // 2) if world > 1 else (1, 1)
    mesh = tmesh.make_mesh(shape, ("data", "model"))
    cfg = get_config("tinyllama-1.1b").reduced().replace(microbatch=2)
    arrays = np.load(work["params"])
    tree = {}
    for name in arrays.files:
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arrays[name]
    fresh = lambda: carry_across("params", tree, cfg=cfg, device="cpu")
    tokens = np.load(work["tokens"])
    out = {}
    # Three train steps, float32 state.
    ocfg = opt.OptConfig(warmup_steps=0, peak_lr=1e-3)
    model = fresh()
    state = opt.init(model, ocfg)
    step = S.make_train_step(cfg, ocfg, mesh=mesh)
    out["losses"] = [float(step(model, state, {"tokens": tokens, "targets": tokens})[2]["loss"])
                     for _ in range(3)]
    # Prefill 16 tokens and one decode step.
    model = fresh()
    cache = init_cache(cfg, 4, 32, device="cpu")
    S.make_prefill_step(cfg, mesh)(model, torch.from_numpy(tokens[:, :16]), cache)
    _, logits, _ = S.make_decode_step(cfg, mesh)(
        model, torch.from_numpy(tokens[:, 16:17]), torch.full((4, 1), 16, dtype=torch.int32),
        cache)
    out["logits"] = logits.full_tensor().tolist()
    # bf16 stochastic-rounding state: one update of the same gradients on
    # the mesh and unsharded (clip off: the norm's reduction order cannot
    # move the scale), compared bit for bit.
    scfg = opt.OptConfig(warmup_steps=0, peak_lr=1e-3, state_dtype="bfloat16", clip_norm=1e9)
    plain, sharded = fresh(), fresh()
    leaves = [p for _, leaf in tree_items(param_tree(plain)) for p in leaf_parts(leaf)]
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = train_loss(cfg, plain, {"tokens": torch.from_numpy(tokens),
                                      "targets": torch.from_numpy(tokens)})
    it = iter(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    gtree = param_tree(plain)
    grads = {}
    from repro_torch.models.common import map_parts, tree_unflatten
    grads = tree_unflatten(gtree, [map_parts(lambda _: next(it).float(), leaf)
                                   for _, leaf in tree_items(gtree)])
    s_plain, s_sharded = opt.init(plain, scfg), opt.init(sharded, scfg)
    opt.apply_updates(plain, grads, s_plain, scfg)
    S.distribute_model(sharded, mesh)
    p_sh = shd.param_sharding(param_tree(sharded), mesh)
    S.place_tree(s_sharded, shd.opt_state_sharding(s_sharded, p_sh, mesh))
    opt.apply_updates(sharded, shd.distribute_tree(grads, p_sh), s_sharded, scfg)
    diff = 0
    for name in ("master", "mu", "nu"):
        for (_, a), (_, b) in zip(tree_items(s_plain[name]), tree_items(s_sharded[name])):
            for x, y in zip(leaf_parts(a), leaf_parts(b)):
                diff += int((x.view(torch.int16) != y.full_tensor().view(torch.int16)).sum())
    out["sr_state_bits_differing"] = diff
    # Elastic restore of a one-rank checkpoint onto this mesh.
    like = param_tree(fresh())
    restored = ckpt.restore(work["ckpt"], 1, like, shardings=shd.param_sharding(like, mesh))
    saved = np.load(work["ckpt"] + "/step_00000001/arrays.npz")
    bad = 0
    for i, (_, leaf) in enumerate(tree_items(restored)):
        whole = torch.from_numpy(saved[f"a{i}"])
        parts = leaf_parts(leaf)
        stacked = whole.reshape((len(parts),) + tuple(parts[0].shape))
        for k, t in enumerate(parts):
            local, offset = shd.local_block(t.shape, mesh, t.placements)
            want = stacked[k][tuple(slice(o, o + n) for o, n in zip(offset, local))]
            bad += int(not torch.equal(t.to_local(), want))
    out["restored_shards_differing"] = bad
    out["placements"] = str(tree_items(restored)[0][1].placements)
    if rank == 0:
        open(work["out"], "w").write(json.dumps(out))
    dist.destroy_process_group()
    """
)


def run_ranks(prog: str, world: int, tmp_path: Path, work: dict, timeout: int = 300) -> dict:
    """``prog`` on ``world`` gloo ranks in subprocesses (a file store under
    tmp_path); rank 0's JSON output."""
    tag = f"{world}_{abs(hash(prog)) % 10**6}"
    work = dict(work, out=str(tmp_path / f"out_{tag}.json"))
    wpath = tmp_path / f"work_{tag}.json"
    wpath.write_text(json.dumps(work))
    store = tmp_path / f"store_{tag}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(r), str(world), str(store),
                               str(wpath)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append((p.returncode, err[-3000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    return json.loads(Path(work["out"]).read_text())


def _save_tree(path: Path, tree) -> None:
    flat = {"/".join(k): np.asarray(v) for k, v in
            ((tuple(getattr(p, "key", p) for p in path), leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])}
    np.savez(path, **flat)


def test_sharded_steps_match_one_rank_and_reference(tmp_path):
    """tinyllama reduced (microbatch 2) with the reference's weights on four
    gloo ranks (DP 2 x TP 2): 3 train losses within 2e-3 of the one-rank
    port run and of the reference's single-device losses; the decode
    logits within 2e-3 of both; one bf16 stochastic-rounding update bit
    for bit against the unsharded one; a one-rank checkpoint restored with
    ``shardings=`` onto the mesh, every local shard equal to its slice of
    the saved arrays."""
    from repro.models import decode_step as jdecode_step
    from repro.models import init_cache as jinit_cache
    from repro.models import prefill as jprefill
    from repro_torch.interop import carry_across

    jcfg = jget_config("tinyllama-1.1b").reduced().replace(microbatch=2)
    cfg = get_config("tinyllama-1.1b").reduced().replace(microbatch=2)
    jparams = jinit_params(jcfg, jax.random.key(0))
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (4, 64), 0, jcfg.vocab_size),
                        np.int32)
    # The reference, one device.
    ocfg = jopt.OptConfig(warmup_steps=0, peak_lr=1e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, ocfg))
    p, st, want_losses = jparams, jopt.init(jparams), []
    for _ in range(3):
        p, st, m = jstep(p, st, {"tokens": tokens, "targets": tokens})
        want_losses.append(float(m["loss"]))
    jc = jinit_cache(jcfg, 4, 32)
    _, jc = jprefill(jcfg, jparams, tokens[:, :16], jc)
    want_logits, _ = jdecode_step(jcfg, jparams, tokens[:, 16:17],
                                  jnp.full((4, 1), 16, jnp.int32), jc)
    # The port, one rank (no mesh).
    tree = jax.tree.map(np.asarray, jparams)
    model = carry_across("params", tree, cfg=cfg, device="cpu")
    tstate = opt.init(model, opt.OptConfig(warmup_steps=0, peak_lr=1e-3))
    tstep = tsteps.make_train_step(cfg, opt.OptConfig(warmup_steps=0, peak_lr=1e-3))
    one_losses = [float(tstep(model, tstate, {"tokens": tokens, "targets": tokens})[2]["loss"])
                  for _ in range(3)]
    model = carry_across("params", tree, cfg=cfg, device="cpu")
    cache = init_cache(cfg, 4, 32, device="cpu")
    tsteps.make_prefill_step(cfg)(model, torch.from_numpy(tokens[:, :16]), cache)
    _, one_logits, _ = tsteps.make_decode_step(cfg)(
        model, torch.from_numpy(tokens[:, 16:17]), torch.full((4, 1), 16), cache)
    ckpt.save(tmp_path / "ckpt", 1, model, cfg=cfg)
    # Four ranks.
    _save_tree(tmp_path / "params.npz", tree)
    np.save(tmp_path / "tokens.npy", tokens)
    out = run_ranks(WORKER, 4, tmp_path, {"params": str(tmp_path / "params.npz"),
                                          "tokens": str(tmp_path / "tokens.npy"),
                                          "ckpt": str(tmp_path / "ckpt")})
    np.testing.assert_allclose(out["losses"], one_losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out["losses"], want_losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(one_losses, want_losses, rtol=TOL, atol=TOL)
    assert out["losses"][2] < out["losses"][0]
    logits = np.asarray(out["logits"])
    np.testing.assert_allclose(logits, one_logits.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(logits, np.asarray(want_logits), rtol=TOL, atol=TOL)
    assert out["sr_state_bits_differing"] == 0
    assert out["restored_shards_differing"] == 0
    assert "Shard" in out["placements"]


# ---------------------------------------------------------------- (h) dry run


def _dryrun(tmp_path, *calls):
    """``python -m repro_torch.launch.dryrun`` with each of ``calls``'
    arguments, all at once, records under tmp_path: their outputs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                               "--out", str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
             for args in calls]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    return outs


TRAIN_CELL = ("--arch", "tinyllama-1.1b", "--shape", "train_4k", "--mesh", "single")
FLEET_CELL = ("--arch", "ising-fleet", "--mesh", "single")


def test_dryrun_train_and_fleet_cells(tmp_path, meshes):
    """tinyllama-1.1b x train_4k on 16 x 16 and the ising-fleet cell reach
    ``ok``: the per-rank argument bytes equal the local shard bytes
    reckoned from the specs; train shows all-gather and all-reduce
    traffic; the fleet's per-rank flops are steps * 2 * (2 R) * N_pad^2
    per document of its shard (R its 32 replicas, N_pad the 128 lanes the
    kernel's operands are padded to), within 1% (the energies' products
    are the rest), with its three all-reduces and two all-gathers; a
    second call reads the cached records and writes none."""
    train_out, fleet_out = _dryrun(tmp_path, TRAIN_CELL, FLEET_CELL)
    assert "tinyllama-1.1b x train_4k: ok " in train_out, train_out
    assert "ising-fleet x solve: ok " in fleet_out, fleet_out
    rec = json.loads((tmp_path / "tinyllama-1.1b__train_4k__single.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["fits"]
    port_mesh, _ = meshes[False]
    cfg = get_config("tinyllama-1.1b")
    cell = next(c for c in SHAPES if c.name == "train_4k")
    specs = tsteps.input_specs(cfg, cell)
    (p_sh, o_sh, b_sh), _ = tsteps.step_shardings(cfg, cell, port_mesh)

    def local(tree, sh):
        return sum(math.prod(s.local_shape(t.shape)) * t.element_size()
                   for (_, leaf), (_, sl) in zip(tree_items(tree), tree_items(sh))
                   for t, s in zip(leaf_parts(leaf), leaf_parts(sl)))

    want = {"params": local(specs["params"], p_sh),
            "opt_state": local(specs["opt_state"], o_sh),
            "batch": local(specs["batch"], b_sh)}
    # Every tinyllama weight divides 16 x 16: a rank holds 1/256 of them.
    assert want["params"] == sum(t.numel() * 2 for _, leaf in tree_items(specs["params"])
                                 for t in leaf_parts(leaf) if t.dim() == 2) // 256 + sum(
        t.numel() * 2 for _, leaf in tree_items(specs["params"])
        for t in leaf_parts(leaf) if t.dim() < 2)
    assert rec["arg_bytes_per_chip"] == dict(want, total=sum(want.values()))
    assert rec["collectives_per_chip"]["all-gather"] > 0
    assert rec["collectives_per_chip"]["all-reduce"] > 0
    assert rec["flops_per_chip"] > 0 and rec["peak_bytes_per_chip"] > rec[
        "arg_bytes_per_chip"]["total"]

    fleet = json.loads((tmp_path / "ising-fleet__solve__single.json").read_text())
    d_l, r_l, n_pad, steps = 4096 // 16, 512 // 16, 128, 1000
    model_flops = steps * 2 * (2 * r_l) * n_pad**2 * d_l
    assert abs(fleet["flops_per_chip"] - model_flops) <= 0.01 * model_flops
    assert fleet["collective_calls_per_chip"]["all-reduce"] == 3
    assert fleet["collective_calls_per_chip"]["all-gather"] == 2

    before = {p.name: p.stat().st_mtime_ns for p in tmp_path.glob("*.json")}
    again = _dryrun(tmp_path, TRAIN_CELL, FLEET_CELL)
    assert again == [train_out, fleet_out]
    assert {p.name: p.stat().st_mtime_ns for p in tmp_path.glob("*.json")} == before
