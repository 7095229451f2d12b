"""Multi-pod dry run: the twin of ``repro.launch.dryrun`` on
``torch.distributed``.

Every (architecture x input shape x mesh) cell is built on a ``fake``
process group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks in one process,
the counterpart of the reference's 512 placeholder devices.  The step runs
once as one rank of that mesh under ``FakeTensorMode`` (shapes only, no
storage; the fake group's collectives move nothing), and the record holds
what that rank would hold and do:

  * status: ok / skipped (``shape_applicable``'s reason) / error (the
    traceback's tail: an error is a fault to fix, not a cell to drop);
  * chips; seconds to build and run;
  * arg_bytes_per_chip: params, opt_state, cache, batch (each leaf's local
    shard under ``launch.steps.step_shardings``) and their total;
  * peak_bytes_per_chip: the argument bytes plus ``analyze``'s peak of
    what the step allocates on one rank (the inputs are placed on the mesh
    before the step, as a deployment holds them, so their global values
    do not count);
  * flops, traffic and collectives per chip (``analysis.cost.analyze``);
  * fits: the peak within ``core.hardware.H100_SXM``'s memory.

A cell that runs past CELL_BUDGET_S seconds is recorded as an error.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
Records are cached per cell as JSON under experiments/dryrun_torch/, and a
second run reads them back (resumable); ``--arch ising-fleet`` runs the
fleet cell (D 4096 x R 512 x N 64 x 1,000 steps) through
``distributed.fleet``.  The fleet's anneal repeats one step's ops, and on
fake tensors the kernel's plain version walks them instance by instance,
so the cell runs at 1 and at 2 steps and every count is carried linearly to
1,000 (exact: the counts are affine in the step count); the peak is the
larger of the two runs'.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import signal
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ASSIGNED_ARCHS, REGISTRY, SHAPES, get_config, shape_applicable
from repro_torch.core.hardware import H100_SXM
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import PRODUCTION, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.common import leaf_parts, tree_items
from repro_torch.train.optimizer import OptConfig
from repro_torch.train import optimizer as opt

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
FLEET = dict(docs=4096, replicas=512, spins=64, steps=1000)
# Seconds a cell may run before it is recorded as an error: a Python loop
# over the sequence (xlstm's sLSTM) walks every position on fake tensors.
CELL_BUDGET_S = 600


def fake_group(multi_pod: bool) -> None:
    """(Re)start the default process group as a ``fake`` one of the
    production mesh's size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(PRODUCTION[multi_pod][0])
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _local_bytes(tree, shardings) -> int:
    """Bytes of one rank's shards of ``tree``'s tensors under ``shardings``
    (two trees of one structure)."""
    total = 0
    for (_, leaf), (_, sh) in zip(tree_items(tree), tree_items(shardings)):
        for t, s in zip(leaf_parts(leaf), leaf_parts(sh)):
            total += math.prod(s.local_shape(t.shape)) * t.element_size()
    return total


def arg_bytes(cfg, cell, mesh, *, serve_params: bool = False, opt_cfg=None) -> dict:
    """Per-rank argument bytes of a cell's step, by input, from
    ``input_specs`` and ``step_shardings``."""
    specs = S.input_specs(cfg, cell, opt_cfg)
    in_sh, _ = S.step_shardings(cfg, cell, mesh, serve_params=serve_params, opt_cfg=opt_cfg)
    out = {"params": _local_bytes(specs["params"], in_sh[0])}
    if cell.kind == "train":
        out["opt_state"] = _local_bytes(specs["opt_state"], in_sh[1])
        out["batch"] = _local_bytes(specs["batch"], in_sh[2])
    else:
        cache_sh = in_sh[3] if cell.kind == "decode" else in_sh[2]
        out["cache"] = _local_bytes(specs["cache"], cache_sh)
        inputs = {"tokens": specs["tokens"]}
        shards = {"tokens": in_sh[1]}
        if cell.kind == "decode":
            inputs["positions"], shards["positions"] = specs["positions"], in_sh[2]
        elif "frontend" in specs:
            inputs["frontend"], shards["frontend"] = specs["frontend"], in_sh[3]
        out["batch"] = _local_bytes(inputs, shards)
    out["total"] = sum(out.values())
    return out


def _fake_inputs(cfg, cell, opt_cfg):
    """The step's inputs as global fake tensors (called under a
    ``FakeTensorMode``): a model, and per kind its state and batch, or its
    tokens and cache."""
    b, s = cell.global_batch, cell.seq_len
    model = M.Model(cfg)
    tok = lambda shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
    frontend = (torch.zeros((b, cfg.n_frontend_tokens, cfg.d_model), dtype=cfg.dtype)
                if cfg.n_frontend_tokens else None)
    if cell.kind == "train":
        batch = {"tokens": tok((b, s)), "targets": tok((b, s))}
        if frontend is not None:
            batch["frontend"] = frontend
        return model, opt.init(model, opt_cfg), batch, frontend
    cache = M.init_cache(cfg, b, s, device="cpu")
    return model, cache, tok, frontend


def _run_step(cfg, cell, mesh, serve_params, opt_cfg):
    """One rank's step of the cell, its inputs placed on the mesh first."""
    from repro_torch.analysis.cost import analyze

    b = cell.global_batch
    if cell.kind == "train":
        model, state, batch, _ = _fake_inputs(cfg, cell, opt_cfg)
        S.distribute_model(model, mesh)
        S.place_tree(state, shd.opt_state_sharding(
            state, shd.param_sharding(M.param_tree(model), mesh), mesh))
        return analyze(S.make_train_step(cfg, opt_cfg, mesh=mesh), model, state, batch)
    model, cache, tok, frontend = _fake_inputs(cfg, cell, opt_cfg)
    if cell.kind == "prefill":
        extra = () if frontend is None else (frontend,)
        tokens, *rest = S.place_inference_inputs(cfg, mesh, model, serve_params,
                                                 tok((b, cell.seq_len)), cache, extra)
        fn = S.make_prefill_step(cfg, mesh=mesh, serve_params=serve_params)
        return analyze(fn, model, tokens, cache, rest[0] if rest else None)
    tokens, positions = S.place_inference_inputs(cfg, mesh, model, serve_params, tok((b, 1)),
                                                 cache, (tok((b, 1)),))
    fn = S.make_decode_step(cfg, mesh=mesh, serve_params=serve_params)
    return analyze(fn, model, tokens, positions, cache)


def _tracked(run) -> tuple[dict, int]:
    """``run()`` (which returns ``analyze``'s dict) under a fake tensor
    mode: (its counts, the peak bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        cost = run()
    cost.pop("out", None)
    return cost, int(cost.pop("peak_bytes"))


def _measure(record: dict, run, t0: float) -> dict:
    """Fill the record from ``run()`` (see :func:`_tracked`)."""
    cost, peak_bytes = _tracked(run) if callable(run) else run
    peak_bytes += record["arg_bytes_per_chip"]["total"]
    record.update(
        status="ok",
        seconds=round(time.perf_counter() - t0, 1),
        peak_bytes_per_chip=int(peak_bytes),
        flops_per_chip=cost["flops"],
        traffic_bytes_per_chip=cost["traffic_bytes"],
        collectives_per_chip=cost["collectives"],
        collective_calls_per_chip=cost["collective_calls"],
        collective_link_bytes_per_chip=cost["collective_link_bytes"],
    )
    record["fits"] = bool(peak_bytes <= H100_SXM.hbm_bytes)
    return record


@contextlib.contextmanager
def _budget(seconds: int):
    """Raise TimeoutError in the block after ``seconds``: a cell past its
    budget is recorded as an error, not left running."""

    def stop(signum, frame):
        raise TimeoutError(f"the cell ran past its {seconds} s budget")

    previous = signal.signal(signal.SIGALRM, stop)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def _write(out_path: Path, record: dict) -> dict:
    out_path.write_text(json.dumps(record, indent=1))
    return record


def run_ising_fleet(multi_pod: bool, out_dir: Path) -> dict:
    """The paper's workload at datacenter scale: documents over (pod,
    data), replicas over model, through ``distributed.fleet.fleet_solve``."""
    from repro_torch import prng
    from repro_torch.distributed.fleet import fleet_solve

    tag = f"ising-fleet__solve__{'multi' if multi_pod else 'single'}"
    out_path = out_dir / f"{tag}.json"
    if out_path.exists():
        return json.loads(out_path.read_text())
    record = {"arch": "ising-fleet", "shape": "solve",
              "mesh": "2x16x16" if multi_pod else "16x16", "workload": dict(FLEET)}
    try:
        fake_group(multi_pod)
        mesh = make_production_mesh(multi_pod=multi_pod)
        d, r, n = FLEET["docs"], FLEET["replicas"], FLEET["spins"]
        model = shd.axis_sizes(mesh)["model"]
        d_l, r_l = d // shd.dp_size(mesh), r // model
        record["chips"] = math.prod(mesh.shape)
        record["arg_bytes_per_chip"] = {
            "h": 4 * d_l * n, "j": 4 * d_l * n * n, "phi0": 4 * d_l * r_l * n,
            "total": 4 * d_l * n * (1 + n + r_l)}
        key = prng.key(0)

        def run(steps):
            from repro_torch.analysis.cost import analyze

            h = torch.zeros((d, n), dtype=torch.float32)
            j = torch.zeros((d, n, n), dtype=torch.float32)
            return analyze(fleet_solve, mesh, h, j, key, replicas_per_device=r_l, steps=steps)

        t0 = time.perf_counter()
        (c1, p1), (c2, p2) = _tracked(lambda: run(1)), _tracked(lambda: run(2))
        t = FLEET["steps"]

        def carry(a, b):  # affine in the step count: a + (t - 1) (b - a)
            if isinstance(a, dict):
                return {k: carry(a[k], b[k]) for k in a}
            return a + (t - 1) * (b - a)

        record["counted_steps"] = [1, 2]
        _measure(record, (carry(c1, c2), max(p1, p2)), t0)
    except Exception as e:  # a failure is recorded: it is a fault to fix
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    return _write(out_path, record)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path, *,
             overrides: dict | None = None, serve_params: bool = False, variant: str = "",
             opt_cfg=None) -> dict:
    tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
    if variant:
        tag += f"__{variant}"
    out_path = out_dir / f"{tag}.json"
    if out_path.exists():
        return json.loads(out_path.read_text())
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cell = next(c for c in SHAPES if c.name == shape_name)
    record = {"arch": arch, "shape": shape_name, "variant": variant,
              "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, why = shape_applicable(cfg, cell)
    if not ok:
        record.update(status="skipped", reason=why)
        return _write(out_path, record)
    opt_cfg = opt_cfg or OptConfig()
    try:
        fake_group(multi_pod)
        mesh = make_production_mesh(multi_pod=multi_pod)
        record["chips"] = math.prod(mesh.shape)
        record["arg_bytes_per_chip"] = arg_bytes(cfg, cell, mesh, serve_params=serve_params,
                                                 opt_cfg=opt_cfg)
        with _budget(CELL_BUDGET_S):
            _measure(record, lambda: _run_step(cfg, cell, mesh, serve_params, opt_cfg),
                     time.perf_counter())
    except Exception as e:  # a failure is recorded: it is a fault to fix
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    return _write(out_path, record)


def _parse_overrides(s: str) -> dict:
    out = {}
    for kv in s.split(","):
        if not kv:
            continue
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            out[k] = v == "True"
        elif v == "None":
            out[k] = None
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def _line(rec: dict) -> str:
    status = rec.get("status")
    extra = ""
    if status == "ok":
        extra = (f"args={rec['arg_bytes_per_chip']['total'] / 1e9:.3f}GB "
                 f"peak={rec['peak_bytes_per_chip'] / 1e9:.3f}GB fits={rec['fits']} "
                 f"flops={rec['flops_per_chip']:.4g} "
                 f"coll={sum(rec['collectives_per_chip'].values()):.4g}B "
                 f"{rec['seconds']}s")
    elif status == "error":
        extra = rec.get("error", "")[:160]
    elif status == "skipped":
        extra = rec.get("reason", "")
    return f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}: {status} {extra}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--variant", default="", help="tag for optimized configs")
    ap.add_argument("--override", default="", help="cfg overrides k=v,k=v")
    ap.add_argument("--serve-tp-only", action="store_true",
                    help="TP-only weights for prefill/decode (no FSDP factor)")
    ap.add_argument("--opt-state-dtype", default="float32",
                    help="optimizer state dtype (bfloat16 -> SR rounding)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.arch == "ising-fleet":
        for multi in meshes:
            print(_line(run_ising_fleet(multi, out_dir)), flush=True)
        return
    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    if any(a not in REGISTRY for a in archs):
        raise SystemExit(f"unknown arch {args.arch!r}")
    shapes = [c.name for c in SHAPES] if args.shape == "all" else [args.shape]
    overrides = _parse_overrides(args.override)
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, multi, out_dir, overrides=overrides,
                               serve_params=args.serve_tp_only, variant=args.variant,
                               opt_cfg=OptConfig(state_dtype=args.opt_state_dtype))
                print(_line(rec), flush=True)


if __name__ == "__main__":
    main()
