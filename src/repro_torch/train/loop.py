"""Fault-tolerant training loop: checkpoint and restart, preemption-safe,
straggler-aware: the twin of ``repro.train.loop``.

  * Restart from the latest checkpoint is the recovery primitive: the loop
    begins by probing the checkpoint dir and resumes exactly (the data
    pipeline is index-based, so step -> batch is pure).
  * ``failure_at_step`` simulates a mid-run crash for tests and examples.
  * Straggler watch: each step's wall time feeds an EWMA; steps slower than
    ``straggler_factor`` x the EWMA are counted and logged.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

from repro_torch.models.common import leaf_parts, tree_items
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    failure_at_step: Optional[int] = None  # simulate preemption (tests)


class PreemptionError(RuntimeError):
    pass


def train(
    cfg,
    train_step: Callable,
    params,
    opt_state,
    data,
    loop: LoopConfig,
    *,
    log: Callable[[str], None] = print,
) -> tuple:
    """Runs or resumes training: (params, opt_state, history).  ``params``
    is the model, ``train_step(model, opt_state, batch)`` a step of
    ``launch.steps.make_train_step``; a resume restores onto the device of
    the optimizer state and copies the weights into the model."""
    ckpt_dir = Path(loop.ckpt_dir)
    start = 0
    latest = ckpt.latest_step(ckpt_dir)
    if latest is not None:
        device = leaf_parts(tree_items(opt_state["master"])[0][1])[0].device
        state = ckpt.restore(ckpt_dir, latest, {"params": params, "opt": opt_state}, cfg=cfg,
                             device=device)
        params, opt_state = ckpt.load_params(params, state["params"]), state["opt"]
        start = latest
        log(f"[loop] resumed from step {latest}")

    history = []
    ewma = None
    stragglers = 0
    step = start
    try:
        for step in range(start, loop.total_steps):
            if loop.failure_at_step is not None and step == loop.failure_at_step:
                raise PreemptionError(f"simulated node failure at step {step}")
            t0 = time.perf_counter()
            batch = data.batch(step)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > loop.straggler_factor * ewma and step > start + 3:
                stragglers += 1
                log(f"[loop] straggler step {step}: {dt:.2f}s vs ewma {ewma:.2f}s")
            history.append({"step": step + 1, "loss": loss, "sec": dt})
            if (step + 1) % loop.log_every == 0:
                log(f"[loop] step {step + 1} loss {loss:.4f} ({dt:.2f}s/step)")
            if (step + 1) % loop.ckpt_every == 0 or step + 1 == loop.total_steps:
                ckpt.save(
                    ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                    cfg=cfg, keep=loop.keep,
                )
    finally:
        if history:
            log(
                f"[loop] {len(history)} steps, final loss {history[-1]['loss']:.4f}, "
                f"stragglers {stragglers}"
            )
    return params, opt_state, history
