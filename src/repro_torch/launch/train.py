"""Training launcher: the twin of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 100 --ckpt-dir /path/to/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 4 --ckpt-every 2 --device cpu

Runs on ``--device`` (default ``cuda``, the card; ``cpu`` runs the plain
versions).  Resume is automatic: the loop probes the checkpoint dir
(restart-from-latest is the recovery path).  The checkpoint dir defaults to
``repro_torch_ckpt`` under the temp dir.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTextTask
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized smoke variant of the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_host_mesh(args.device)
    params = init_params(cfg, 0, device=mesh.device)
    opt_cfg = opt.OptConfig(peak_lr=args.lr, total_steps=args.steps)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt_cfg, mesh=mesh)
    data = SyntheticTextTask(
        DataConfig(batch_size=args.batch, seq_len=args.seq), cfg.vocab_size
    )
    loop = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir)
    train(cfg, step, params, opt_state, data, loop)


if __name__ == "__main__":
    main()
