"""The sharded train step of the model families on four gloo ranks (DP 2 x
TP 2) against one rank, on the CPU: the MoE (routing and dispatch row by
row), the Mamba2 hybrid (its scan row by row), xLSTM (the cells row by
row), the encoder-decoder (the non-causal encoder's attention) and the VLM
(gated cross-attention over a frontend), each at its reduced width, two microbatches of two rows.

Two steps from the same weights and batch: the losses and the global
gradient norms (every gradient's square summed, so a gradient placed
wrong shows) within 2e-3 (rtol = atol, the reference's bar for its
4-device run, tests/test_distributed.py) of the unsharded step's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import init_params
from repro_torch.train import optimizer as opt

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_distributed import TOL, run_ranks  # noqa: E402

ARCHS = ("qwen2-moe-a2.7b", "zamba2-2.7b", "xlstm-1.3b", "whisper-medium",
         "llama-3.2-vision-11b")

WORKER = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh as tmesh, steps as S
from repro_torch.models import init_params
from repro_torch.train import optimizer as opt
work = json.loads(open(work).read())
mesh = tmesh.make_mesh((2, 2), ("data", "model"))
out = {}
for arch in work["archs"]:
    cfg = get_config(arch).reduced().replace(microbatch=2)
    batch = dict(np.load(work["batches"] + arch + ".npz"))
    model = init_params(cfg, 0, device="cpu")
    ocfg = opt.OptConfig(warmup_steps=0, peak_lr=1e-3)
    state = opt.init(model, ocfg)
    step = S.make_train_step(cfg, ocfg, mesh=mesh)
    metrics = [step(model, state, batch)[2] for _ in range(2)]
    out[arch] = [[float(m["loss"]), float(m["grad_norm"])] for m in metrics]
if rank == 0:
    open(work["out"], "w").write(json.dumps(out))
dist.destroy_process_group()
"""


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "targets": tokens}
    if cfg.n_frontend_tokens:
        batch["frontend"] = rng.standard_normal(
            (4, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def test_sharded_train_steps_of_the_families_match_one_rank(tmp_path):
    want = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch).reduced().replace(microbatch=2)
        batch = _batch(cfg, i)
        np.savez(tmp_path / f"{arch}.npz", **batch)
        model = init_params(cfg, 0, device="cpu")
        ocfg = opt.OptConfig(warmup_steps=0, peak_lr=1e-3)
        state = opt.init(model, ocfg)
        step = tsteps.make_train_step(cfg, ocfg)
        want[arch] = [[float(m["loss"]), float(m["grad_norm"])]
                      for m in (step(model, state, batch)[2] for _ in range(2))]
    got = run_ranks(WORKER, 4, tmp_path, {"archs": list(ARCHS),
                                          "batches": str(tmp_path) + "/"})
    for arch in ARCHS:
        np.testing.assert_allclose(got[arch], want[arch], rtol=TOL, atol=TOL, err_msg=arch)
