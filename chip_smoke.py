#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--save-embeddings PATH]

Phases, each of which must pass or the script exits non-zero:

  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 off for matmuls and cuDNN, and bf16 GEMMs summed in float32
     (no reduced-precision reductions);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, started together) and print the build seconds; count the
     HGMMA (wgmma) instructions and the HMMA instructions on TF32 operands
     (the split-TF32 kernel's mma.sync) of the flash library's SASS with
     cuobjdump (none of either fails);
  3. hold every kernel against its plain PyTorch version on the card, at the
     main path's shapes (8 reads, 128 padded lanes) and at 1024 reads
     (many replica blocks, so the cross-block first-argmin is exercised);
     the COBI anneal loop's cases: live extents 4, 20, 33, 100, 127 and 128
     on 128 lanes, an all-zero row and column inside n, a non-symmetric J,
     R 8 / 64 / 1024, N 256 and 1024 (J in global memory), each within
     TRAJ_TOL of its plain version at 50 steps, with readout == sign of the
     trajectory, exact energies and fused == readout + first argmin bitwise;
     and a packed bin with jobs at lane offsets 3, 21 and 77, each equal to
     its solo anneal bit for bit;
  3b. the chip farm's batched kernels against their plain versions on packed
     bins of the 16-document mix: the batched trajectory at 50 steps; at 400
     steps the fused batched best against the batched trajectory + sign +
     stacked energies + first argmin, and against each job's solo fused
     best from the same phases; one bin of 100 one-spin jobs (S = 100);
  3e. the energy kernel (the live extent, operands read in place) against
     its plain version bit for bit on chip-range integer instances: n 1, 7,
     20, 59, 128, 129, 200 and 1024 lanes x R 1, 8, 17, 256 and 1024, B 3
     and 1, int8 and float32 spins, the live corner of zero-padded operands
     read at its strides; on non-integer instances against the COBI readout
     epilogue's energies bit for bit, and the tile-aligned twin against the
     unpadded call; one ``ops.ising_energy`` call at the main path's shape
     counted as one device launch under torch.profiler (no padding copy);
  4. the main path: a 20-sentence document through ``solve_es`` (10
     iterations x 8 reads x 400 steps), a 100-sentence document through the
     windowed decomposition, and the solver's fused ``reduce="best"`` /
     ``"topk"`` readouts of the same instances; each path with the launch
     counts set to 0 just before and read just after;
  4b. the chip farm: 16 documents of the farm benchmark's mix (m = 5,
     6 iterations x 8 reads x 400 steps) inline, then as 16 ``iter_solve_es``
     generators in lockstep through one ``CobiFarm(4)`` (``policy="manual"``,
     one drain per round), bitwise equal to inline; the 100-sentence
     document through ``solve_es(backend=CobiFarm(4))`` with pipelined
     windows, equal to its inline decomposed run; the 16 documents again
     under ``policy="bin-full"``, equal to ``manual``; and their 96 rounded
     instances through ``solve_batch(reduce="none")``, the two-launch drain,
     whose first argmins equal the fused winners.  Launch counts are held
     against what the drains imply.  The farm submit split times the
     roundings as ``_submit_iterations`` makes them (one
     ``quantize_ising_many`` a document) beside one call per key, holds the
     two equal, and counts the host syncs of one batched call under
     ``torch.cuda.set_sync_debug_mode("warn")`` (more than one fails);
  3c. the MCMC kernels against their plain versions, bitwise (spins and
     energies), and the fused best against the sweep kernel + first argmin:
     both proposal modes, B = 3 instances, R = 16 over replica blocks of 8
     and 16, chunks of 32, 64 and 128, the fused best over the first 3
     reads, float-normal and chip-integer instances, and one 200-spin
     instance (256 lanes); then live extents 1, 31, 32, 33, 64, 65 and 128
     in both modes, a batch of extents 7 / 45 / 100, a zero row and column,
     1000 spins on 1024 lanes (J from global memory), R 8 / 64 / 1024 with
     replica blocks 8 / 32 / 256; and one fused call at R 8 counted as one
     device launch under torch.profiler;
  4c. the MCMC family on the main path: the 20-sentence document through
     ``solve_es(SolveConfig(solver="mcmc"))`` (10 iterations x 8 reads x 50
     sweeps) inline and through ``McmcPoolBackend(4)``; the 100-sentence
     document decomposed, inline and through the bank; the farm mix's 16
     documents inline and through the bank; each pair bitwise equal, with
     launch counts, wall times and receipt totals;
  3d. the flash-attention kernels against their plain version (f32 within
     2e-5, bf16 within 1.6e-2) and against the naive oracle (2e-3 / 3e-2):
     causal and full, window 64, GQA 2:1 and 4:1, MQA, Sq < Skv, Skv 64,
     Sq > Skv (against the plain version only: rows with no real key), D 16
     to 128, S 64 to 2048, the encoder stage's (8, 2048) and (4, 1024)
     buckets, and the stage's and qwen2-moe's 2048 calls in float32; each
     case prints the route it took, and a bf16 case at D 64 or 128 that did
     not take wgmma, or any other case that did not take the split-TF32
     kernel, fails;
  4d. the encoder backbone: sbert-paper at full width (bf16, 12 layers,
     random weights from init_params(seed 0)) in an ``EncoderStage`` with
     ``attn_impl="flash"``, the direct document and the farm mix's nine
     documents that fit 2048 byte tokens submitted at once (two buckets);
     12 flash launches per stage launch, none for "sdpa" and "auto"; flash
     against sdpa and auto (cosine >= 0.999); the direct document bit for
     bit against itself alone in a padded batch of the same shape; each
     path's embeddings through ``solve_es`` (``SolveConfig()``), the flash
     path's summaries within 0.05 of the plain versions' on the CPU and the
     direct document's above 0.8 normalized; ``BackboneEncoder`` on the
     direct document against the stage's row; the query cache's hit;
     ``--save-embeddings PATH`` writes the flash path's embeddings of the
     direct document and farm1 to an .npz (the CPU tests' card fixture);
  4e. where the encode time goes: in five paired rounds, a fresh
     prewarmed stage's first drain of each bucket against that pass warm
     on the main thread after the stage's linger of idle, each timed to a
     synchronise (median ratio within 1.5x; the stages' embeddings
     bit-identical), and the 2048 bucket's pass under torch.profiler,
     its device time split into flash (by kernel name, both routes),
     GEMMs and the rest, and the device's idle share;
  4f. the serving engine, the system's front door: ``python -m
     repro_torch.launch.serve --requests 8 --workload mixed`` in a
     subprocess (exit 0); ``SummarizationEngine(SolveConfig(iterations=6),
     n_chips=4, seed=0, score_against_exact=True)`` on the farm mix's 16
     documents and the 100-sentence document (m 6, decomposed), every
     response bit for bit equal to its inline ``solve_es`` keyed
     ``fold_in(key(0), request_id)``, the decomposed one above 0.8
     normalized against its Tabu bounds; then 20 batches of the same 17,
     warm and unscored, one after another, for requests/s and p50/p99
     latency over all 340 (each response equal to the scored one); the
     MCMC engine on the 16 documents, each equal to its inline solve; the
     16 documents routed with ``benchmarks/CALIBRATION_cobi_pool.json``
     under a deadline that spills onto the host pool, each response equal
     to the farm's, with ``backend_used`` counts; Tabu and SA on the direct
     document, 3 iterations, the card against the CPU on the same rounded
     instances and through ``solve_es`` (Tabu bit for bit), their time a
     solve, and the ``reference_bounds`` Tabu fallback at N 100, M 6;
  4g. the other model families (``families_phase``): qwen2-moe-a2.7b at
     full width and depth (bf16, random weights from init_params(seed 0))
     in ``EncoderStage(max_len=2048)`` on 4d's ten documents under flash,
     sdpa and auto (24 flash launches a pass under flash, cosine >= 0.999,
     the direct document bit for bit alone in a padded batch, its summary
     above 0.8 normalized, the router aux, a torch.profiler split of the
     2048 pass); zamba2-2.7b, xlstm-1.3b, whisper-medium and
     llama-3.2-vision-11b at full width and depth, and mixtral-8x22b at
     full width cut to 2 layers, through ``embed_sentences`` (stub
     frontends), flash against sdpa; and all six at full width, float32,
     one group, the card against the CPU (2e-4, router choices equal);
  4h. prefill and decode (``decode_phase``): tinyllama-1.1b at full width
     and depth (bf16) through ``make_prefill_step`` (B 8 x 2,048 byte
     tokens) and 256 greedy ``make_decode_step`` steps from
     ``init_cache(cfg, 8, 2304)``: prefill wall and tokens/s, ms a step
     (median, p99), tokens/s, a step's and a prefill's launches, host
     syncs, idle share and split, the cache's bytes, peak memory and the
     bounds, held against the
     teacher-forced forward (greedy == its argmax where its top-2 gap
     exceeds twice the logit error); mixtral-8x22b at full width cut to 2
     layers, a prefill of 5,120 past its 4,096 window (the ring) and 64
     steps, the same check at the MoE bar 0.5; no kernel of the port
     launches on either (flash is train-only); every registered config at
     full width in float32, one group, prefill 256 and 8 steps, the card
     against the CPU (logits and every cache leaf within 2e-4, pos bit for
     bit, router choices equal; xlstm also over 4 + 4 at its registered
     init, its sLSTM's cache leaves, where beyond 2e-4, held against the CPU
     with the scan in float64; xlstm's slstm_scan launches counted); then
     (``depth_phase``) xlstm-1.3b, qwen2-moe-a2.7b, zamba2-2.7b,
     whisper-medium, llama-3.2-vision-11b and gemma-2b at full width and
     depth in bf16, B 4 x 1,024 byte tokens and 64 greedy steps each, with
     tinyllama's lines and check (qwen2-moe at the MoE bar, its dropped
     choices counted and its decode's experts against the teacher pass's;
     xlstm's check at the registered init over SLSTM_STEPS, over the full
     length with r at fan-in dh) and a "decode depth summary" line each;
  4i. training (``train_phase``): tinyllama-1.1b at full width and depth
     (bf16, remat, microbatch 2, float32 AdamW state) through ``train()``
     and ``make_train_step`` on B 8 x 2,048 byte tokens for 6 steps, saved
     once to a temporary directory and restored bit for bit: ms a step,
     tokens/s, peak memory, checkpoint bytes and seconds, one step's
     launches, host syncs, idle share and split (chunked attention forward
     and backward, optimizer, GEMMs, the rest) beside the bound; FIXED_STEPS steps on
     one batch, the loss falling; no kernel of the port launches (flash is
     not on the train path, and raises under grad); every registered config
     at full width in float32, one group, B 2 x 128, loss and every gradient
     card against CPU within 2e-4 (xlstm as in 4g), tinyllama's train step
     on both; ``python -m repro_torch.launch.train --reduced`` in a
     subprocess and a crash at step 4 resumed against straight runs; the
     Ising fleet step (``make_ising_solve_step``: the batched trajectory and
     energy kernels, one launch each) at D 256 x R 32 x N 64 x 1,000 steps,
     energies exact, against its plain versions;
  4i (2). training at full depth (``train_depth_phase``): (a) the paper's
     encoder (sbert-paper, unreduced) trained as ``examples/train_tiny_lm.py
     --full`` trains it, 200 ``train()`` steps of B 8 x 128 with a
     checkpoint every 50, the last restored into a fresh model bit for bit,
     then used as the summarizer's embedder (``BackboneEncoder`` ->
     ``solve_es(solver="cobi")`` on the card, above 0.8 against exact
     enumeration) and in ``EncoderStage(attn_impl="flash")`` against the
     chunked route (cosine >= 0.999); (b) whisper-medium, zamba2-2.7b,
     gemma-2b and xlstm-1.3b at full width and depth (bf16, B 8 x 2,048,
     the registered microbatch and remat; xlstm with r at fan-in dh and
     SR-rounded bf16 AdamW state), each checked part by part against central
     differences in float32, remat on against off, its first loss against
     the serving forward's cross-entropy, then FIXED_STEPS steps on
     one batch (the loss falling), timed, profiled, its peak beside the
     reckoning, bounded, a "train depth summary" line each; xlstm's sLSTM
     launches counted;
  4j. the mesh and distributed layer (``distributed_phase``) on a one-rank
     NCCL group and a 1 x 1 ``DeviceMesh``: ``fleet_solve`` on one rank's
     shard of the dry run's 16 x 16 fleet cell (D 256 x R 32 x N 64 x 1,000
     steps, 4i's instances) bit for bit against ``make_ising_solve_step``,
     its two launches and its collectives counted; one sharded
     ``make_train_step(mesh=...)`` step of tinyllama-1.1b at B 8 x 2,048
     against the unsharded step (loss within 1e-3), ms and launches beside
     it; ``python -m repro_torch.launch.dryrun`` for tinyllama-1.1b x
     train_4k and the ising-fleet cell in subprocesses, their records ok;
  4k. the sLSTM scan (``slstm_phase``, ``csrc/slstm_scan.cu``): at
     xlstm-1.3b's call (B 2, S 2,048, D 2,048, 4 heads, float32) the
     forward kernel against ``slstm_scan_plain`` over the first
     SLSTM_STEPS steps at the registered init and over every step with r
     at fan-in dh (2e-5), and at the decode launch (B 4, S 1, from a
     nonzero state), the backward kernel against
     ``slstm_scan_backward_plain`` at B 2 x S 256 and S 2,048 (d_wx, d_r, d_bias within
     1e-4 of their largest magnitude, two launches equal bit for bit; and
     at B 40 x S 8, where a cell thread takes more than one row), both
     kernels' ms, plain ms, bounds, microseconds a step, each phase of a
     step (the timed instances: exchange wait, products, reduction,
     barrier, gates, publish; the backward's cell gradient, publish,
     exchange wait, products, reduction, barrier), ptxas's registers and
     spills (a spill fails), and the exchange's own cost a step (the chain
     floor: S rounds of publish and gather with no arithmetic); ``python
     -m repro_torch.launch.dryrun --arch xlstm-1.3b`` for train_4k and
     prefill_32k (``--mesh single``), started in subprocesses before phase
     3, their ``ok`` records.  The
     kernels' main-path launches are 4g's xlstm passes (one a layer, and a
     torch.profiler count of the pass's device kernels), 4h's xlstm decode
     checks and full-depth decode (one a layer for the prefill and for each
     step) and 4i's xlstm
     gradient checks (the forward twice under remat, the backward once);
     "sLSTM phase wall" closes it;
  4l. the router's calibration (``calibration_phase``,
     ``launch/calibrate.py``): the full cobi-pool fit and the full mcmc fit
     (Tabu pool) on the card, each with its warm-up seconds, medians,
     coefficients, each pool's predictions at n 10, 20, 40 and 59 beside
     the checked-in reference profile's and the checked-in card profile's
     (``src/repro_torch/serving/profiles/``), every model's knots and its JSON
     on one line (a finite prediction at every n in 2-59 and the save's
     round trip, or it fails); the tiny mcmc fit on the card and on the
     CPU (Tabu and mcmc knots equal, the farm's COBI curves within 0.05);
     4f's routed run (the reference profile) beside the same requests
     routed with the card's cobi-pool profile at a deadline derived from
     its predictions through the engine's own admission and router
     (``spill_deadline``): ``backend_used`` as predicted with a spill,
     ``router.stats()``, each backend's ``ewma_latency``, every response
     equal to the farm's; "calibration phase wall" closes it;
  5. time every kernel, its plain version and its bound (at the padded
     shapes the reference's kernels take, and at the instances' own n spins
     and reads; a COBI anneal row's bound_ms is the latter, since its loop
     skips the lanes past the live extent, an MCMC row's too (it anneals the
     instance's own spins), and the energy row's (it is handed them));
     the energy kernel as the main path calls it (int8 spins, R = 8, the
     instance's 20 lanes) through ``ops.ising_energy`` and from its C entry,
     its tile-aligned twin at (8, 128), and the launch floor (the C entry at
     R = 1, n = 1); the batched kernels at the 16-document drain's shape;
     the MCMC kernels
     at the main path's shape (B = 1, R = 8, 128 lanes, 50 sweeps) through
     their wrappers and from their C entries, and at 1024 reads; the
     flash kernel at the stage's buckets (bf16, wgmma) beside one SDPA call
     as its yardstick, with each one's achieved TFLOP/s, and at qwen2-moe's
     and zamba2's calls beside SDPA; its float32 route (the split-TF32
     kernel) at the stage's 2048 bucket and qwen2-moe's call in float32,
     beside its plain version, SDPA in float32 pinned to
     EFFICIENT_ATTENTION (its kernels by name and its own error against the
     plain version), the CUDA-core bound and the split-TF32 bound;
  6. print the ``kernels`` JSON line (thirteen rows: the ten ports of the
     reference's ``pallas_call`` kernels, the flash kernel's as two rows,
     one a route, and the two sLSTM scan kernels, which replace its
     ``lax.scan``), the card line, and last the result line.

It imports nothing of JAX and nothing of the JAX package ``repro``.  Without
a CUDA device, or without the repository around it, it fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.hardware import H100_SXM  # noqa: E402  (no torch import)

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): float32 outside the
# tensor cores, bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = H100_SXM.peak_f32_flops
PEAK_BF16_FLOPS = H100_SXM.peak_bf16_flops
PEAK_TF32_FLOPS = H100_SXM.peak_tf32_flops
PEAK_BYTES_PER_S = H100_SXM.hbm_bandwidth

STEPS, READS, ITERATIONS = 400, 8, 10
TRAJ_TOL = 2e-4  # rtol = atol at 50 steps: the reference's kernel-vs-oracle bound
# The farm benchmark's document mix (benchmarks/farm_throughput.py SIZES):
# synthetic_document(100 + i, n), m = 5, lambda = 0.5, 6 iterations.
FARM_SIZES = [10, 14, 18, 22, 26, 30, 34, 38, 12, 16, 20, 24, 28, 32, 36, 40]
FARM_ITERATIONS = 6
ENCODER_MAX_SIZE = 26  # the farm mix's documents that fit 2048 byte tokens
ENCODER_LINGER = 0.05  # seconds the stage waits to batch after a first job
# The routed serve run: every farm-mix request carries this deadline (sim
# seconds), so the farm's admitted queue outgrows it after about 15
# requests and the router spills onto the host pool (one request, with the
# checked-in cobi_pool profile at 400 steps).
ROUTE_DEADLINE = 0.03
# Iterations of the host solvers' card-against-CPU check (Tabu and SA are
# host-bound loops: tools/solver_profile.py times them).
HOST_SOLVER_ITERATIONS = 3
# Batches of the 17 requests in the timed serve window: a rate and a p99
# over some hundreds of requests.
SERVE_WINDOW = 20
MCMC_SWEEPS = 50  # SolveConfig's 400 steps at 8 steps a sweep
# xlstm's sLSTM at full width doubles a rounding difference about every
# step (phase 4g): the card and the CPU agree within 2e-4 over this many.
SLSTM_STEPS = 4
# SolveConfig(solver="mcmc") on synthetic_document(7, 20), m = 6, key 0:
# the JAX package's selection on the CPU.
MCMC_DIRECT_SELECTION = [1, 4, 8, 9, 10, 12]
# Phase 4h (decode): tinyllama's B 8 prompts of 2,048 byte tokens and 256
# greedy steps; mixtral's prefill past its 4,096 window and 64 steps; the
# card-against-CPU prefill and steps of every config.
DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS = 8, 2048, 256
RING_PROMPT, RING_STEPS = 5120, 64
PARITY_PROMPT, PARITY_STEPS = 256, 8
# Phase 4h (4): the families that fit one card in bf16, at full width and
# depth: B 4 prompts of 1,024 byte tokens, then 64 greedy steps.
DEPTH_FAMILIES = ("xlstm-1.3b", "qwen2-moe-a2.7b", "zamba2-2.7b", "whisper-medium",
                  "llama-3.2-vision-11b", "gemma-2b")
DEPTH_BATCH, DEPTH_PROMPT, DEPTH_STEPS = 4, 1024, 64
# Phase 4i (train): tinyllama's steps of B 8 x 2,048 tokens through train()
# and the fixed-batch run; the card-against-CPU gradients at B 2 x 128; the
# Ising fleet step at one card's shard of the reference's ising-fleet cell
# (D 4096 x R 512 x N 64 x 1,000 steps over a 16 x 16 mesh:
# src/repro/launch/dryrun.py), and its check against the plain versions.
# FIXED_STEPS: the fixed-batch runs, tinyllama's here and each family's in
# 4i (2) (timed there), kept short for the script's time limit: zamba2-2.7b
# and xlstm-1.3b take seconds a step.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, FIXED_STEPS = 8, 2048, 6, 4
GRAD_BATCH, GRAD_SEQ = 2, 128
FLEET_DOCS, FLEET_READS, FLEET_SPINS, FLEET_STEPS = 256, 32, 64, 1000
FLEET_CHECK_DOCS, FLEET_CHECK_STEPS = 4, 50
# Phase 4i (2) (train depth): (a) the paper's encoder trained as
# examples/train_tiny_lm.py --full trains it (sbert-paper, B 8 x 128, 200
# steps, a checkpoint every 50), used as the summarizer's embedder; (b) the
# families that fit one card, at full width and depth, FIXED_STEPS
# steps of B 8 x 2,048 on one batch each; the per-part gradient check at B 1 x
# S 256 in float32 (central differences of step DEPTH_DELTA x |loss| /
# |g_part|: a loss change of 3e-4 of the loss each way, far above
# float32's rounding of the loss and small enough that the curvature's
# error stays below 1e-3 of the slope in the reduced models), remat on
# against off at B 1 x S 512 in bf16.
ENCODER_STEPS, ENCODER_CKPT_EVERY, ENCODER_BATCH, ENCODER_SEQ = 200, 50, 8, 128
TRAIN_DEPTH_FAMILIES = ("whisper-medium", "zamba2-2.7b", "gemma-2b", "xlstm-1.3b")
# The AdamW state's type a family trains with, settled by measurement
# (PERF.md §6): xlstm-1.3b reckons 71.5 GB of weights, float32
# accumulator, gradients and float32 state, and its step ran out of memory
# in its backward on an NVIDIA H100 80GB HBM3 (700.00 W); with the
# reference's SR-rounded bf16 state it reckons 50.1 GB.  The others keep
# float32.
TRAIN_DEPTH_STATE = {"whisper-medium": "float32", "zamba2-2.7b": "float32",
                     "gemma-2b": "float32", "xlstm-1.3b": "bfloat16"}
GRADCHECK_SEQ, REMAT_SEQ = 256, 512
DEPTH_DELTA, GRADCHECK_TOL = 3e-4, 1e-2
# Phase 4j (distributed): the sharded train step's loss against the
# unsharded step's from the same weights and batch.
SHARDED_LOSS_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card (CUDA events around ``reps``)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call under torch.profiler (CUPTI): the kernels'
    own time, where back-to-back calls of a short kernel measure the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / reps / 1e3


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def work(name: str, r: int, n: int, s: int, spin_bytes: int = 4) -> tuple[float, float]:
    """(FLOP, bytes) of one call of kernel ``name`` on r reads, n lanes and
    s slots at STEPS steps: each input read once, each output written once.
    The anneal counts the stacked [cos; sin] @ J product; sin/cos and the
    elementwise update are not counted.  The energy kernel's spins count at
    ``spin_bytes`` a spin, the type it reads (1 for int8).  A batched
    kernel's work is the sum of its instances' (:func:`batched_work`)."""
    f32 = 4
    anneal = STEPS * 2 * (2 * r) * n * n
    score = 2 * r * n * n + 4 * r * n
    return {
        "cobi_trajectory": (anneal, f32 * (n * n + n + 2 * r * n)),
        "ising_energy": (score, spin_bytes * r * n + f32 * (n + n * n + r)),
        "cobi_fused_best": (anneal + score + 2 * r * n * s,
                            f32 * (2 * n * n + 2 * n + n * s + s + r * n + s + s * n)),
        "cobi_readout": (anneal + score, f32 * (2 * n * n + 2 * n + 2 * r * n + r)),
    }[name.removesuffix("_batched")]


def mcmc_work(name: str, r: int, n: int, proposals: int, sweeps: int) -> tuple[float, float]:
    """(FLOP, bytes) of one MCMC launch on r replicas of n lanes with
    ``proposals`` live proposals a sweep: a rank-1 field update (2 r n) per
    proposal plus f0 = s0 J (2 r n n); J, h and s0 read once, the outputs
    (every replica's energy and spins, or the winner's) written once."""
    flops = sweeps * proposals * 2 * r * n + 2 * r * n * n
    out = r + r * n if name == "mcmc_sweep_batched" else 1 + n
    return flops, 4 * (n * n + n + r * n + out)


def batched_work(name: str, shapes) -> tuple[float, float]:
    """(FLOP, bytes) of one batched call over instances of (r, n, s) shapes."""
    flops, nbytes = zip(*(work(name, r, n, s) for r, n, s in shapes))
    return sum(flops), sum(nbytes)


def packed_operands(instances, keys, reads, dev):
    """The operands one fused farm drain hands the batched kernels, built as
    ``CobiFarm._run_group`` / ``_execute_fused`` build them: best-fit packed
    128-lane bins, each job's phases from its own key at lane offset, bins
    padded to the batch bucket and slots to a multiple of 8.  Returns
    (operands dict of (B, ...) tensors, [(bin, slot index, Slot)])."""
    import torch

    from repro_torch import prng
    from repro_torch.farm import pack_instances
    from repro_torch.farm.scheduler import _batch_pad
    from repro_torch.kernels import ops

    bins = pack_instances(list(enumerate(instances)), 128)
    b_pad = _batch_pad(len(bins))
    s_pad = -(-max(len(b.slots) for b in bins) // ops.SLOT_PAD) * ops.SLOT_PAD
    z = lambda *shape: np.zeros(shape, np.float32)
    jp, hp, ju, hu = z(b_pad, 128, 128), z(b_pad, 128), z(b_pad, 128, 128), z(b_pad, 128)
    mask, rd, phi0 = z(b_pad, 128, s_pad), z(b_pad, s_pad), z(b_pad, reads, 128)
    slots = []
    for b, inst in enumerate(bins):
        jp[b], hp[b], ju[b], hu[b] = inst.j_scaled, inst.h_scaled, inst.j_orig, inst.h_orig
        for si, slot in enumerate(inst.slots):
            lanes = slice(slot.offset, slot.offset + slot.n)
            mask[b, lanes, si] = 1.0
            rd[b, si] = reads
            phi0[b, :, lanes] = prng.uniform(
                keys[slot.job_id], (reads, 128), 0.0, 2.0 * math.pi, device="cpu"
            ).numpy()[:, : slot.n]
            slots.append((b, si, slot))
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"j": t(jp), "h": t(hp[:, None]), "ju": t(ju), "hu": t(hu[:, None]),
            "mask": t(mask), "reads": t(rd[:, None]), "phi0": t(phi0)}, slots


def percentile(xs, q: float) -> float:
    """The q-quantile of xs by linear interpolation (numpy's default)."""
    return float(np.percentile(np.asarray(xs, np.float64), 100 * q))


def serve_phase(dev, reset_counts, counts, launches, problem, key) -> None:
    """Phase 4f: the serving engine end to end on the card.

    (1) The serve launcher as a user runs it, in a subprocess: 8 requests
    of the mixed workload, exit 0.  (2) ``SummarizationEngine`` (6
    iterations, ``CobiFarm(4)``, seed 0, scored) on the farm mix's 16
    documents (m 5) and the 100-sentence document (m 6, decomposed): every
    response equals its inline ``solve_es`` keyed ``fold_in(key(0), rid)``
    on the card, bit for bit, and the decomposed one clears the 0.8 bar
    against its Tabu bounds; then ``SERVE_WINDOW`` batches of the same
    requests, unscored and warm, one after another, for requests per second
    and latency quantiles over all of them; and the MCMC engine on the 16
    documents against its inline solves.  (3) The 16 documents routed with
    the checked-in cobi_pool profile under a deadline that spills the
    farm's queue onto the host pool: every response, spilled or not, equals
    (2)'s.  (4) Tabu and SA on the direct document, ``HOST_SOLVER_ITERATIONS``
    iterations: the card against the CPU on the same rounded instances and
    through ``solve_es`` (Tabu bit for bit), their time a solve at N 20,
    and the Tabu fallback of ``reference_bounds`` at N 100, M 6.
    """
    import torch

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize()

    from repro_torch import prng
    from repro_torch.core import SolveConfig, solve_es
    from repro_torch.core import metrics, pipeline
    from repro_torch.core.formulation import IsingProblem
    from repro_torch.data.synthetic import synthetic_document
    from repro_torch.embeddings import HashedBowEncoder
    from repro_torch.serving import AdmissionConfig, SummarizationEngine, SummarizeRequest
    from repro_torch.serving import api as serve_api
    from repro_torch.solvers import ising_solver

    # (1) the launcher
    n_req = 8
    args = ["--requests", str(n_req), "--workload", "mixed", "--device", dev.type]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        print(f"  serve: {line}")
    if run.returncode != 0:
        fail(f"python -m repro_torch.launch.serve {' '.join(args)} exited "
             f"{run.returncode}: {run.stderr[-2000:]}")
    n_resp = sum(line.startswith("req ") for line in run.stdout.splitlines())
    print(f"serve launcher ({' '.join(args)}): exit 0, {n_resp} responses, process wall "
          f"{wall:.3f} s")
    if n_resp != n_req:
        fail(f"the serve launcher answered {n_resp} of {n_req} requests")

    # (2) the engine against its inline solves
    cfg = SolveConfig(iterations=FARM_ITERATIONS)
    docs = [(synthetic_document(100 + i, n), 5) for i, n in enumerate(FARM_SIZES)]
    docs.append((synthetic_document(11, 100), 6))
    # Explicit ids 1..17: a batch served again keeps them (and so its keys).
    reqs = [SummarizeRequest(text=" ".join(d), m=m, request_id=i + 1)
            for i, (d, m) in enumerate(docs)]
    reset_counts()
    t0 = time.perf_counter()
    with SummarizationEngine(cfg, n_chips=4, seed=0, score_against_exact=True,
                             device=dev) as eng:
        served = eng.run_batch(reqs, seed=0)
        drains = eng.farm.stats().drains
    wall = time.perf_counter() - t0
    c = counts()
    for name in c:
        launches[name] += c[name]
    print(f"serve engine (17 requests, scored): wall {wall:.3f} s, {drains} drains, "
          f"launches {c}")
    if c["cobi_fused_best_batched"] == 0:
        fail("the served farm never launched cobi_fused_best_batched")
    enc = HashedBowEncoder()
    for resp, req in zip(served, reqs):
        sel = eng._to_selection(req)
        prob = serve_api.problem_from_spec(sel.kofn, sel.items, encoder=enc, device=dev)
        c_in = dataclasses.replace(cfg, decompose=prob.n > 59)
        want = solve_es(prob, prng.fold_in(prng.key(0), resp.request_id), c_in, device=dev)
        if not (np.array_equal(resp.selection, want.selection)
                and resp.objective == want.objective):
            fail(f"served request {resp.request_id} (N={prob.n}) != its inline solve: "
                 f"{resp.selection.nonzero()[0].tolist()} {resp.objective} against "
                 f"{want.selection.nonzero()[0].tolist()} {want.objective}")
        if resp.normalized is None or not math.isfinite(resp.normalized):
            fail(f"served request {resp.request_id} carries no normalized objective")
    big = served[-1]
    print(f"serve engine: all 17 responses == their inline solves (fold_in keys) bitwise; "
          f"normalized objectives min {min(r.normalized for r in served[:-1]):.6f} over the "
          f"farm mix; decomposed N=100 M=6: selected {big.selection.nonzero()[0].tolist()} "
          f"objective {big.objective:.6f} normalized {big.normalized:.6f} (Tabu bounds)")
    if big.normalized <= 0.8:
        fail(f"decomposed normalized objective {big.normalized} <= 0.8")

    # The served rate and latency: a window of SERVE_WINDOW batches of the
    # 17 requests, one after another (a client with 17 requests in flight).
    # Each batch keeps ids 1..17, so every response of the window must
    # equal the scored run's.
    reset_counts()
    with SummarizationEngine(cfg, n_chips=4, seed=0, device=dev) as eng:
        eng.run_batch(reqs, seed=0)  # warm
        window, batch_walls = [], []
        t0 = time.perf_counter()
        for _ in range(SERVE_WINDOW):
            tb = time.perf_counter()
            window.append(eng.run_batch(reqs, seed=0))
            batch_walls.append(time.perf_counter() - tb)
        wall = time.perf_counter() - t0
    c = counts()
    for name in c:
        launches[name] += c[name]
    lat = [r.wall_seconds for batch in window for r in batch]
    rates = [len(reqs) / w for w in batch_walls]
    print(f"serve engine window ({SERVE_WINDOW} batches x 17 requests, warm, unscored): "
          f"{len(lat)} requests in {wall:.4f} s, {len(lat) / wall:.3f} requests/s (batches "
          f"{min(rates):.3f} to {max(rates):.3f}), latency over all {len(lat)}: p50 "
          f"{percentile(lat, 0.5):.4f} s p99 {percentile(lat, 0.99):.4f} s max {max(lat):.4f} s "
          f"(farm mix alone p50 {percentile([r.wall_seconds for b in window for r in b[:-1]], 0.5):.4f} s), "
          f"launches {c} [{card_line()}]")
    if any(not (np.array_equal(a.selection, b.selection) and a.objective == b.objective)
           for batch in window for a, b in zip(batch, served)):
        fail("a response of the timed window differs from the scored run's")

    # (2b) the MCMC family served: the engine builds McmcPoolBackend(4)
    mcfg = SolveConfig(solver="mcmc", iterations=FARM_ITERATIONS)
    reset_counts()
    t0 = time.perf_counter()
    with SummarizationEngine(mcfg, seed=0, device=dev) as eng:
        bank = type(eng.backend).__name__
        mserved = eng.run_batch(reqs[:-1], seed=0)
    wall = time.perf_counter() - t0
    c = counts()
    for name in c:
        launches[name] += c[name]
    print(f"serve engine mcmc (16 requests through {bank}; a check, not a rate): wall "
          f"{wall:.4f} s, launches {c}")
    if bank != "McmcPoolBackend" or c["mcmc_fused_best_batched"] == 0:
        fail(f"the mcmc engine served through {bank} with launches {c}")
    for resp, req in zip(mserved, reqs):
        sel = eng._to_selection(req)
        prob = serve_api.problem_from_spec(sel.kofn, sel.items, encoder=enc, device=dev)
        want = solve_es(prob, prng.fold_in(prng.key(0), resp.request_id), mcfg, device=dev)
        if not (np.array_equal(resp.selection, want.selection)
                and resp.objective == want.objective):
            fail(f"mcmc-served request {resp.request_id} != its inline solve")
    print("serve engine mcmc: all 16 responses == their inline solves bitwise")

    # (3) routed: the farm's queue spills onto the host pool (one batch: a
    # check of the spill, not a rate)
    reset_counts()
    profile = ROOT / "benchmarks" / "CALIBRATION_cobi_pool.json"
    t0 = time.perf_counter()
    with SummarizationEngine(cfg, n_chips=4, seed=0, routing=True, profile=str(profile),
                             admission=AdmissionConfig(max_queue_depth=len(FARM_SIZES)),
                             device=dev) as eng:
        routed = eng.run_batch([dataclasses.replace(r, deadline=ROUTE_DEADLINE)
                                for r in reqs[:-1]], seed=0)
        stats = eng.router.stats()
        ewma = {name: m.ewma_latency for name, m in eng.router.profile.models.items()}
    wall = time.perf_counter() - t0
    c = counts()
    for name in c:
        launches[name] += c[name]
    used: dict = {}
    for r in routed:
        used[r.backend_used] = used.get(r.backend_used, 0) + 1
    print(f"serve routed (16 requests, deadline {ROUTE_DEADLINE} s, cobi_pool profile; a check, "
          f"not a rate): backend_used {used}, router {stats}, ewma_latency {ewma}, wall "
          f"{wall:.4f} s, launches {c}")
    if not used.get("pool"):
        fail("the routed run spilled nothing onto the pool")
    for r, s in zip(routed, served):
        if not (np.array_equal(r.selection, s.selection) and r.objective == s.objective):
            fail(f"routed request {r.request_id} (via {r.backend_used}) != its farm solve")
    print(f"serve routed: all 16 responses ({used['pool']} spilled) == the farm's bitwise")

    # (4) the host solvers on the card
    reset_counts()  # comparisons, not the main path
    ising_fp = pipeline._build_ising(problem, cfg)
    cpu_fp = pipeline._build_ising(problem.to("cpu"), cfg)
    for name in ("tabu", "sa"):
        scfg = SolveConfig(solver=name, iterations=HOST_SOLVER_ITERATIONS)
        solver = ising_solver(name)
        flips, times = [], []
        same_instances = True
        for kq, ks in pipeline._iteration_keys(key, HOST_SOLVER_ITERATIONS):
            q = pipeline._quantized_instance(ising_fp, scfg, kq)
            q_cpu = pipeline._quantized_instance(cpu_fp, scfg, kq)
            same_instances &= bool(torch.equal(q.h.cpu(), q_cpu.h) and torch.equal(q.j.cpu(), q_cpu.j))
            sync()
            t0 = time.perf_counter()
            got = solver(q, ks, reads=READS)
            sync()
            times.append(time.perf_counter() - t0)
            want = solver(IsingProblem(h=q.h.cpu(), j=q.j.cpu()), ks, reads=READS)
            if not (torch.equal(got.spins.cpu(), want.spins)
                    and torch.equal(got.energies.cpu(), want.energies)):
                if name == "tabu":
                    fail("tabu on the card != tabu on the CPU on the same integer instance")
                flips.append(int((got.spins.cpu() != want.spins).any(-1).sum()))
        rep = solve_es(problem, key, scfg, device=dev)
        rep_cpu = solve_es(problem.to("cpu"), key, scfg, device="cpu")
        same = (np.array_equal(rep.selection, rep_cpu.selection)
                and rep.objective == rep_cpu.objective)
        print(f"{name} on the card (N={problem.n}, {READS} reads, {len(times)} solves): "
              f"{percentile(times, 0.5) * 1e3:.3f} ms a solve (median; min "
              f"{min(times) * 1e3:.3f} ms); card == CPU on the same instances: "
              f"{'yes' if not flips else f'no, replicas differing {flips}'}; solve_es "
              f"selection card {rep.selection.nonzero()[0].tolist()} CPU "
              f"{rep_cpu.selection.nonzero()[0].tolist()} (rounded instances equal: "
              f"{same_instances})")
        if name == "tabu" and same_instances and not same:
            fail("solve_es(solver='tabu') on the card != on the CPU")
    big_prob = serve_api.problem_from_spec(serve_api.KofnSpec(m=6, lam=0.5), docs[-1][0],
                                           encoder=enc, device=dev)
    sync()
    t0 = time.perf_counter()
    bounds = metrics.reference_bounds(big_prob)
    wall = time.perf_counter() - t0
    print(f"reference_bounds N={big_prob.n} M=6 (Tabu fallback, 32 replicas x 3000 steps, "
          f"twice) on the card: {wall:.3f} s, {bounds} [{card_line()}]")
    return reqs, served, dict(used=used, stats=stats, ewma=ewma)


def flash_per_pass(cfg, s: int) -> int:
    """Flash launches of one forward pass of ``cfg`` at S = s tokens under
    ``attn_impl="flash"``: every causal self-attention layer (hybrid: the
    shared block once a group; vlm: the self layers, the cross layers take
    the naive softmax; encdec: the decoder, the encoder's 1,500 frames tile
    into no 128-row blocks); none for ssm."""
    if s % min(128, s):
        return 0
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "encdec": cfg.n_layers,
            "hybrid": cfg.n_groups, "vlm": cfg.n_groups * (cfg.group_size - 1),
            "ssm": 0}[cfg.family]


def is_gemm(name: str) -> bool:
    """A device kernel of a matrix product, by name (cuBLAS, cuBLASLt and
    CUTLASS kernels)."""
    low = name.lower()
    return any(x in low for x in ("gemm", "gemv", "nvjet", "xmma", "cutlass"))


def kernel_regions(prof, prefix: str) -> tuple[list, list, int]:
    """The device kernels of a torch.profiler run, each as (name, ms,
    region): a span named ``prefix`` + region (a ``record_function`` span,
    which leaves a GPU user annotation on the device's timeline) holds the
    kernels that start inside it, and a kernel outside every span has
    region None.  Read from the profiler's raw (kineto) events: building
    its event tree takes minutes for the hundreds of thousands of kernels
    of a train step.  Returns (kernels, spans as (start, end, region), the
    host syncs: the runtime's stream and event synchronisations and
    blocking copies)."""
    import bisect

    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = [ev for ev in prof.profiler.kineto_results.events()
           if not getattr(ev, "is_hidden_event", lambda: False)()]
    syncs = sum(ev.name() in ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy")
                for ev in raw)
    device = [(ev.start_ns(), ev.duration_ns(), ev.name()) for ev in raw
              if ev.device_type() == cuda]
    spans = sorted((start, start + dur, name[len(prefix):]) for start, dur, name in device
                   if name.startswith(prefix))
    starts = [sp[0] for sp in spans]
    kernels = []
    for start, dur, name in device:
        if name.startswith(prefix):
            continue
        i = bisect.bisect_right(starts, start) - 1
        region = spans[i][2] if i >= 0 and start < spans[i][1] else None
        kernels.append((name, dur / 1e6, region))
    return kernels, spans, syncs


def moe_profile(prof, wall: float, kernel_names) -> dict:
    """The device time of a profiled MoE pass split by where each kernel
    ran (:func:`kernel_regions`): the ``moe.*`` regions that
    ``families_phase`` wraps around the MoE's router, dispatch, expert
    products and combine; flash by kernel name; the GEMMs outside the
    experts; the rest.  Without spans, the split is by kernel name only."""
    kernels, spans, _ = kernel_regions(prof, "moe.")
    by_name = {"flash": 0.0, "GEMMs": 0.0, "other": 0.0}
    split = dict.fromkeys(("expert GEMMs", "other GEMMs", "dispatch", "router", "flash",
                           "other"), 0.0)
    for name, ms, region in kernels:
        flash, gemm = any(n in name for n in kernel_names), is_gemm(name)
        by_name["flash" if flash else "GEMMs" if gemm else "other"] += ms
        split["flash" if flash
              else "expert GEMMs" if region == "experts" and gemm
              else "dispatch" if region in ("dispatch", "combine")
              else "router" if region == "route"
              else "other GEMMs" if gemm else "other"] += ms
    busy = sum(by_name.values())
    return {"wall_ms": wall * 1e3, "busy_ms": busy,
            "idle_share": 1 - busy / (wall * 1e3) if busy > 0 else None,
            "by_name_ms": by_name,
            "split_ms": split if spans else "not measured (no region spans on the device)"}


def add_flash_launches(launches: dict, c: dict, route: str) -> int:
    """Add a run's flash launches (``c``, counted since the last
    ``reset_counts``, which zeroes the routes' counts too) to the main
    path's, by route: ``launches["flash_attention"]`` is the wgmma kernel's
    row, ``launches["flash_attention_tf32"]`` the split-TF32 kernel's.
    Fails if any launch of the run took another route than ``route``;
    returns the run's count."""
    from repro_torch.kernels import flash_attention as fa

    by_route = dict(fa.flash_attention_cuda.route_launches)
    if sum(by_route.values()) != c["flash_attention"] or by_route[route] != c["flash_attention"]:
        fail(f"flash launches {c['flash_attention']} by route {by_route}: not all on {route}")
    launches["flash_attention" if route == "wgmma" else "flash_attention_tf32"] += by_route[route]
    return by_route[route]


def families_phase(dev, reset_counts, counts, expect, launches, enc_docs, key) -> None:
    """Phase 4g: the other model families on the card.

    (1) qwen2-moe-a2.7b at full width and depth (24 layers, d 2048, 60
    experts top-4, shared expert 5,632, bf16, ``init_params(seed 0)``) in
    ``EncoderStage(max_len=2048)`` on phase 4d's ten documents under flash,
    sdpa and auto: 24 flash launches a stage pass under flash and none
    otherwise, finite embeddings, sentence cosine >= 0.999 of flash against
    sdpa and auto, the direct document bit for bit against itself alone in
    a padded batch of the drain's shape, then ``solve_es(SolveConfig())``
    on the flash embeddings (the direct document above 0.8 normalized); the
    encode wall per bucket, real tokens/s, the router aux of the 2048
    group, and that group's pass under torch.profiler split into expert
    GEMMs, other GEMMs, dispatch (scatter and gather), router (softmax and
    top-k), flash and the rest, with the device's idle share.
    (2) zamba2-2.7b, xlstm-1.3b, whisper-medium (a 1,500-frame stub
    frontend) and llama-3.2-vision-11b (1,600 stub patches) at full width
    and depth, mixtral-8x22b at full width with ``n_layers`` cut from 56 to
    2 (10.6 GB of its 282 GB), bf16, each through ``embed_sentences`` on
    the direct document and the longest of the others at S 2048, B 2 (stub
    frontends from a seeded numpy generator): finite, the expected flash
    launches, cosine >= 0.999 of flash against sdpa, the wall of each pass
    (the first flash pass cold) and the peak memory; each model freed
    before the next loads.  (3) The card against the CPU at full width:
    each of the six in float32, ``n_layers`` cut to one group (whisper's
    ``encoder_layers`` to 1 too), S 256, B 2, the same weights on the card
    (flash on its split-TF32 route, TF32 off in PyTorch's products; the
    card's flash launches counted, by route) and on the CPU (plain
    versions): embeddings within 2e-4 and the MoE routers' choices equal.
    """
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.core import SolveConfig, metrics, solve_es
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.embeddings import EncoderStage, problem_from_sentences
    from repro_torch.embeddings import serving as enc_serving
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import embed_sentences, forward, init_params
    from repro_torch.models import mlp as mlp_mod

    t_phase = time.perf_counter()
    tok = ByteTokenizer()
    print("families: cuts: mixtral-8x22b n_layers 56 -> 2 in (2); in (3) n_layers -> one "
          "group for all six, whisper's encoder_layers 24 -> 1, float32; widths, heads, "
          "experts, vocabularies and frontend lengths as registered")

    def load(cfg):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = init_params(cfg, 0)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in model.parameters())
        size = sum(p.numel() * p.element_size() for p in model.parameters())
        print(f"families {cfg.name}: init_params(seed 0) on the card "
              f"{time.perf_counter() - t0:.1f} s, {n / 1e9:.3f} B parameters, {gb(size)}")
        return model

    def min_cos(a, b) -> float:
        return float(torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min())

    # ---------------------------------------------------------------- (1)
    cfg = get_config("qwen2-moe-a2.7b")
    model = load(cfg)
    per_pass = flash_per_pass(cfg, 1024)
    paths = {}
    for impl in ("flash", "sdpa", "auto"):
        stage = EncoderStage(cfg, model, max_len=2048, attn_impl=impl, linger=ENCODER_LINGER)
        for length, b_pad in ((1024, 4), (2048, 8)):
            stage.prewarm(lengths=[length], batches=[b_pad], segments=[32])
        reset_counts()
        t0 = time.perf_counter()
        futs = [stage.submit(d, tag=i) for i, (_, d, _) in enumerate(enc_docs)]
        embs = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t0
        c = counts()
        stage.close()
        st = stage.stats()
        want = expect(flash_attention=per_pass * st.launches if impl == "flash" else 0)
        if c != want:
            fail(f"qwen2-moe {impl}: launches {c} != {want} ({st.launches} stage launches)")
        if impl == "flash":
            add_flash_launches(launches, c, "wgmma")
        for (name, d, _), e in zip(enc_docs, embs):
            if e.shape != (len(d), cfg.d_model) or not bool(torch.isfinite(e).all()):
                fail(f"qwen2-moe {impl} {name}: embeddings {tuple(e.shape)} not finite / not "
                     f"({len(d)}, {cfg.d_model})")
        per_bucket = {}
        for f in futs:
            r = f.receipt()
            per_bucket[r.padded_len] = per_bucket.get(r.padded_len, 0.0) + r.encoder_seconds
        print(f"qwen2-moe {impl}: {len(enc_docs)} documents, {st.tokens} real tokens, wall "
              f"{wall:.3f} s (prewarmed), encode wall per bucket (s) "
              + " ".join(f"{k}: {v:.6f}" for k, v in sorted(per_bucket.items()))
              + f", real tokens/s {st.tokens / st.busy_seconds:.1f}, stage launches "
              f"{st.launches}, kernel launches {c}")
        paths[impl] = embs
        del stage, futs
    flash_embs = paths["flash"]
    for impl in ("sdpa", "auto"):
        err = max(float((a - b).abs().max()) for a, b in zip(flash_embs, paths[impl]))
        cos = min(min_cos(a, b) for a, b in zip(flash_embs, paths[impl]))
        print(f"qwen2-moe flash vs {impl}: max abs err {err:.3e}, min sentence cosine {cos:.6f}")
        if cos < 0.999:
            fail(f"qwen2-moe flash vs {impl}: min sentence cosine {cos} < 0.999")

    # The 2048 drain's batch (its documents in submit order, as the stage
    # groups them), and the direct document alone in a batch of its shape.
    flash_cfg = cfg.replace(attn_impl="flash")
    sents = enc_docs[0][1]
    group = [d for (_, d, _) in enc_docs
             if enc_serving._bucket(min(1 + sum(len(t.encode("utf-8")) + 1 for t in d), 2048),
                                    enc_serving.MIN_LEN_BUCKET) == 2048]
    if not group or group[0] is not sents:
        fail("qwen2-moe: the direct document is not row 0 of the 2048 drain")
    b_pad = enc_serving._bucket(len(group), enc_serving.BATCH_BUCKET)
    tk = torch.zeros((b_pad, 2048), dtype=torch.int32, device=dev)
    sg = torch.full((b_pad, 2048), -1, dtype=torch.int32, device=dev)
    for i, d in enumerate(group):
        t_np, s_np = tok.encode_sentences(d, 2048)
        tk[i], sg[i] = torch.from_numpy(t_np), torch.from_numpy(s_np)
    alone_tk, alone_sg = torch.zeros_like(tk), torch.full_like(sg, -1)
    alone_tk[0], alone_sg[0] = tk[0], sg[0]
    alone = enc_serving._embed_batch(flash_cfg, model, alone_tk, alone_sg, 32)[0, :len(sents)]
    if not torch.equal(alone, flash_embs[0]):
        fail(f"qwen2-moe: the direct document alone in a padded batch of {b_pad} != its "
             f"drain's row: max err {float((alone - flash_embs[0]).abs().max())}")
    print(f"qwen2-moe batch composition: the direct document alone in a padded batch of "
          f"{b_pad} == its row of the 2048 drain, bit for bit")
    with torch.no_grad():
        _, _, aux = forward(flash_cfg, model, tk, return_hidden=True)
    print(f"qwen2-moe router aux of the 2048 group (B={b_pad}, {cfg.n_layers} layers summed): "
          f"{float(aux):.6f}")

    # One profiled pass of the 2048 group, the MoE's parts in named regions.
    def run():
        return enc_serving._embed_batch(flash_cfg, model, tk, sg, 32)

    run()
    torch.cuda.synchronize()
    with spanned([(mlp_mod, "_route", "route"), (mlp_mod, "_dispatch", "dispatch"),
                  (mlp_mod, "_expert_ffn", "experts"), (mlp_mod, "_combine", "combine")],
                 prefix="moe."):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    split = moe_profile(prof, wall, fa.KERNEL_NAMES)
    warm = cuda_ms(run, reps=3, warmup=1)
    print(f"qwen2-moe profile, 2048 group (B={b_pad}): {json.dumps(split)}; the same pass "
          f"unprofiled {warm:.3f} ms (CUDA events, mean of 3)")
    del prof

    # The slice end to end: the flash embeddings -> solve_es on the card.
    reset_counts()
    for (name, d, m), e in zip(enc_docs, flash_embs):
        prob = problem_from_sentences(d, m=m, lam=0.5, device=dev,
                                      encoder=types.SimpleNamespace(encode=lambda _s, e=e: e))
        erep = solve_es(prob, key, SolveConfig())
        score = float(metrics.normalized_objective(erep.objective,
                                                   metrics.reference_bounds(prob)))
        print(f"qwen2-moe flash {name}: selected {erep.selection.nonzero()[0].tolist()} "
              f"norm_obj {score:.6f}")
        if erep.selection.sum() != m or not math.isfinite(erep.objective):
            fail(f"qwen2-moe {name}: selects {erep.selection.sum()} of {m}")
        if name == "direct" and score <= 0.8:
            fail(f"qwen2-moe direct: normalized objective {score} <= 0.8")
    for name, n in counts().items():
        launches[name] += n
    print(f"qwen2-moe peak memory {gb(torch.cuda.max_memory_allocated())}")
    del model, paths, flash_embs, embs, tk, sg, alone_tk, alone_sg, alone, run
    release()

    # ---------------------------------------------------------------- (2)
    docs = [enc_docs[0], max(enc_docs[1:], key=lambda x: len(x[1]))]
    n_seg = 32
    real = [len(d) for _, d, _ in docs]
    pairs = [tok.encode_sentences(d, 2048) for _, d, _ in docs]
    tokens = torch.tensor(np.stack([t for t, _ in pairs]), device=dev)
    segs = torch.tensor(np.stack([s for _, s in pairs]), device=dev)
    for name, cut in (("zamba2-2.7b", {}), ("xlstm-1.3b", {}), ("whisper-medium", {}),
                      ("llama-3.2-vision-11b", {}), ("mixtral-8x22b", {"n_layers": 2})):
        cfg = get_config(name).replace(**cut)
        n_slstm = cfg.n_layers // cfg.group_size if cfg.family == "ssm" else 0
        model = load(cfg)
        frontend = None
        if cfg.n_frontend_tokens:
            frontend = torch.tensor(np.random.default_rng(0).standard_normal(
                (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32),
                device=dev).to(cfg.dtype)
        out, walls = {}, {}
        for impl, reps in (("flash", 2), ("sdpa", 1)):
            icfg = cfg.replace(attn_impl=impl)
            reset_counts()
            for rep in range(reps):
                t0 = time.perf_counter()
                with torch.no_grad():
                    e = embed_sentences(icfg, model, tokens, segs, n_seg, frontend=frontend)
                torch.cuda.synchronize()
                walls[impl + (" (cold)" if rep < reps - 1 else "")] = time.perf_counter() - t0
            c = counts()
            want = expect(flash_attention=reps * flash_per_pass(cfg, 2048) if impl == "flash"
                          else 0, slstm_scan=reps * n_slstm)
            if c != want:
                fail(f"{name} {impl}: launches {c} != {want}")
            if impl == "flash":
                add_flash_launches(launches, c, "wgmma")
            launches["slstm_scan"] += c["slstm_scan"]
            if not bool(torch.isfinite(e).all()):
                fail(f"{name} {impl}: embeddings not finite")
            out[impl] = torch.cat([e[i, :n] for i, n in enumerate(real)])
        cos = min_cos(out["flash"], out["sdpa"])
        print(f"families {name}{' (n_layers 2)' if cut else ''}: B=2 S=2048"
              + (f" frontend {cfg.n_frontend_tokens}" if frontend is not None else "")
              + f", flash launches a pass {flash_per_pass(cfg, 2048)}, walls (s) "
              + " ".join(f"{k}: {v:.3f}" for k, v in walls.items())
              + f", flash vs sdpa min sentence cosine {cos:.6f}, max abs err "
              f"{float((out['flash'] - out['sdpa']).abs().max()):.3e}, peak memory "
              f"{gb(torch.cuda.max_memory_allocated())}")
        if cos < 0.999:
            fail(f"{name}: flash vs sdpa min sentence cosine {cos} < 0.999")
        if n_slstm:
            # The pass runs each sLSTM layer's recurrence as one kernel
            # launch (phase 4k); the Python loop it replaced took 3.571-4.193
            # s a pass at ~250k launches (PERF.md).  One more warm flash pass
            # under torch.profiler counts its device kernels.
            reset_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with torch.no_grad():
                    embed_sentences(cfg.replace(attn_impl="flash"), model, tokens, segs, n_seg,
                                    frontend=frontend)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kernels_a_pass = sum(1 for ev in prof.events()
                                 if ev.device_type == torch.autograd.DeviceType.CUDA)
            sl = counts()["slstm_scan"]
            print(f"families {name} sLSTM: slstm_scan launches a pass {sl} ({n_slstm} sLSTM "
                  f"layers, one launch each), device kernels a pass {kernels_a_pass} "
                  f"(torch.profiler), warm flash pass {wall:.3f} s under the profiler, "
                  f"{walls['flash']:.3f} s without; the replaced Python loop: 3.571-4.193 s "
                  f"a pass, ~250k launches")
            if sl != n_slstm:
                fail(f"{name}: {sl} slstm_scan launches in a pass, want {n_slstm}")
        del model, out, frontend, e
        release()

    # ---------------------------------------------------------------- (3)
    # The last group's hidden states (B, S, d), card against CPU, and the
    # routers' choices.  xlstm's sLSTM at the registered init is chaotic:
    # its recurrent weights r are drawn at fan-in NH = 4 (std 0.44, as the
    # reference draws them), so a rounding difference doubles about every
    # step, in the reference against itself as in the port.  Its card and
    # CPU are held over the first steps (SLSTM_STEPS) and, with r redrawn at
    # fan-in dh (a contractive recurrence), over all 256.
    tokens = torch.tensor(np.stack([tok.encode_sentences(d, 256)[0] for _, d, _ in docs]))
    seen = []
    orig_route = mlp_mod._route

    def spy(p, c, x):
        res = orig_route(p, c, x)
        seen.append(res[1].cpu())
        return res

    def card_vs_cpu(cfg, card, host, frontend, label, steps=None) -> None:
        got = {}
        mlp_mod._route = spy
        try:
            for where, m, d in (("card", card, dev), ("cpu", host, torch.device("cpu"))):
                seen.clear()
                reset_counts()
                t0 = time.perf_counter()
                with torch.no_grad():
                    h, _, _ = forward(cfg, m, tokens.to(d), return_hidden=True,
                                      frontend=None if frontend is None else frontend.to(d))
                got[where] = (h.cpu(), list(seen), time.perf_counter() - t0)
                if where == "card":  # the float32 flash calls: the split-TF32 kernel's
                    flash = add_flash_launches(launches, counts(), "tf32")
        finally:
            mlp_mod._route = orig_route
        (h_card, idx_card, w_card), (h_cpu, idx_cpu, w_cpu) = got["card"], got["cpu"]
        err_t = (h_card - h_cpu).abs().amax(dim=(0, 2))  # by step
        same_idx = len(idx_card) == len(idx_cpu) and all(
            torch.equal(a, b) for a, b in zip(idx_card, idx_cpu))
        held = slice(None, steps)
        print(f"families card vs CPU {label}: max abs err {float(err_t.max()):.3e}"
              + (f", over steps 0-{steps - 1} {float(err_t[held].max()):.3e}, by step "
                 + " ".join(f"{t}: {float(err_t[t]):.1e}" for t in (0, 4, 8, 16, 64, 255))
                 if steps else "")
              + (f", router choices equal: {same_idx}" if cfg.moe else "")
              + f", flash launches {flash}; card {w_card:.2f} s, CPU {w_cpu:.2f} s")
        if not torch.allclose(h_card[:, held], h_cpu[:, held], rtol=2e-4, atol=2e-4):
            fail(f"families card vs CPU {label}: max abs err {float(err_t[held].max())} > 2e-4")
        if cfg.moe and not same_idx:
            fail(f"families card vs CPU {label}: the routers' choices differ")

    for name in ("qwen2-moe-a2.7b", "mixtral-8x22b", "zamba2-2.7b", "xlstm-1.3b",
                 "whisper-medium", "llama-3.2-vision-11b"):
        base = get_config(name)
        cut = {"n_layers": base.group_size}
        if base.encoder_layers:
            cut["encoder_layers"] = 1
        cfg = base.replace(param_dtype="float32", attn_impl="flash", **cut)
        card = init_params(cfg, 0)
        host = copy.deepcopy(card).to("cpu")
        frontend = None
        if cfg.n_frontend_tokens:
            frontend = torch.tensor(np.random.default_rng(1).standard_normal(
                (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
        label = (f"{name} (float32, {cfg.n_layers} layers"
                 + (", 1 encoder layer" if base.encoder_layers else "") + ", S 256, B 2)")
        if cfg.family == "ssm":
            card_vs_cpu(cfg, card, host, frontend, label, steps=SLSTM_STEPS)
            dh = cfg.d_model // cfg.n_heads
            for m in (card, host):
                for group in m.layers:
                    group.slstm.cell.r.mul_((cfg.n_heads / dh) ** 0.5)
            card_vs_cpu(cfg, card, host, frontend, label[:-1] + ", sLSTM r at fan-in dh)")
        else:
            card_vs_cpu(cfg, card, host, frontend, label)
        del card, host, frontend
        release()
    print(f"families phase wall: {time.perf_counter() - t_phase:.1f} s")


def decode_split(prof, wall: float, n_steps: int, prefix: str = "decode.",
                 regions=("attention",)) -> dict:
    """A profiled run of ``n_steps`` decode steps (or prefills, or train
    steps): device launches, host syncs (the runtime's stream and event
    synchronisations and blocking copies) and busy time a step, the idle
    share, and the busy time split by where each kernel started: inside a
    span named ``prefix`` + one of ``regions`` (decode: ``attention``, the
    softmax attention: the GQA repeat, products, mask, softmax; train also
    ``optimizer``), else GEMMs by kernel name, else the rest (norms, RoPE,
    the cache write, activations, residuals, casts, the logits' mask)."""
    kernels, spans, syncs = kernel_regions(prof, prefix)
    split = dict.fromkeys((*regions, "GEMMs", "other"), 0.0)
    for name, ms, region in kernels:
        split[region if region in regions else "GEMMs" if is_gemm(name) else "other"] += ms
    busy = sum(split.values())
    return {"steps": n_steps, "wall_ms_a_step": wall * 1e3 / n_steps,
            "busy_ms_a_step": busy / n_steps, "launches_a_step": len(kernels) / n_steps,
            "host_syncs_a_step": syncs / n_steps,
            "idle_share": 1 - busy / (wall * 1e3) if busy > 0 else None,
            "spans": {r: sum(sp[2] == r for sp in spans) for r in regions},
            "split_ms_a_step": ({k: v / n_steps for k, v in split.items()} if spans
                                else "not measured (no region spans on the device)")}


@contextlib.contextmanager
def spanned(patches, prefix: str = "train."):
    """Each ``(module, attribute, region)`` of ``patches`` wrapped, for the
    block, so that its device kernels fall in a span named ``prefix`` +
    region (:func:`kernel_regions`): its forward, and its recomputation
    under remat, inside ``record_function``; its backward between identity
    autograd nodes around it, one on its first output that opens the span
    when that output's gradient arrives and one on its tensor inputs that
    closes it when theirs are computed (the engine runs a function's
    backward nodes between the two)."""
    import torch
    from torch.profiler import record_function

    open_spans = []

    class Open(torch.autograd.Function):
        @staticmethod
        def forward(ctx, out, name):
            ctx.name = name
            return out.view_as(out)

        @staticmethod
        def backward(ctx, g):
            rf = record_function(ctx.name)
            rf.__enter__()
            open_spans.append(rf)
            return g, None

    class Close(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *xs):
            return tuple(x.view_as(x) for x in xs)

        @staticmethod
        def backward(ctx, *gs):
            if open_spans:
                open_spans.pop().__exit__(None, None, None)
            return gs

    def wrap(f, name):
        def wrapped(*args, **kw):
            args = list(args)
            grad_in = [i for i, a in enumerate(args)
                       if isinstance(a, torch.Tensor) and a.requires_grad]
            if grad_in:
                for i, x in zip(grad_in, Close.apply(*(args[i] for i in grad_in))):
                    args[i] = x
            with record_function(name):
                out = f(*args, **kw)
            first = out[0] if isinstance(out, tuple) else out
            if isinstance(first, torch.Tensor) and first.requires_grad:
                first = Open.apply(first, name)
                out = (first, *out[1:]) if isinstance(out, tuple) else first
            return out
        return wrapped

    originals = [(module, attr, getattr(module, attr)) for module, attr, _ in patches]
    try:
        for module, attr, region in patches:
            setattr(module, attr, wrap(getattr(module, attr), prefix + region))
        yield
    finally:
        for module, attr, f in originals:
            setattr(module, attr, f)


def gb(n: float) -> str:
    return f"{n / 1e9:.3f} GB"


def release() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def greedy(cfg, model, prompt, max_len, steps, label, frontend=None):
    """Prefill ``prompt`` (B, S) (and the vlm / encdec ``frontend``) through
    the step makers, then ``steps`` greedy decode steps: (the tokens fed (B,
    S + steps), the logits at positions S - 1 .. S + steps - 1 (B, steps +
    1, V), the greedy tokens (B, steps + 1), ms a step by CUDA events, the
    warm prefill's wall (a second prefill into the same slots), the decode
    wall, the cache)."""
    import torch

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache

    b, s = prompt.shape
    prefill_step, step = make_prefill_step(cfg), make_decode_step(cfg)
    cache = init_cache(cfg, b, max_len)
    positions = torch.arange(s, s + steps, device=prompt.device)[:, None, None].expand(steps, b, 1)
    walls = []
    for _ in range(2):  # cold (allocations, GEMM heuristics), then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(model, prompt, cache, frontend)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t_cold, t_prefill = walls
    last = [logits[:, -1].clone()]
    del logits
    gen = [torch.argmax(last[0], dim=-1).to(torch.int32)]
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(steps)]
    t0 = time.perf_counter()
    for i in range(steps):
        events[i][0].record()
        nt, lg, cache = step(model, gen[-1][:, None], positions[i], cache)
        events[i][1].record()
        last.append(lg)
        gen.append(nt)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    ms = [a.elapsed_time(e) for a, e in events]
    fed = torch.cat([prompt, torch.stack(gen[:-1], dim=1).to(prompt.dtype)], dim=1)
    print(f"decode {label}: prefill B={b} S={s} wall {t_prefill * 1e3:.3f} ms warm "
          f"({b * s / t_prefill:.1f} tokens/s; cold {t_cold * 1e3:.3f} ms); {steps} greedy "
          f"steps: median "
          f"{percentile(ms, 0.5):.4f} ms, p99 {percentile(ms, 0.99):.4f} ms, min "
          f"{min(ms):.4f} ms a step (CUDA events), wall {t_decode:.3f} s "
          f"({b * steps / t_decode:.1f} tokens/s)")
    return (fed, torch.stack(last, dim=1), torch.stack(gen, dim=1), ms, t_prefill,
            t_decode, cache)


def teacher_check(cfg, model, fed, step_logits, gen, s, bar, label, frontend=None) -> float:
    """The teacher-forced forward over ``fed`` (and ``frontend``): the max abs
    logit error at each predicted position, and the greedy tokens against
    its argmax wherever its top-2 gap exceeds twice that error.  Returns the
    largest error."""
    import torch

    from repro_torch.models import forward

    with torch.no_grad():
        full, _, _ = forward(cfg, model, fed, mode="train", frontend=frontend)
    v = cfg.vocab_size
    teacher = full[:, s - 1:, :v]
    del full
    err = (step_logits[..., :v] - teacher).abs().amax(dim=(0, 2))  # by position
    top2 = torch.topk(teacher, 2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * err[None, :]
    want = torch.argmax(teacher, dim=-1).to(torch.int32)
    agree = (want == gen) | ~decisive
    n_pos = err.numel()
    sample = " ".join(f"{t}: {float(err[t]):.2e}" for t in
                      sorted({0, 1, 2, 4, 8, 16, 32, 64, 128, n_pos - 1}) if t < n_pos)
    print(f"decode {label} teacher-forced check over {fed.shape[1]} tokens: max abs logit "
          f"error {float(err.max()):.4e} (median {float(err.median()):.4e}; by predicted "
          f"position {sample}); greedy == teacher argmax at {int((decisive & agree).sum())}"
          f" of {int(decisive.sum())} decisive of {decisive.numel()} positions; tokens "
          f"equal overall {int((want == gen).sum())} of {gen.numel()}")
    if not bool(torch.isfinite(step_logits[..., :v]).all()):
        fail(f"decode {label}: logits not finite")
    if not bool(agree.all()):
        fail(f"decode {label}: the greedy token differs from the teacher-forced argmax at "
             f"{int((~agree).sum())} decisive positions")
    if float(err.max()) >= bar:
        fail(f"decode {label}: max abs logit error {float(err.max())} >= {bar}")
    return float(err.max())


def profiled(fn, n: int) -> dict:
    """``fn`` run n times under torch.profiler, the attention (over the cache
    in decode, the chunked route in prefill) in a named span:
    :func:`decode_split` of the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import attention as attn

    with spanned([(attn, "_sdpa", "attention"), (attn, "_sdpa_chunked", "attention")],
                 prefix="decode."):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return decode_split(prof, wall, n)


def host_syncs(fn) -> int:
    """The host synchronisations of one ``fn()`` (CUDA's sync debug mode)."""
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def decode_phase(dev, reset_counts, counts, expect, launches) -> None:
    """Phase 4h: prefill and decode through the caches on the card.

    (1) tinyllama-1.1b at full width and depth (22 layers, bf16,
    ``init_params(seed 0)``): ``make_prefill_step`` on B 8 prompts of 2,048
    byte tokens (``ByteTokenizer`` over ``synthetic_document`` texts; the
    chunked attention route) into ``init_cache(cfg, 8, 2304)``, then 256
    greedy ``make_decode_step`` steps, each fed the token chosen before; the
    prefill wall and tokens/s, decode ms a step (CUDA events, median and
    p99) and tokens/s, one step's launches, device idle share and split
    (torch.profiler over 8 more steps; and one warm prefill's) and host
    syncs (the profile and sync debug mode), the
    cache's bytes, the peak memory, and the bounds (prefill FLOP over the
    bf16 peak; a step's weights and valid k/v bytes over HBM's rate).
    Check: the teacher-forced ``forward(mode="train")`` over the 2,304
    tokens; at each of the 257 predicted positions the max abs logit error,
    and the greedy token equal to the teacher's argmax wherever the
    teacher's top-2 gap exceeds twice that error.  (2) mixtral-8x22b at
    full width, ``n_layers`` 56 -> 2 (bf16): B 1, a prefill of 5,120 random
    token ids (seeded, as the reference's decode check draws them), past
    the 4,096 window (the ring's tail write, chunked route), 64 greedy steps
    that wrap the ring, and the teacher-forced check over 5,184 tokens under
    the window mask at the reference's MoE bar (0.5: capacity drops differ
    between a pass of 5,184 tokens and one of 1), the dropped choices
    counted.  No kernel of the port launches in (1) or (2): flash is
    train-only.  (3) Every registered config at full width in float32, cut
    to one group (whisper's encoder to 1 layer), B 2: a prefill of 256
    random ids (and the stub frontend), then 8 decode steps, on the card and
    on the CPU from the same weights: logits at every step and every cache
    leaf after the last within 2e-4 (``pos`` bit for bit), the MoE routers'
    choices equal; xlstm over a prefill of SLSTM_STEPS and SLSTM_STEPS
    steps at the registered init and over the full lengths with r at fan-in
    dh, its slstm_scan launches on the card counted (one a layer for the
    prefill and for each step; added to the ``kernels`` line's).  At the
    registered init the sLSTM is chaotic at full width (PERF.md §7), so
    there the CPU also runs with the sLSTM's scan in float64 (the op's
    plain version on float64 copies of its inputs): an sLSTM cache leaf
    beyond 2e-4 of the float32 CPU must lie within 4x the float32 CPU's own
    distance from the float64 run, plus 2e-5 of its largest magnitude.
    (4), the families at full depth, is :func:`depth_phase`.
    """
    import copy

    import torch

    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import slstm_scan as kslstm
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models import mlp as mlp_mod

    t_phase = time.perf_counter()

    # ---------------------------------------------------------------- (1)
    cfg = get_config("tinyllama-1.1b")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, 0)
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompt = byte_prompts(DECODE_BATCH, DECODE_PROMPT, dev)
    b, s, hd, n_l = DECODE_BATCH, DECODE_PROMPT, cfg.hd, cfg.n_layers
    max_len = s + DECODE_STEPS
    reset_counts()
    fed, step_logits, gen, ms, t_prefill, t_decode, cache = greedy(
        cfg, model, prompt, max_len, DECODE_STEPS, "tinyllama-1.1b")
    c = counts()
    if c != expect():
        fail(f"decode tinyllama-1.1b: kernels of the port launched {c}; the decode path has none")
    cache_bytes = tree_bytes(cache)
    # Work: the layers' GEMMs and the unembedding at every position, and
    # causal attention (QK^T and PV) over the pairs it needs.
    layer_w = cfg.d_model * (2 * cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd) \
        + 3 * cfg.d_model * cfg.d_ff
    p_flop = 2 * b * s * (n_l * layer_w + cfg.d_model * cfg.padded_vocab) \
        + 4 * b * n_l * cfg.n_heads * hd * (s * (s + 1) // 2)
    p_bytes = w_bytes + cache_bytes + b * s * (4 + 4 * cfg.padded_vocab)
    p_bound, p_by = bound_ms(p_flop, p_bytes, PEAK_BF16_FLOPS)
    kv_token = n_l * 2 * cfg.n_kv_heads * hd * 2  # bf16 k and v of one token, all layers
    read_w = w_bytes - model.embed.numel() * model.embed.element_size() + b * cfg.d_model * 2
    d_bounds = [bound_ms(2 * b * (read_w // 2) + 4 * b * n_l * cfg.n_heads * hd * (s + i + 1),
                         read_w + b * kv_token * (s + i + 1), PEAK_BF16_FLOPS)
                for i in range(DECODE_STEPS)]
    d_mean = sum(x for x, _ in d_bounds) / len(d_bounds)
    print(f"decode tinyllama-1.1b bounds: prefill {p_flop / 1e12:.3f} TFLOP, {gb(p_bytes)}, "
          f"{p_bound:.4f} ms ({p_by}), measured {t_prefill * 1e3 / p_bound:.2f}x; a step reads "
          f"{gb(read_w + b * kv_token * (s + 1))}-{gb(read_w + b * kv_token * max_len)} "
          f"(weights but the embedding table, and the valid k/v), "
          f"{d_bounds[0][0]:.4f}-{d_bounds[-1][0]:.4f} ms ({d_bounds[0][1]}; mean "
          f"{d_mean:.4f}), median step {percentile(ms, 0.5) / d_mean:.2f}x; cache "
          f"{gb(cache_bytes)} (B={b}, {max_len} slots, {kv_token} bytes a token); weights "
          f"{gb(w_bytes)}")
    teacher_check(cfg, model, fed, step_logits, gen, s, float("inf"), "tinyllama-1.1b")
    del step_logits

    # One step's launches, host syncs and device time: 8 more steps from
    # position 2048 (the cache's later slots are masked off), the attention
    # over the cache in a named span.
    step = make_decode_step(cfg)
    tok_in = gen[:, :1].contiguous()
    pos = [torch.full((b, 1), s + i, device=dev) for i in range(8)]
    syncs = host_syncs(lambda: step(model, tok_in, pos[0], cache))
    split = profiled(lambda i: step(model, tok_in, pos[i], cache), 8)
    prefill_step = make_prefill_step(cfg)
    p_split = profiled(lambda i: prefill_step(model, prompt, cache), 1)
    print(f"decode tinyllama-1.1b prefill profile (B={b}, S={s}, warm): {json.dumps(p_split)}")
    peak = torch.cuda.max_memory_allocated()
    print(f"decode tinyllama-1.1b step profile (B={b}, positions {s}-{s + 7}): "
          f"{json.dumps(split)}; host syncs of one step (sync debug mode): {syncs}; peak "
          f"memory {gb(peak)}")
    if syncs or split["host_syncs_a_step"]:
        fail(f"decode tinyllama-1.1b: one step synced the host {syncs} times (debug mode), "
             f"{split['host_syncs_a_step']} (profile)")
    print("decode summary " + json.dumps({
        "prefill_ms": t_prefill * 1e3, "prefill_tokens_s": b * s / t_prefill,
        "prefill_bound_ms": p_bound, "step_ms_median": percentile(ms, 0.5),
        "step_ms_p99": percentile(ms, 0.99), "decode_tokens_s": b * DECODE_STEPS / t_decode,
        "step_bound_ms_mean": d_mean, "launches_a_step": split["launches_a_step"],
        "host_syncs_a_step": split["host_syncs_a_step"], "idle_share": split["idle_share"],
        "cache_bytes": cache_bytes, "peak_memory_bytes": peak}))
    del model, cache, fed, gen, prompt, pos, tok_in, step
    release()

    # ---------------------------------------------------------------- (2)
    cfg = get_config("mixtral-8x22b").replace(n_layers=2)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, 0)
    rng = np.random.default_rng(5)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, RING_PROMPT)).astype(np.int32),
                          device=dev)
    orig_route = mlp_mod._route
    dropped = []

    def count_drops(p, c, x):
        res = orig_route(p, c, x)
        dropped.append((~res[3]).sum())  # on the card: no host sync in the timed steps
        return res

    mlp_mod._route = count_drops
    try:
        reset_counts()
        fed, step_logits, gen, ms, t_prefill, t_decode, cache = greedy(
            cfg, model, prompt, RING_PROMPT + RING_STEPS, RING_STEPS, "mixtral-8x22b (2 layers)")
        c = counts()
        if c != expect():
            fail(f"decode mixtral: kernels of the port launched {c}; the decode path has none")
        pos_c = cache["layers"]["pos"]
        if pos_c.shape[1] != cfg.sliding_window or int(pos_c.max()) != RING_PROMPT + RING_STEPS - 1:
            fail(f"decode mixtral: the ring holds {pos_c.shape[1]} slots up to position "
                 f"{int(pos_c.max())}")
        window = [int(x) for x in pos_c[0].sort().values[[0, -1]]]
        n_prefill = len(dropped)
        teacher_check(cfg, model, fed, step_logits, gen, RING_PROMPT, 0.5,
                      "mixtral-8x22b (2 layers)")
    finally:
        mlp_mod._route = orig_route
    drops = lambda calls: int(sum(calls)) if calls else 0
    print(f"decode mixtral-8x22b (2 layers): the ring's {cfg.sliding_window} slots hold "
          f"positions {window[0]}-{window[1]}; dropped (token, choice) pairs: prefill "
          f"{drops(dropped[cfg.n_layers:2 * cfg.n_layers])} (each of the two), decode "
          f"{drops(dropped[2 * cfg.n_layers:n_prefill])}, "
          f"teacher-forced pass {drops(dropped[n_prefill:])}; peak memory "
          f"{gb(torch.cuda.max_memory_allocated())}")
    del model, cache, fed, gen, prompt, step_logits
    release()

    # ---------------------------------------------------------------- (3)
    seen = []

    def spy(p, c, x):
        res = orig_route(p, c, x)
        seen.append(res[1].cpu())
        return res

    def run(cfg, m, d, tokens, frontend, s_pre, steps):
        """Prefill s_pre tokens, then ``steps`` decode steps, on device d:
        (logits, each on the CPU, the cache on the CPU, router choices)."""
        seen.clear()
        with torch.no_grad():
            cache = init_cache(cfg, tokens.shape[0], s_pre + steps, device=d)
            lg, cache = prefill(cfg, m, tokens[:, :s_pre].to(d), cache,
                                frontend=None if frontend is None else frontend.to(d))
            out = [lg.cpu()]
            for t in range(s_pre, s_pre + steps):
                pos = torch.full((tokens.shape[0], 1), t, device=d)
                lg, cache = decode_step(cfg, m, tokens[:, t:t + 1].to(d), pos, cache)
                out.append(lg.cpu())
        flat = []

        def leaves(tree, path=""):
            if isinstance(tree, dict):
                for k in sorted(tree):
                    leaves(tree[k], f"{path}.{k}")
            else:
                flat.append((path[1:], tree.cpu()))

        leaves(cache)
        return out, flat, list(seen)

    orig_scan = kops.slstm_scan

    def scan_f64(wx, r, bias, state):
        """The sLSTM's scan in float64 (the op's plain version on the CPU),
        its outputs rounded back to float32."""
        hs, c, n, h, m, _, _ = kslstm.slstm_scan_plain(
            *(t.double() for t in (wx, r, bias, *(state[k] for k in "cnhm"))))
        return hs.float(), {k: v.float() for k, v in zip("cnhm", (c, n, h, m))}

    def card_vs_cpu(cfg, card, host, label, s_pre, steps, chaotic=False) -> None:
        rng = np.random.default_rng(1)
        tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (2, s_pre + steps)))
        frontend = None
        if cfg.n_frontend_tokens:
            frontend = torch.tensor(rng.standard_normal(
                (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
        n_slstm = cfg.n_layers // cfg.group_size if cfg.family == "ssm" else 0
        mlp_mod._route = spy
        try:
            reset_counts()
            t0 = time.perf_counter()
            lg_card, c_card, r_card = run(cfg, card, dev, tokens, frontend, s_pre, steps)
            w_card = time.perf_counter() - t0
            c = counts()
            t0 = time.perf_counter()
            lg_cpu, c_cpu, r_cpu = run(cfg, host, torch.device("cpu"), tokens, frontend,
                                       s_pre, steps)
            w_cpu = time.perf_counter() - t0
            c_f64 = None
            if chaotic:
                kops.slstm_scan = scan_f64
                try:
                    c_f64 = dict(run(cfg, host, torch.device("cpu"), tokens, frontend, s_pre,
                                     steps)[1])
                finally:
                    kops.slstm_scan = orig_scan
        finally:
            mlp_mod._route = orig_route
        if n_slstm:
            want = expect(slstm_scan=n_slstm * (1 + steps))
            if c != want:
                fail(f"decode card vs CPU {label}: launches {c} != {want}")
            launches["slstm_scan"] += c["slstm_scan"]
            print(f"decode card vs CPU {label}: slstm_scan launches {c['slstm_scan']} "
                  f"({n_slstm} sLSTM layers x (prefill + {steps} steps))")
        v = cfg.vocab_size
        err_lg = [float((a[..., :v] - b[..., :v]).abs().max()) for a, b in zip(lg_card, lg_cpu)]
        err_c, bad = 0.0, []
        for (k, a), (k2, b) in zip(c_card, c_cpu):
            if k != k2 or a.shape != b.shape or a.dtype != b.dtype:
                fail(f"decode card vs CPU {label}: cache leaf {k} {tuple(a.shape)} {a.dtype} "
                     f"!= {k2} {tuple(b.shape)} {b.dtype}")
            if k.endswith("pos"):
                if not torch.equal(a, b):
                    bad.append(k)
            elif a.numel():
                err_c = max(err_c, float((a - b).abs().max()))
                if not torch.allclose(a, b, rtol=2e-4, atol=2e-4):
                    bad.append(k)
        if c_f64 is not None:
            # The sLSTM's leaves against the CPU with its scan in float64: the
            # card's distance, the float32 CPU's, and the bar for a leaf
            # beyond 2e-4 of the float32 CPU.
            for k, a in c_card:
                if ".slstm." not in k:
                    continue
                ref = c_f64[k].double()
                e_card = float((a.double() - ref).abs().max())
                e_cpu = float((dict(c_cpu)[k].double() - ref).abs().max())
                bar = 4 * e_cpu + 2e-5 * float(ref.abs().max())
                print(f"decode card vs CPU {label}: {k} against the float64 scan: card "
                      f"{e_card:.3e}, float32 CPU {e_cpu:.3e} (bar {bar:.3e} where beyond 2e-4)")
                if k in bad and e_card <= bar:
                    bad.remove(k)
        same_idx = len(r_card) == len(r_cpu) and all(
            torch.equal(a, b) for a, b in zip(r_card, r_cpu))
        print(f"decode card vs CPU {label}: logits max abs err prefill {err_lg[0]:.3e}, steps "
              + " ".join(f"{e:.1e}" for e in err_lg[1:]) + f"; cache leaves max abs err "
              f"{err_c:.3e} ({len(c_card)} leaves)"
              + (f", router choices equal: {same_idx}" if cfg.moe else "")
              + f"; card {w_card:.2f} s, CPU {w_cpu:.2f} s")
        for a, b in zip(lg_card, lg_cpu):
            if not torch.allclose(a[..., :v], b[..., :v], rtol=2e-4, atol=2e-4):
                fail(f"decode card vs CPU {label}: logits max abs err {max(err_lg)} > 2e-4")
        if bad:
            fail(f"decode card vs CPU {label}: cache leaves {bad} differ beyond 2e-4 (pos: equal)")
        if cfg.moe and not same_idx:
            fail(f"decode card vs CPU {label}: the routers' choices differ")

    for name in sorted(REGISTRY):
        base = get_config(name)
        cut = {"n_layers": base.group_size}
        if base.encoder_layers:
            cut["encoder_layers"] = 1
        cfg = base.replace(param_dtype="float32", **cut)
        card = init_params(cfg, 0)
        host = copy.deepcopy(card).to("cpu")
        label = (f"{name} (float32, {cfg.n_layers} layers"
                 + (", 1 encoder layer" if base.encoder_layers else ""))
        if cfg.family == "ssm":
            card_vs_cpu(cfg, card, host, label + f", S {SLSTM_STEPS} + {SLSTM_STEPS} steps, B 2)",
                        SLSTM_STEPS, SLSTM_STEPS, chaotic=True)
            dh = cfg.d_model // cfg.n_heads
            for m in (card, host):
                for group in m.layers:
                    group.slstm.cell.r.mul_((cfg.n_heads / dh) ** 0.5)
            label += ", sLSTM r at fan-in dh"
        card_vs_cpu(cfg, card, host, label + f", S {PARITY_PROMPT} + {PARITY_STEPS} steps, B 2)",
                    PARITY_PROMPT, PARITY_STEPS)
        del card, host
        release()
    print(f"decode phase wall: {time.perf_counter() - t_phase:.1f} s")


def byte_prompts(b: int, s: int, dev):
    """B prompts of S byte tokens (``ByteTokenizer`` over
    ``synthetic_document(300 + i, 80)``), (B, S) int32 on ``dev``."""
    import torch

    from repro_torch.data.synthetic import synthetic_document
    from repro_torch.data.tokenizer import ByteTokenizer

    tok, rows = ByteTokenizer(), []
    for i in range(b):
        t, _ = tok.encode_sentences(synthetic_document(300 + i, 80), s)
        if (t == 0).any():
            fail(f"decode prompt {i} is shorter than {s} byte tokens")
        rows.append(t)
    return torch.tensor(np.stack(rows), device=dev)


def forward_flops(cfg, b: int, s: int, ctx: int = 0) -> float:
    """FLOP of one forward over B x S new tokens at positions ctx .. ctx + S -
    1, the least the function needs: 2 a multiply-add of every weight
    matrix a token goes through (an MoE token through its top-k experts,
    the shared one and the router; the embedding is a gather), causal
    self-attention over the keys each query sees (4 H hd a pair, within
    the window), cross-attention (q and o on the tokens, k and v on the
    memory's T rows, 4 H hd a memory row a query), whisper's encoder over
    its frames when ctx is 0 (the prefill), the recurrences' state update
    and read (4 a state element a token), and the unembedding at every new
    position."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t, w, fam = cfg.n_frontend_tokens, cfg.sliding_window, cfg.family
    n_tok = b * s
    proj = d * (2 * h * hd + 2 * kv * hd)  # q, k, v, o
    mlp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    pairs = sum(min(ctx + i + 1, w or ctx + i + 1) for i in range(s))  # a row, a layer
    attn = 4 * h * hd * pairs * b
    cross = 2 * n_tok * 2 * d * h * hd + 2 * b * t * 2 * d * kv * hd + 4 * h * hd * t * n_tok
    flops = 2 * n_tok * d * cfg.padded_vocab
    if fam in ("dense", "moe", "encdec", "vlm"):
        n_self = cfg.n_groups * (cfg.group_size - 1) if fam == "vlm" else cfg.n_layers
        ffn = mlp
        if cfg.moe:
            m = cfg.moe
            ffn = m.top_k * 3 * d * m.d_ff_expert + d * m.num_experts
            ffn += (3 * d * m.d_ff_shared + d) if m.d_ff_shared else 0
        flops += 2 * n_tok * n_self * (proj + ffn) + n_self * attn
        if fam == "vlm":
            flops += cfg.n_groups * (cross + 2 * n_tok * mlp)
        if fam == "encdec":
            flops += cfg.n_layers * cross
            if ctx == 0:
                flops += cfg.encoder_layers * (2 * b * t * (proj + mlp) + 4 * h * hd * b * t * t)
    elif fam == "hybrid":
        ssm = cfg.ssm
        d_in = ssm.expand * d
        heads = d_in // ssm.head_dim
        mamba = d * (2 * d_in + 2 * ssm.d_state + heads) + d_in * d
        flops += 2 * n_tok * (cfg.n_layers * mamba + cfg.n_groups * (proj + mlp))
        flops += cfg.n_groups * attn + 4 * n_tok * cfg.n_layers * d_in * ssm.d_state
    elif fam == "ssm":
        d_in, f_ff = 2 * d, int(4 * d / 3 + 127) // 128 * 128
        dh_m = d_in // h
        mlstm = d * 2 * d_in + 3 * d_in * d_in + d_in * 2 * h + d_in * d
        slstm = d * 4 * d + h * (d // h) * 4 * (d // h) + 2 * d * f_ff
        n_m = cfg.n_groups * (cfg.group_size - 1)
        flops += 2 * n_tok * (n_m * mlstm + cfg.n_groups * slstm)
        flops += 4 * n_tok * n_m * h * dh_m * (dh_m + 1)
    return float(flops)


def step_bytes(cfg, model, cache, ctx: int, experts: float = 0.0) -> float:
    """Bytes a decode step at position ctx must move: each weight it reads,
    once (not the embedding table, of which it reads B rows, unless tied;
    not whisper's encoder; of the routed experts only ``experts``, the
    (layer, expert) pairs the step's tokens chose), and the cache it reads:
    the valid k / v slots (positions 0 .. ctx, within the ring), the
    recurrent states, positions and the memory whole."""
    total, routed = 0, 0
    for name, p in model.named_parameters():
        if name.startswith("encoder.") or (name == "embed" and not cfg.tie_embeddings):
            continue
        if ".moe.w_" in name:
            routed += p.numel() * p.element_size()
        else:
            total += p.numel() * p.element_size()
    if cfg.moe:
        total += experts * routed / (cfg.n_layers * cfg.moe.num_experts)

    def walk(tree, key=""):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
            return
        slots = tree.shape[-3] if key in ("k", "v") else 1
        total += tree.numel() * tree.element_size() * min(ctx + 1, slots) // slots

    walk(cache)
    return float(total)


def depth_phase(dev, reset_counts, counts, expect, launches) -> None:
    """Phase 4h (4): every family that fits one card, at full width and
    depth in bf16 (``init_params(cfg, 0)``), prefilled and decoded as (1)
    decodes tinyllama, in DEPTH_FAMILIES' order, each released before the
    next: B 4 prompts of 1,024 byte tokens (:func:`byte_prompts`; the vlm's
    and whisper's frontends seeded N(0, 1) arrays of the registered length,
    as in 4g), then 64 greedy ``make_decode_step`` steps, into
    ``init_cache(cfg, 4, 1088)``.  Each prints (1)'s lines: the prefill wall
    and tokens/s, ms a step (CUDA events, median and p99) and tokens/s, one
    step's launches, host syncs and idle share (torch.profiler over 8 more
    steps; sync debug mode), the cache's bytes, the peak memory, the bounds
    (the prefill's :func:`forward_flops` over the bf16 peak; each step's
    :func:`step_bytes` over HBM's rate, or its FLOP where that is longer)
    and the teacher-forced check (:func:`teacher_check`), then one "decode
    depth summary" JSON line with the card's name and power limit.

    xlstm-1.3b: at the registered init its sLSTM is chaotic (PERF.md §7),
    so there the check runs over a prompt of SLSTM_STEPS tokens and
    SLSTM_STEPS steps; then r is redrawn at fan-in dh and the full workload
    runs and is checked over all 1,088 tokens.  Its slstm_scan launches (one
    a layer for each prefill, step and teacher-forced pass) are counted and
    added to the ``kernels`` line.  qwen2-moe-a2.7b: held at the MoE bar of
    0.5 (capacity drops differ between passes of 1,024, 1,088 and one token
    a row); the prefill and the 64 steps are replayed with the routers
    recorded, as is the teacher-forced pass: the dropped (token, choice)
    pairs of each, and the decode's top-k expert sets equal to the teacher
    pass's wherever neither pass dropped one of the token's choices and the
    teacher's k-th router logit leads its (k + 1)-th by more than twice the
    two passes' router logit error there.  Its step bound reads the experts
    the step's tokens chose.  No family is cut: one that raises or runs out
    of memory fails the phase."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models import mlp as mlp_mod

    t_phase = time.perf_counter()
    card = card_line()
    b, s, steps = DEPTH_BATCH, DEPTH_PROMPT, DEPTH_STEPS
    max_len = s + steps
    prompt = byte_prompts(b, s, dev)
    orig_route = mlp_mod._route
    for name in DEPTH_FAMILIES:
        t_fam = time.perf_counter()
        cfg = get_config(name)
        release()
        torch.cuda.reset_peak_memory_stats()
        model = init_params(cfg, 0)
        w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        frontend = None
        if cfg.n_frontend_tokens:
            frontend = torch.tensor(np.random.default_rng(0).standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32),
                device=dev).to(cfg.dtype)
        n_slstm = cfg.n_groups if cfg.family == "ssm" else 0
        label = f"{name} ({cfg.n_layers} layers, bf16"
        sl = []
        if n_slstm:
            k = SLSTM_STEPS
            reset_counts()
            fed, lg, gen, *_ = greedy(cfg, model, prompt[:, :k], 2 * k, k,
                                      label + f", registered init, S {k} + {k} steps)")
            teacher_check(cfg, model, fed, lg, gen, k, float("inf"),
                          label + ", registered init)")
            sl.append(counts())
            if sl[-1] != expect(slstm_scan=n_slstm * (2 + k + 1)):
                fail(f"decode {name} at the registered init: launches {sl[-1]}")
            dh = cfg.d_model // cfg.n_heads
            for group in model.layers:
                group.slstm.cell.r.mul_((cfg.n_heads / dh) ** 0.5)
            label += ", sLSTM r at fan-in dh"
            del fed, lg, gen
        label += ")"
        reset_counts()
        fed, step_logits, gen, ms, t_prefill, t_decode, cache = greedy(
            cfg, model, prompt, max_len, steps, label, frontend)
        sl.append(counts())
        if sl[-1] != expect(slstm_scan=n_slstm * (2 + steps)):
            fail(f"decode {name}: launches {sl[-1]}; want one slstm_scan a sLSTM layer for "
                 "each prefill and step, nothing else")
        cache_bytes = tree_bytes(cache)
        routes = []

        def spy(p, c, x):
            res = orig_route(p, c, x)
            routes.append((res[1], res[3], x.to(torch.float32) @ p.router))
            return res

        if cfg.moe:
            mlp_mod._route = spy
        try:
            reset_counts()
            err = teacher_check(cfg, model, fed, step_logits, gen, s,
                                0.5 if cfg.moe else float("inf"), label, frontend)
            sl.append(counts())
            if cfg.moe:
                # The replay: the same prefill and steps, the routers recorded.
                del cache
                cache = init_cache(cfg, b, max_len)
                with torch.no_grad():
                    prefill(cfg, model, prompt, cache, frontend=frontend)
                    for i in range(steps):
                        decode_step(cfg, model, fed[:, s + i:s + i + 1],
                                    torch.full((b, 1), s + i, device=dev), cache)
        finally:
            mlp_mod._route = orig_route
        experts = [0.0] * steps
        if cfg.moe:
            n_l, e, top_k = cfg.n_layers, cfg.moe.num_experts, cfg.moe.top_k
            if len(routes) != n_l * (2 + steps):
                fail(f"decode {name}: {len(routes)} router calls, want {n_l * (2 + steps)}")
            teach, pre, dec = routes[:n_l], routes[n_l:2 * n_l], routes[2 * n_l:]
            drops = {k: int(sum(int((~kp).sum()) for _, kp, _ in calls))
                     for k, calls in (("prefill", pre), ("decode", dec), ("teacher", teach))}
            # (steps, layers, B, ...) of the decode; the teacher's at positions s ..
            d_idx, d_keep, d_lg = (torch.stack([r[j][:, 0] for r in dec]).reshape(
                steps, n_l, b, -1) for j in range(3))
            t_idx, t_keep, t_lg = (torch.stack([r[j][:, s:s + steps] for r in teach]).permute(
                2, 0, 1, 3) for j in range(3))
            chosen = (F.one_hot(d_idx, e) * d_keep[..., None]).amax(dim=(2, 3))  # (steps, L, E)
            experts = [float(x) for x in chosen.sum(dim=(1, 2))]
            clean = d_keep.all(-1) & t_keep.all(-1)
            top = torch.topk(t_lg, top_k + 1, dim=-1).values
            lead = top[..., top_k - 1] - top[..., top_k]
            sure = clean & (lead > 2 * (d_lg - t_lg).abs().amax(-1))
            same = (d_idx.sort(-1).values == t_idx.sort(-1).values).all(-1)
            n_sure, n_same = int(sure.sum()), int((same & sure).sum())
            print(f"decode {label} routers: dropped (token, choice) pairs: prefill "
                  f"{drops['prefill']} (cap {int(1.25 * top_k * s / e)}), decode {drops['decode']}"
                  f" (cap 1), teacher-forced pass {drops['teacher']} (cap "
                  f"{int(1.25 * top_k * (s + steps) / e)}); decode's expert sets equal to the "
                  f"teacher's at {n_same} of {n_sure} decisive undropped (token, layer) pairs "
                  f"(of {same.numel()}; {int((same & clean).sum())} of {int(clean.sum())} "
                  f"undropped equal); experts a step read {min(experts):.0f}-{max(experts):.0f} "
                  f"(mean {sum(experts) / steps:.1f}) of {n_l * e}")
            if n_same != n_sure:
                fail(f"decode {name}: the decode's routers chose other experts than the "
                     f"teacher-forced pass at {n_sure - n_same} decisive undropped pairs")
        p_flop = forward_flops(cfg, b, s)
        p_bytes = w_bytes + cache_bytes + b * s * (4 + 4 * cfg.padded_vocab)
        p_bound, p_by = bound_ms(p_flop, p_bytes, PEAK_BF16_FLOPS)
        d_bytes = [step_bytes(cfg, model, cache, s + i, experts[i]) for i in range(steps)]
        d_bounds = [bound_ms(forward_flops(cfg, b, 1, s + i), d_bytes[i], PEAK_BF16_FLOPS)
                    for i in range(steps)]
        d_mean = sum(x for x, _ in d_bounds) / steps
        print(f"decode {label} bounds: prefill {p_flop / 1e12:.3f} TFLOP, {gb(p_bytes)}, "
              f"{p_bound:.4f} ms ({p_by}), measured {t_prefill * 1e3 / p_bound:.2f}x; a step "
              f"reads {gb(d_bytes[0])}-{gb(d_bytes[-1])} (weights but the embedding table"
              + (" and the unchosen experts" if cfg.moe else "") + ", the valid cache), "
              f"{d_bounds[0][0]:.4f}-{d_bounds[-1][0]:.4f} ms ({d_bounds[0][1]}; mean "
              f"{d_mean:.4f}), median step {percentile(ms, 0.5) / d_mean:.2f}x; cache "
              f"{gb(cache_bytes)} (B={b}, {max_len} slots); weights {gb(w_bytes)}; {card}")
        # One step's launches, host syncs and device time: 8 more steps from
        # position s (the cache's later slots are masked off; the recurrent
        # states step on).
        step = make_decode_step(cfg)
        tok_in = gen[:, :1].contiguous()
        pos = [torch.full((b, 1), s + i, device=dev) for i in range(8)]
        reset_counts()
        syncs = host_syncs(lambda: step(model, tok_in, pos[0], cache))
        split = profiled(lambda i: step(model, tok_in, pos[i], cache), 8)
        sl.append(counts())
        if sl[-1] != expect(slstm_scan=n_slstm * 9):
            fail(f"decode {name} profiled steps: launches {sl[-1]}")
        peak = torch.cuda.max_memory_allocated()
        print(f"decode {label} step profile (B={b}, positions {s}-{s + 7}): "
              f"{json.dumps(split)}; host syncs of one step (sync debug mode): {syncs}; peak "
              f"memory {gb(peak)}; {card}")
        n_scan = sum(c["slstm_scan"] for c in sl)
        launches["slstm_scan"] += n_scan
        if n_slstm:
            print(f"decode {label}: slstm_scan launches {n_scan}: {n_slstm} a prefill (cold and "
                  f"warm) and a step ({steps} greedy, 9 profiled), {n_slstm} in each "
                  f"teacher-forced pass, at the registered init {sl[0]['slstm_scan']}")
        print("decode depth summary " + json.dumps({
            "name": name, "card": card, "batch": b, "prompt": s, "steps": steps,
            "prefill_ms": t_prefill * 1e3, "prefill_tokens_s": b * s / t_prefill,
            "prefill_bound_ms": p_bound, "step_ms_median": percentile(ms, 0.5),
            "step_ms_p99": percentile(ms, 0.99), "decode_tokens_s": b * steps / t_decode,
            "step_bound_ms_mean": d_mean, "launches_a_step": split["launches_a_step"],
            "host_syncs_a_step": split["host_syncs_a_step"], "host_syncs_debug": syncs,
            "idle_share": split["idle_share"], "cache_bytes": cache_bytes,
            "weights_bytes": w_bytes, "peak_memory_bytes": peak, "teacher_max_abs_err": err,
            "slstm_scan_launches": n_scan, "wall_s": time.perf_counter() - t_fam}))
        del model, cache, fed, gen, step_logits, frontend, routes, step, tok_in, pos
        release()
    print(f"decode depth phase wall: {time.perf_counter() - t_phase:.1f} s")


def tree_parts(tree) -> list:
    """A parameter or state tree's tensors as ((path, index), tensor) pairs,
    in the reference's flatten order."""
    from repro_torch.models.common import leaf_parts, tree_items

    return [(("/".join(path), i), t) for path, leaf in tree_items(tree)
            for i, t in enumerate(leaf_parts(leaf))]


def differing(a, b) -> list:
    """The parts where two trees differ in type or bits."""
    import torch

    pa, pb = tree_parts(a), tree_parts(b)
    if [k for k, _ in pa] != [k for k, _ in pb]:
        fail("train: two trees of different structure")
    return [k for (k, x), (_, y) in zip(pa, pb) if x.dtype != y.dtype or not torch.equal(x, y)]


def timed_steps(step, log: list):
    """``step`` (a train step) with CUDA events recorded around each call:
    each call appends ((start, end), its metrics) to ``log``."""
    import torch

    def timed(*args):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step(*args)
        ev[1].record()
        log.append((ev, out[2]))
        return out
    return timed


@contextlib.contextmanager
def timed_saves():
    """``train.checkpoint.save`` timed for the block: yields the list that
    each save appends (seconds, bytes written) to."""
    import torch

    from repro_torch.train import checkpoint as ckpt

    saves, orig = [], ckpt.save

    def timed_save(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = orig(*a, **kw)
        saves.append((time.perf_counter() - t0, sum(f.stat().st_size for f in path.iterdir())))
        return path

    ckpt.save = timed_save
    try:
        yield saves
    finally:
        ckpt.save = orig


def train_phase(dev, reset_counts, counts, expect, launches) -> None:
    """Phase 4i: the training scaffold on the card.

    (a) tinyllama-1.1b at full width and depth (22 layers, bf16,
    ``init_params(seed 0)``, remat, ``cfg.microbatch`` 2) with float32
    AdamW state: ``train()`` over ``make_train_step`` for TRAIN_STEPS steps
    of ``SyntheticTextTask(DataConfig(8, 2048))`` batches (16,384 tokens a
    step), saving once at the end (keep 1) to a temporary directory that
    the phase deletes: every step's loss and grad norm finite, ms a step
    (CUDA events; median of the warm steps), tokens/s, peak memory, the
    checkpoint's bytes and save and restore seconds, and the restored
    weights and state equal to the live ones bit for bit; one more step
    under torch.profiler (launches, host syncs, idle share, and the device
    time split into the chunked attention, forward, recomputed forward and
    backward, the optimizer, GEMMs and the rest); the bound (the model's
    GEMM and causal-attention FLOP over the bf16 peak, plus the optimizer's
    bytes over HBM's rate) and the step's share of it; then FIXED_STEPS
    steps on one batch at ``OptConfig(warmup_steps=1)``, the last loss
    below the first.  No counted kernel launches (flash is not on the
    train path).  (b) Every registered config at full width in float32,
    cut to one group (whisper's encoder to 1 layer), B 2 x S 128, stub
    frontends: ``train_loss`` and every gradient tensor on the card against
    the CPU within 2e-4, the routers' choices equal; xlstm over the first
    SLSTM_STEPS positions at its registered init and over all 128 with r at
    fan-in dh; tinyllama's ``make_train_step`` once on both (weights and
    state within 2e-4, ``lr`` equal); a flash config's train step raises.
    (c) ``python -m repro_torch.launch.train --arch tinyllama-1.1b
    --reduced --steps 6 --ckpt-every 3`` in a subprocess (exit 0, its
    checkpoints left); then, in process, a run that crashes at step 4 and
    resumes against straight runs: bit for bit, or, if two straight runs
    differ (the embedding's scatter-add backward), within twice their
    spread.  (d) ``make_ising_solve_step`` on one card's shard of the
    reference's ising-fleet cell: D 256 chip-integer instances
    (``synthetic_document`` -> formulation -> rounding, N 64, scaled by a
    power of two so every energy stays exact), R 32 reads, 1,000 steps:
    every returned energy its spins' exact energy bit for bit, the
    launches of a call, ms cold and warm, the bound; at 50 steps on 4 of
    them against the step's plain versions (spins and energies equal
    wherever no phase lies within 2e-4 of the readout boundary), and at
    1,000 steps the mean best energy against a batched plain twin's
    (within 1%: full anneals are judged on energy quality).  Returns the
    fleet's scaled instances and the warm step's ms and launches, which
    phase 4j reuses.
    """
    import copy
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import get_config
    from repro_torch.core import improved_ising
    from repro_torch.core.rounding import quantize_ising
    from repro_torch.data.pipeline import DataConfig, SyntheticTextTask
    from repro_torch.data.synthetic import synthetic_document
    from repro_torch.embeddings import problem_from_sentences
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import attention as attn
    from repro_torch.models import init_params, param_tree, train_loss
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import LoopConfig, PreemptionError, train

    t_phase = time.perf_counter()

    # ---------------------------------------------------------------- (a)
    cfg = get_config("tinyllama-1.1b")
    if cfg.microbatch != 2 or not cfg.remat:
        fail(f"train: tinyllama-1.1b has microbatch {cfg.microbatch}, remat {cfg.remat}")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, 0)
    state = opt.init(model)
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    s_bytes = sum(t.numel() * t.element_size() for name in ("master", "mu", "nu")
                  for _, t in tree_parts(state[name]))
    data = SyntheticTextTask(DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                             cfg.vocab_size)
    tokens_a_step = TRAIN_BATCH * TRAIN_SEQ
    step = tsteps.make_train_step(cfg, opt.OptConfig(total_steps=TRAIN_STEPS))
    timed = []
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    print(f"train tinyllama-1.1b: {n_params / 1e9:.4f} B parameters, weights {gb(w_bytes)} "
          f"(bf16), AdamW state {gb(s_bytes)} (float32), microbatch {cfg.microbatch}, remat "
          f"{cfg.remat}, attn_impl {cfg.attn_impl} (chunk {cfg.attn_chunk}); B {TRAIN_BATCH} x "
          f"S {TRAIN_SEQ} ({tokens_a_step} tokens a step); checkpoint dir free "
          f"{gb(shutil.disk_usage(tmp).free)}")
    try:
        reset_counts()
        t0 = time.perf_counter()
        with timed_saves() as saves:
            model, state, history = train(
                cfg, timed_steps(step, timed), model, state, data,
                LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS, ckpt_dir=str(tmp),
                           keep=1, log_every=1),
                log=lambda line: print(f"train tinyllama-1.1b {line}"))
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        c = counts()
        if c != expect():
            fail(f"train tinyllama-1.1b: kernels of the port launched {c}; the train path has none")
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in history]
        norms = [float(m["grad_norm"]) for _, m in timed]
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses + norms):
            fail(f"train tinyllama-1.1b: losses {losses}, grad norms {norms}")
        ms = [a.elapsed_time(e) for (a, e), _ in timed]
        if len(saves) != 1 or ckpt.steps_available(tmp) != [TRAIN_STEPS]:
            fail(f"train tinyllama-1.1b: {len(saves)} saves, checkpoints "
                 f"{ckpt.steps_available(tmp)}; want one, at step {TRAIN_STEPS}")
        t_save, ck_bytes = saves[0]
        release()
        t0 = time.perf_counter()
        back = ckpt.restore(tmp, TRAIN_STEPS, {"params": model, "opt": state}, cfg=cfg)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        bad = differing(back["params"], param_tree(model)) + differing(back["opt"], state)
        if bad:
            fail(f"train tinyllama-1.1b: restored leaves differ from the live ones: {bad[:5]}")
        del back
        release()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    med = percentile(ms[1:], 0.5)
    print(f"train tinyllama-1.1b: {TRAIN_STEPS} steps through train() in {t_train:.2f} s; "
          f"ms a step (CUDA events) " + " ".join(f"{x:.1f}" for x in ms) + f"; warm median "
          f"{med:.2f} ms ({tokens_a_step / med * 1e3:.1f} tokens/s); losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; grad norms "
          + " ".join(f"{x:.4f}" for x in norms) + f"; peak memory {gb(peak)}")
    print(f"train tinyllama-1.1b checkpoint: {gb(ck_bytes)}, save {t_save:.2f} s "
          f"({ck_bytes / t_save / 1e9:.2f} GB/s), restore to the card {t_restore:.2f} s "
          f"({ck_bytes / t_restore / 1e9:.2f} GB/s); restored == live, every leaf bit for bit")

    # One more step under the profiler: the attention in spans forward, in
    # its recomputation under remat and backward (:func:`spanned`), the
    # optimizer's update in a span.
    batch = data.batch(TRAIN_STEPS)
    with spanned([(attn, "_sdpa_chunked", "attention"), (attn, "_sdpa", "attention"),
                  (opt, "apply_updates", "optimizer")]):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, state, m = step(model, state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    split = decode_split(prof, wall, 1, prefix="train.", regions=("attention", "optimizer"))
    del prof
    print(f"train tinyllama-1.1b step profile (read in {time.perf_counter() - t0:.1f} s; "
          f"step {TRAIN_STEPS + 1}, loss {loss:.4f}; "
          f"attention spans: {cfg.n_layers} layers x {cfg.microbatch} microbatches x forward, "
          f"recomputed forward, backward): {json.dumps(split)}")

    # Work of a step: 6 x the GEMMs' weights (the layers and the
    # unembedding; the embedding is a gather) a token, forward and
    # backward, and causal attention (QK^T and PV over the pairs it needs)
    # forward and backward; remat's recomputed forward is not model work.
    # The optimizer reads a weight, its gradient, master, mu and nu and
    # writes all but the gradient: 30 bytes a parameter (bf16 weights,
    # float32 gradient and state).
    hd, n_l = cfg.hd, cfg.n_layers
    layer_w = cfg.d_model * (2 * cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd) \
        + 3 * cfg.d_model * cfg.d_ff
    gemm_w = n_l * layer_w + cfg.d_model * cfg.padded_vocab
    gemm_flop = 6 * gemm_w * tokens_a_step
    attn_flop = 3 * 4 * TRAIN_BATCH * n_l * cfg.n_heads * hd * (TRAIN_SEQ * (TRAIN_SEQ + 1) // 2)
    opt_bytes = n_params * (2 + 4 + 3 * 4 + 2 + 3 * 4)
    model_ms = (gemm_flop + attn_flop) / PEAK_BF16_FLOPS * 1e3
    opt_ms = opt_bytes / PEAK_BYTES_PER_S * 1e3
    bound = model_ms + opt_ms
    print(f"train tinyllama-1.1b bound: GEMMs {gemm_flop / 1e12:.2f} TFLOP ({gemm_w / 1e9:.4f} G "
          f"weights x 6 x {tokens_a_step} tokens), causal attention {attn_flop / 1e12:.2f} TFLOP "
          f"(forward and backward), {model_ms:.2f} ms at {PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s "
          f"(operations); optimizer {gb(opt_bytes)}, {opt_ms:.2f} ms (bytes); bound "
          f"{bound:.2f} ms a step; the warm median is {med / bound:.2f}x it (share "
          f"{bound / med:.4f})")

    # A fixed batch: the loss must fall.
    del state
    release()
    fixed_state = opt.init(model)
    fixed_step = tsteps.make_train_step(cfg, opt.OptConfig(warmup_steps=1,
                                                           total_steps=FIXED_STEPS))
    fixed = data.batch(0)
    fixed_losses = []
    t0 = time.perf_counter()
    for _ in range(FIXED_STEPS):
        model, fixed_state, m = fixed_step(model, fixed_state, fixed)
        fixed_losses.append(float(m["loss"]))
    print(f"train tinyllama-1.1b fixed batch, {FIXED_STEPS} steps at OptConfig(warmup_steps=1) "
          f"in {time.perf_counter() - t0:.1f} s: losses "
          + " ".join(f"{x:.4f}" for x in fixed_losses))
    if not all(math.isfinite(x) for x in fixed_losses) or fixed_losses[-1] >= fixed_losses[0]:
        fail(f"train tinyllama-1.1b: on one batch the loss went {fixed_losses[0]} -> "
             f"{fixed_losses[-1]}")
    print("train summary " + json.dumps({
        "step_ms_median": med, "step_ms": ms, "tokens_s": tokens_a_step / med * 1e3,
        "peak_memory_bytes": peak, "bound_ms": bound, "bound_share": bound / med,
        "launches_a_step": split["launches_a_step"],
        "host_syncs_a_step": split["host_syncs_a_step"], "idle_share": split["idle_share"],
        "split_ms": split["split_ms_a_step"], "checkpoint_bytes": ck_bytes,
        "save_s": t_save, "restore_s": t_restore, "losses": losses,
        "fixed_batch_losses": fixed_losses}))
    del model, fixed_state, timed
    release()

    walls_by_part = {"a": time.perf_counter() - t_phase}

    # ---------------------------------------------------------------- (b)
    t_part = time.perf_counter()
    seen = []
    orig_route = mlp_mod._route

    def spy(p, c, x):
        res = orig_route(p, c, x)
        seen.append(res[1].cpu())
        return res

    def grads_on(cfg, m, d, batch):
        """(loss + aux, loss, the gradient of every part, the routers'
        choices) of train_loss on device d."""
        seen.clear()
        leaves = [t for _, t in tree_parts(param_tree(m))]
        with tsteps._trainable(leaves):
            total, loss = train_loss(cfg, m, {k: v.to(d) for k, v in batch.items()})
            grads = list(torch.autograd.grad(total, leaves))
        return float(total.detach()), float(loss.detach()), grads, list(seen)

    def grad_check(cfg, card, host, batch, label):
        mlp_mod._route = spy
        try:
            t0 = time.perf_counter()
            got = grads_on(cfg, card, dev, batch)
            w_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = grads_on(cfg, host, torch.device("cpu"), batch)
            w_cpu = time.perf_counter() - t0
        finally:
            mlp_mod._route = orig_route
        # Compared on the card: an expert stack's gradients are GBs, and
        # elementwise passes over them on the host take longer than the
        # gradients themselves.
        names = [k for k, _ in tree_parts(param_tree(host))]
        errs, bad = [], []
        for key, a, b in zip(names, got[2], want[2]):
            b = b.to(dev)
            errs.append(float((a - b).abs().max()) if a.numel() else 0.0)
            if not torch.allclose(a, b, rtol=2e-4, atol=2e-4):
                bad.append(key)
        got[2].clear()
        want[2].clear()
        same_idx = len(got[3]) == len(want[3]) and all(
            torch.equal(a, b) for a, b in zip(got[3], want[3]))
        print(f"train card vs CPU {label}: loss {got[1]:.6f} vs {want[1]:.6f} (+ aux "
              f"{got[0] - got[1]:.3e}); {len(names)} gradient tensors, max abs err "
              f"{max(errs):.3e}" + (f", router choices equal: {same_idx}" if cfg.moe else "")
              + f"; card {w_card:.2f} s, CPU {w_cpu:.2f} s")
        for x, y in ((got[0], want[0]), (got[1], want[1])):
            if not math.isclose(x, y, rel_tol=2e-4, abs_tol=2e-4):
                fail(f"train card vs CPU {label}: loss {x} vs {y}")
        if bad:
            fail(f"train card vs CPU {label}: gradients differ beyond 2e-4: {bad[:5]}")
        if cfg.moe and not same_idx:
            fail(f"train card vs CPU {label}: the routers' choices differ")

    rng = np.random.default_rng(1)
    for name in sorted(REGISTRY):
        base = get_config(name)
        cut = {"n_layers": base.group_size}
        if base.encoder_layers:
            cut["encoder_layers"] = 1
        cfg = base.replace(param_dtype="float32", **cut)
        t0 = time.perf_counter()
        card = init_params(cfg, 0)
        host = copy.deepcopy(card).to("cpu")
        print(f"train card vs CPU {name}: init_params on the card and a copy on the CPU "
              f"{time.perf_counter() - t0:.1f} s")
        ids = rng.integers(0, cfg.vocab_size, (GRAD_BATCH, GRAD_SEQ + 1)).astype(np.int64)
        batch = {"tokens": torch.tensor(ids[:, :-1]), "targets": torch.tensor(ids[:, 1:])}
        batch["targets"][-1, -5:] = -1
        if cfg.n_frontend_tokens:
            batch["frontend"] = torch.tensor(rng.standard_normal(
                (GRAD_BATCH, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
        label = (f"{name} (float32, {cfg.n_layers} layers"
                 + (", 1 encoder layer" if base.encoder_layers else ""))
        reset_counts()
        if cfg.family == "ssm":
            first = {k: (v if k == "frontend" else v[:, :SLSTM_STEPS]) for k, v in batch.items()}
            grad_check(cfg, card, host, first, label + f", S {SLSTM_STEPS}, B {GRAD_BATCH})")
            dh = cfg.d_model // cfg.n_heads
            with torch.no_grad():
                for m in (card, host):
                    for group in m.layers:
                        group.slstm.cell.r.mul_((cfg.n_heads / dh) ** 0.5)
            label += ", sLSTM r at fan-in dh"
        grad_check(cfg, card, host, batch, label + f", S {GRAD_SEQ}, B {GRAD_BATCH})")
        # The sLSTM's scan (phase 4k) on the card: in each check, the forward
        # kernel once in the forward and once more in remat's recomputation,
        # the backward kernel once.
        c = counts()
        checks = 2 if cfg.family == "ssm" else 0
        n_slstm = checks * (cfg.n_layers // cfg.group_size)
        want = expect(slstm_scan=n_slstm * (2 if cfg.remat else 1), slstm_scan_backward=n_slstm)
        if c != want:
            fail(f"train card vs CPU {name}: launches {c} != {want}")
        for k in ("slstm_scan", "slstm_scan_backward"):
            launches[k] += c[k]
        if checks:
            print(f"train card vs CPU {name}: slstm_scan launches {c['slstm_scan']}, "
                  f"slstm_scan_backward launches {c['slstm_scan_backward']} (remat {cfg.remat})")
        if name == "tinyllama-1.1b":
            ocfg = opt.OptConfig(warmup_steps=1, peak_lr=1e-3)
            outs = []
            for m in (card, host):
                st = opt.init(m)
                _, st, met = tsteps.make_train_step(cfg, ocfg)(m, st, batch)
                outs.append(([t.cpu() for _, t in tree_parts(param_tree(m))],
                             [t.cpu() for key in ("master", "mu", "nu")
                              for _, t in tree_parts(st[key])],
                             float(met["lr"]), float(met["loss"])))
            (w_a, s_a, lr_a, l_a), (w_b, s_b, lr_b, l_b) = outs
            err_w = max(float((a - b).abs().max()) for a, b in zip(w_a, w_b))
            err_s = max(float((a - b).abs().max()) for a, b in zip(s_a, s_b))
            print(f"train card vs CPU {name} make_train_step: weights max abs err {err_w:.3e}, "
                  f"state {err_s:.3e}, lr {lr_a} vs {lr_b}, loss {l_a:.6f} vs {l_b:.6f}")
            if lr_a != lr_b or not all(torch.allclose(a, b, rtol=2e-4, atol=2e-4)
                                       for a, b in zip(w_a + s_a, w_b + s_b)):
                fail(f"train card vs CPU {name}: the train step's weights or state differ")
            flash = tsteps.make_train_step(cfg.replace(attn_impl="flash"), ocfg)
            try:
                flash(card, opt.init(card), batch)
            except RuntimeError as e:
                if "no backward" not in str(e):
                    raise
                print(f"train {name} attn_impl='flash' under grad on the card raises: {e}")
            else:
                fail("train: a flash train step ran on the card; the kernel has no backward")
        del card, host
        release()

    walls_by_part["b"] = time.perf_counter() - t_part

    # ---------------------------------------------------------------- (c)
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp_dir:
        tmp = Path(tmp_dir)
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
               "--reduced", "--steps", "6", "--ckpt-every", "3", "--ckpt-dir", str(tmp / "cli"),
               "--device", dev.type]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        print(f"train launcher: {' '.join(cmd[1:])}: exit {run.returncode} in "
              f"{time.perf_counter() - t0:.1f} s; checkpoints "
              f"{ckpt.steps_available(tmp / 'cli')}; last lines: "
              + " | ".join(run.stdout.strip().splitlines()[-2:]))
        if run.returncode != 0 or ckpt.steps_available(tmp / "cli") != [3, 6]:
            fail(f"train launcher failed: {run.stderr[-2000:]}")

        small = get_config("tinyllama-1.1b").reduced()

        def mini(path, failure_at=None):
            m = init_params(small, 0)
            st = opt.init(m)
            step_fn = tsteps.make_train_step(small, opt.OptConfig(total_steps=6, warmup_steps=2))
            data_fn = SyntheticTextTask(DataConfig(batch_size=4, seq_len=256), small.vocab_size)
            loop = LoopConfig(total_steps=6, ckpt_every=2, ckpt_dir=str(path), log_every=100,
                              failure_at_step=failure_at)
            return train(small, step_fn, m, st, data_fn, loop, log=lambda line: None)

        def trees(run_):
            return {"params": param_tree(run_[0]), "opt": run_[1]}

        def diff(a, b) -> float:
            return max(float((x.float() - y.float()).abs().max())
                       for (_, x), (_, y) in zip(tree_parts(trees(a)), tree_parts(trees(b))))

        straight = [mini(tmp / f"straight{i}") for i in range(3)]
        try:
            mini(tmp / "crash", failure_at=4)
        except PreemptionError:
            pass
        else:
            fail("train: failure_at_step=4 did not raise PreemptionError")
        resumed = mini(tmp / "crash")
        if [h["step"] for h in resumed[2]] != [5, 6]:
            fail(f"train: the resumed run took steps {[h['step'] for h in resumed[2]]}")
        spread = max(diff(a, b) for i, a in enumerate(straight) for b in straight[i + 1:])
        gap = diff(resumed, straight[0])
        bitwise = not differing(trees(resumed), trees(straight[0]))
        print(f"train crash at step 4 and resume (tinyllama-1.1b reduced, B 4 x 256, 6 steps): "
              f"three straight runs' spread {spread:.3e}, resumed vs straight {gap:.3e}: "
              + ("bit for bit" if bitwise else "within twice the straight runs' spread"
                 if 0 < gap <= 2 * spread else "differs"))
        if not bitwise and (spread == 0 or gap > 2 * spread):
            fail(f"train: the resumed run differs from the straight one by {gap} (straight runs' "
                 f"spread {spread})")
        del straight, resumed
        release()

    walls_by_part["c"] = time.perf_counter() - t_part

    # ---------------------------------------------------------------- (d)
    t_part = time.perf_counter()
    d, r, n = FLEET_DOCS, FLEET_READS, FLEET_SPINS
    t0 = time.perf_counter()
    hs, js, scales = [], [], []
    for i in range(d):
        problem = problem_from_sentences(synthetic_document(2000 + i, n), m=6, lam=0.5,
                                         device=dev)
        inst = quantize_ising(improved_ising(problem), key=prng.key(i)).ising
        denom = float(2 * inst.j.abs().sum(-1).max() + inst.h.abs().max())
        scales.append(2.0 ** math.ceil(math.log2(denom)))
        hs.append(inst.h)
        js.append(inst.j)
    h_int, j_int = torch.stack(hs), torch.stack(js)
    scale = torch.tensor(scales, dtype=torch.float32, device=dev)
    h_s, j_s = h_int / scale[:, None], j_int / scale[:, None, None]  # exact: powers of two
    phi0 = prng.uniform(prng.key(99), (d, r, n), 0.0, 2.0 * math.pi, device=dev)
    print(f"train ising fleet: {d} instances from synthetic documents (N {n}, integer h and J "
          f"in [{int(min(h_int.min(), j_int.min()))}, {int(max(h_int.max(), j_int.max()))}], "
          f"scaled by 2^-{int(math.log2(min(scales)))} to 2^-{int(math.log2(max(scales)))}) in "
          f"{time.perf_counter() - t0:.1f} s")
    solve = tsteps.make_ising_solve_step(steps=FLEET_STEPS)
    per_call = expect(cobi_trajectory_batched=1, ising_energy_batched=1)
    walls = []
    for i in range(3):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spins, energies = solve(h_s, j_s, phi0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        c = counts()
        if c != per_call:
            fail(f"train ising fleet: a call launched {c}; want one batched trajectory and one "
                 "batched energy")
        if i == 0:
            for name in ("cobi_trajectory_batched", "ising_energy_batched"):
                launches[name] += c[name]
    warm_ms = cuda_ms(lambda: solve(h_s, j_s, phi0), reps=5, warmup=1)
    reset_counts()
    s64 = spins.double()
    exact = (torch.einsum("dn,dn->d", s64, h_int.double())
             + torch.einsum("di,dij,dj->d", s64, j_int.double(), s64)) / scale.double()
    if spins.dtype != torch.int8 or tuple(spins.shape) != (d, n) or not torch.equal(
            energies, exact.float()):
        fail(f"train ising fleet: energies differ from their spins' exact energies at "
             f"{int((energies != exact.float()).sum())} of {d} documents")
    flop = FLEET_STEPS * 2 * (2 * r) * n * n * d + 2 * r * n * n * d
    nbytes = 4 * (j_s.numel() + h_s.numel() + phi0.numel()) + spins.numel() + 4 * d
    b_ms, by = bound_ms(flop, nbytes)

    def fleet_plain(h, j, phi, steps):
        """A batched plain twin of the step: the oracle's Euler steps over
        every document at once, sign, energies, first argmin."""
        j2 = j + j
        r_ = phi.shape[1]
        ks_max32 = torch.tensor(1.2, dtype=torch.float32)
        for t in range(steps):
            sn, cs = torch.sin(phi), torch.cos(phi)
            mj = torch.cat([cs, sn], dim=1) @ j2
            grad = (sn * mj[:, :r_] - cs * mj[:, r_:]) + h[:, None] * sn
            ks = float(ks_max32 * (float(t) + 1.0) / steps)
            phi = phi + 0.35 * (grad - ks * (2.0 * (sn * cs)))
        e = kref.ref_ising_energy_batched(kref.sign_spins(phi), h, j)
        return e[torch.arange(phi.shape[0], device=phi.device), torch.argmin(e, dim=1)]

    plain_ms = cuda_ms(lambda: fleet_plain(h_s, j_s, phi0, FLEET_STEPS), reps=1, warmup=0)
    mean_k = float(energies.double().mean())
    mean_p = float(fleet_plain(h_s, j_s, phi0, FLEET_STEPS).double().mean())
    print(f"train ising fleet (D {d}, R {r}, N {n}, {FLEET_STEPS} steps): cold "
          f"{walls[0]:.3f} ms, then {walls[1]:.3f} and {walls[2]:.3f} ms (host clock to a "
          f"synchronise), warm {warm_ms:.4f} ms (CUDA events); launches a call "
          f"{ {k: v for k, v in per_call.items() if v} }; energies exact at all {d}; bound "
          f"{b_ms:.4f} ms ({by}, {flop / 1e12:.4f} TFLOP, {nbytes / 1e6:.2f} MB), warm "
          f"{warm_ms / b_ms:.2f}x it; mean best energy {mean_k:.6f} against the batched plain "
          f"twin's {mean_p:.6f} ({plain_ms:.1f} ms)")
    if abs(mean_k - mean_p) > 0.01 * abs(mean_p):
        fail(f"train ising fleet: mean best energy {mean_k} against the plain twin's {mean_p}")
    # 50 steps on 4 documents: the card's step against its plain versions.
    k = FLEET_CHECK_DOCS
    short = tsteps.make_ising_solve_step(steps=FLEET_CHECK_STEPS)
    cs_, ce_ = short(h_s[:k], j_s[:k], phi0[:k])
    ps_, pe_ = short(h_s[:k].cpu(), j_s[:k].cpu(), phi0[:k].cpu())
    reset_counts()
    phi = torch.stack([kref.ref_cobi_trajectory(j_s[i].cpu(), h_s[i].cpu(), phi0[i].cpu(),
                                                steps=FLEET_CHECK_STEPS, dt=0.35, ks_max=1.2)
                       for i in range(k)])
    clear = (torch.cos(phi).abs() > TRAJ_TOL * (1 + phi.abs())).all(dim=2).all(dim=1)
    agree = (cs_.cpu() == ps_).all(dim=1) & (ce_.cpu() == pe_)
    print(f"train ising fleet at {FLEET_CHECK_STEPS} steps on {k} documents: clear of the "
          f"readout boundary {clear.tolist()}, card == plain {agree.tolist()}")
    if not bool(agree[clear].all()):
        fail("train ising fleet: the card's best spins or energies differ from the plain "
             "versions' on a document clear of the readout boundary")
    walls_by_part["d"] = time.perf_counter() - t_part
    print(f"train phase wall: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in walls_by_part.items()) + ")")
    return {"h_s": h_s, "j_s": j_s, "step_ms": med,
            "launches_a_step": split["launches_a_step"]}


def model_parts(cfg, model) -> list:
    """The parts whose gradients the depth check holds one by one, as
    (label, parameters): the embeddings, each encoder block and the
    encoder's norm (encdec), each group, the shared block (hybrid), and the
    head (the final norm and the unembedding; with tied embeddings the
    final norm).  Every parameter is in exactly one part."""
    parts = [("embeddings", [model.embed])]
    if cfg.family == "encdec":
        parts += [(f"encoder block {j}", list(b.parameters()))
                  for j, b in enumerate(model.encoder.blocks)]
        parts.append(("encoder norm", list(model.encoder.norm.parameters())))
    parts += [(f"group {i}", list(g.parameters())) for i, g in enumerate(model.layers)]
    if model.shared is not None:
        parts.append(("shared block", list(model.shared.parameters())))
    parts.append(("head", list(model.final_norm.parameters())
                   + ([] if cfg.tie_embeddings else [model.unembed])))
    ids = [id(p) for _, ps in parts for p in ps]
    if len(set(ids)) != len(ids) or set(ids) != {id(p) for p in model.parameters()}:
        fail(f"{cfg.name}: the parts do not cover each parameter once")
    return parts


def train_depth_phase(dev, reset_counts, counts, expect, launches, enc_docs) -> None:
    """Phase 4i (2): training at full depth on the card.

    (a) The paper's encoder trained end to end, as ``examples/train_tiny_lm.py
    --full --arch sbert-paper`` runs it: ``get_config("sbert-paper")``
    unreduced (12 layers, d 768, bf16, remat, microbatch 1),
    ``init_params(cfg, 0)``, ``opt.init``, ``make_train_step(cfg,
    OptConfig(peak_lr=3e-3, warmup_steps=20, total_steps=200))`` on
    ``SyntheticTextTask(DataConfig(8, 128))`` through ``train()`` for 200
    steps with a checkpoint every 50 into a temporary directory that the
    phase deletes: the first and last loss (the last below the first), ms a
    step (CUDA events), each checkpoint's bytes and seconds; the last
    checkpoint restored into a fresh model, equal to the live weights and
    state bit for bit; that model in ``BackboneEncoder(max_len=512)``
    embeds ``synthetic_document(3, 16)``, ``problem_from_sentences(m=5,
    lam=0.5)`` and ``solve_es(SolveConfig(solver="cobi", iterations=4,
    reads=8, int_range=14))`` on the card (the COBI and energy kernels):
    the selection and its objective normalized against exact enumeration
    (C(16, 5) = 4,368), above 0.8; then ``EncoderStage(attn_impl="flash")``
    on phase 4d's ten documents against the chunked route (``"auto"``),
    sentence cosine >= 0.999.

    (b) TRAIN_DEPTH_FAMILIES at full width and depth, in that order, each
    released before the next: ``init_params(cfg, 0)`` (bf16, the registered
    microbatch and remat), 4i (b)'s stub frontends (N(0, 1) frames), the
    state type of TRAIN_DEPTH_STATE.  xlstm: its registered init is chaotic
    (the non-finite elements of its bf16 gradients at B 1 x S 512 are
    counted and printed), so r is redrawn at fan-in dh, as 4h and 4i do,
    before the checks and the steps.  Before the first step, on the same
    weights: (1) the gradient check: a float32 copy of the model, TF32 off,
    B 1 x S 256; for each part of :func:`model_parts` the central difference
    (f(w + eps u) - f(w - eps u)) / 2 eps along u = g_part / |g_part| must
    lie within GRADCHECK_TOL of |g_part| (relative), eps = DEPTH_DELTA x
    |f(w)| / |g_part|; the noise of a repeated forward printed; (2) remat
    on against off at B 1 x S 512 in bf16: every gradient bit for bit, or,
    if two runs with remat on differ, within twice their spread; (3) the
    serving forward's cross-entropy (``forward``, no grad, no remat, each
    microbatch's mean averaged as the step averages them) on the fixed
    batch.  Then FIXED_STEPS steps of ``make_train_step`` (``OptConfig(
    warmup_steps=1)``) on that one batch of B 8 x 2,048
    (``SyntheticTextTask`` batch 0): each step's ms (CUDA events), loss and
    grad norm (all finite), the warm median and tokens/s; (3) the first
    loss equal to the serving cross-entropy within bf16's unit roundoff
    (2^-8, relative); (4) the last loss below the first; the reckoned bytes
    (weights, the float32 accumulator, the gradients autograd returns at
    once, the state) beside the measured peak; one more step under
    torch.profiler (launches, host syncs, idle share, the device time split
    into attention, the family's scan (Mamba2's SSD and the mLSTM's chunked
    scan, the sLSTM op), the optimizer, GEMMs and the rest); the bound (3 x
    ``forward_flops(cfg, 8, 2048)`` over the bf16 peak, plus the optimizer's
    bytes over HBM's rate) and the step's share of it; one "train depth
    summary" JSON line.  xlstm's steps launch ``slstm_scan_forward`` 48
    times (6 layers x 4 microbatches x forward and recompute) and
    ``slstm_scan_backward`` 24 times a step; every launch of the phase is
    counted into the ``kernels`` line.  No family is cut and none falls
    back: out of memory or a failed check fails the phase.
    """
    import copy
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.configs.base import get_config
    from repro_torch.core import SolveConfig, metrics, solve_es
    from repro_torch.data.pipeline import DataConfig, SyntheticTextTask
    from repro_torch.data.synthetic import synthetic_document
    from repro_torch.embeddings import BackboneEncoder, EncoderStage, problem_from_sentences
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import attention as attn
    from repro_torch.models import forward, init_params, param_tree, ssd, train_loss, xlstm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import LoopConfig, train

    t_phase = time.perf_counter()
    card = card_line()

    # ---------------------------------------------------------------- (a)
    cfg = get_config("sbert-paper")
    reset_counts()
    model = init_params(cfg, 0)
    state = opt.init(model)
    n_params = sum(p.numel() for p in model.parameters())
    step = tsteps.make_train_step(cfg, opt.OptConfig(peak_lr=3e-3, warmup_steps=20,
                                                     total_steps=ENCODER_STEPS))
    data = SyntheticTextTask(DataConfig(ENCODER_BATCH, ENCODER_SEQ), cfg.vocab_size)
    timed = []
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_encoder_"))
    try:
        t0 = time.perf_counter()
        with timed_saves() as saves:
            model, state, history = train(
                cfg, timed_steps(step, timed), model, state, data,
                LoopConfig(total_steps=ENCODER_STEPS, ckpt_every=ENCODER_CKPT_EVERY,
                           ckpt_dir=str(tmp), log_every=ENCODER_CKPT_EVERY),
                log=lambda line: print(f"train depth sbert-paper {line}"))
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        ms = [a.elapsed_time(e) for (a, e), _ in timed]
        losses = [h["loss"] for h in history]
        kept = ckpt.steps_available(tmp)
        want_saves = ENCODER_STEPS // ENCODER_CKPT_EVERY
        if len(saves) != want_saves or kept[-1] != ENCODER_STEPS:
            fail(f"train depth sbert-paper: {len(saves)} saves, checkpoints {kept}")
        fresh = init_params(cfg, 1)
        t0 = time.perf_counter()
        back = ckpt.restore(tmp, ENCODER_STEPS, {"params": fresh, "opt": opt.init(fresh)},
                            cfg=cfg)
        trained = ckpt.load_params(fresh, back["params"])
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        if differing(param_tree(trained), param_tree(model)) or differing(back["opt"], state):
            fail("train depth sbert-paper: the restored weights or state differ from the live "
                 "ones")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len(losses) != ENCODER_STEPS or not all(math.isfinite(x) for x in losses) \
            or losses[-1] >= losses[0]:
        fail(f"train depth sbert-paper: losses {losses[0]} -> {losses[-1]}")
    c = counts()
    if c != expect():
        fail(f"train depth sbert-paper: kernels of the port launched {c} in training")
    print(f"train depth sbert-paper: {n_params / 1e9:.4f} B parameters, {cfg.n_layers} layers, "
          f"d {cfg.d_model}, bf16, remat {cfg.remat}, microbatch {cfg.microbatch}; "
          f"{ENCODER_STEPS} steps of B {ENCODER_BATCH} x S {ENCODER_SEQ} through train() in "
          f"{t_train:.2f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f}; ms a step (CUDA events) "
          f"first {ms[0]:.2f}, median {percentile(ms[1:], 0.5):.2f}, p99 "
          f"{percentile(ms[1:], 0.99):.2f}, last {ms[-1]:.2f}; checkpoints at "
          f"{ENCODER_CKPT_EVERY}-step intervals: "
          + ", ".join(f"{gb(n)} in {t:.2f} s" for t, n in saves)
          + f"; kept {kept}; restored into a fresh model in {t_restore:.2f} s, weights and "
          f"state equal to the live ones bit for bit; {card}")

    # The trained encoder as the summarizer's embedder, on the card.
    sents = synthetic_document(3, 16)
    enc = BackboneEncoder(cfg, trained, max_len=512)
    problem = problem_from_sentences(sents, m=5, lam=0.5, encoder=enc)
    reset_counts()
    rep = solve_es(problem, prng.key(1), SolveConfig(solver="cobi", iterations=4, reads=8,
                                                     int_range=14))
    c = counts()
    if c != expect(cobi_trajectory=4, ising_energy=4):
        fail(f"train depth sbert-paper summary: launches {c}")
    for name in c:
        launches[name] += c[name]
    bounds = metrics.reference_bounds(problem)
    score = float(metrics.normalized_objective(rep.objective, bounds))
    chosen = rep.selection.nonzero()[0].tolist()
    print(f"train depth sbert-paper summary of synthetic_document(3, 16), M 5: selected "
          f"{chosen}, objective {rep.objective:.6f}, normalized {score:.6f} against exact "
          f"enumeration ({math.comb(16, 5)} subsets; bounds {bounds}); launches "
          f"{ {k: v for k, v in c.items() if v} }")
    for i in chosen:
        print(f"train depth sbert-paper summary:   - {sents[i]}")
    if len(chosen) != 5 or score <= 0.8:
        fail(f"train depth sbert-paper summary: {len(chosen)} selected, normalized {score}")

    # The same weights in the encoder stage: flash (the wgmma kernel at D 64)
    # against the chunked route.
    embs = {}
    for impl in ("flash", "auto"):
        reset_counts()
        with EncoderStage(cfg, trained, max_len=2048, attn_impl=impl) as stage:
            futs = [stage.submit(d) for _, d, _ in enc_docs]
            embs[impl] = [f.result(timeout=600) for f in futs]
            n_pass = stage.stats().launches
        c = counts()
        if c != expect(flash_attention=cfg.n_layers * n_pass if impl == "flash" else 0):
            fail(f"train depth sbert-paper stage {impl}: launches {c} ({n_pass} passes)")
        if impl == "flash":
            n_flash = add_flash_launches(launches, c, "wgmma")
    cos = min(float(F.cosine_similarity(a, b, dim=-1).min())
              for a, b in zip(embs["flash"], embs["auto"]))
    err = max(float((a - b).abs().max()) for a, b in zip(embs["flash"], embs["auto"]))
    finite = all(bool(torch.isfinite(e).all()) for e in embs["flash"])
    print(f"train depth sbert-paper stage: {len(enc_docs)} documents, flash ({n_flash} "
          f"flash_attention launches) against the chunked route: min sentence cosine "
          f"{cos:.6f}, max abs err {err:.3e}")
    if not finite or cos < 0.999:
        fail(f"train depth sbert-paper stage: flash against chunked, min cosine {cos}")
    del model, state, trained, fresh, back, enc, embs, step
    release()
    walls = {"a": time.perf_counter() - t_phase}

    # ---------------------------------------------------------------- (b)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    for name in TRAIN_DEPTH_FAMILIES:
        t_fam = time.perf_counter()
        cfg = get_config(name)
        release()
        torch.cuda.reset_peak_memory_stats()
        model = init_params(cfg, 0)
        n_params = sum(p.numel() for p in model.parameters())
        w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        state_dtype = TRAIN_DEPTH_STATE[name]
        s_size = 4 if state_dtype == "float32" else 2
        reckon = {dt: n_params * 8 + 3 * n_params * sz
                  for dt, sz in (("float32", 4), ("bfloat16", 2))}
        n_slstm = cfg.n_groups if cfg.family == "ssm" else 0
        label = f"{name} ({cfg.n_layers} layers"
        if cfg.encoder_layers:
            label += f" + {cfg.encoder_layers} encoder layers"
        label += f", bf16, microbatch {cfg.microbatch}, remat {cfg.remat})"
        print(f"train depth {label}: {n_params / 1e9:.4f} B parameters, weights {gb(w_bytes)}; "
              f"reckoned (weights 2, float32 accumulator 4, gradients 2, state 3 x 4 or 3 x 2 "
              f"bytes a parameter): float32 state {gb(reckon['float32'])}, bf16 state "
              f"{gb(reckon['bfloat16'])}; state {state_dtype} (fixed in TRAIN_DEPTH_STATE)")
        data = SyntheticTextTask(DataConfig(batch_size=b, seq_len=s), cfg.vocab_size)
        fixed = {k: torch.as_tensor(v, device=dev) for k, v in data.batch(0).items()}
        if cfg.n_frontend_tokens:
            fixed["frontend"] = torch.tensor(np.random.default_rng(0).standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32),
                device=dev).to(cfg.dtype)
        row0 = {k: v[:1] for k, v in fixed.items()}
        cut = lambda n: {k: (v if k == "frontend" else v[:, :n]) for k, v in row0.items()}
        own = [p for _, p in tree_parts(param_tree(model))]

        def grads_with(remat: bool, batch) -> list:
            with tsteps._trainable(own):
                tot, _ = train_loss(cfg.replace(remat=remat), model, batch)
                return list(torch.autograd.grad(tot, own))

        reset_counts()
        if n_slstm:
            # At its registered init (r drawn at fan-in NH) the sLSTM is
            # chaotic: its gradients over REMAT_SEQ positions are not
            # finite.  The family trains, and is checked, with r redrawn at
            # fan-in dh, as 4h and 4i hold it.
            bad = sum(int((~torch.isfinite(g)).sum()) for g in grads_with(True, cut(REMAT_SEQ)))
            dh = cfg.d_model // cfg.n_heads
            with torch.no_grad():
                for group in model.layers:
                    group.slstm.cell.r.mul_((cfg.n_heads / dh) ** 0.5)
            print(f"train depth {label}: at the registered init, bf16, B 1 x S {REMAT_SEQ}: "
                  f"{bad} non-finite gradient elements; r redrawn at fan-in dh (x "
                  f"{(cfg.n_heads / dh) ** 0.5:.4f}) for the checks and the steps")

        # (1) The gradient check, part by part, on a float32 copy.
        t0 = time.perf_counter()
        cfg32 = cfg.replace(param_dtype="float32")
        m32 = copy.deepcopy(model).to(torch.float32)
        b32 = {k: v.to(torch.float32) if k == "frontend" else v
               for k, v in cut(GRADCHECK_SEQ).items()}
        parts = model_parts(cfg32, m32)
        n_parts = len(parts)
        leaves = [p for _, ps in parts for p in ps]
        with tsteps._trainable(leaves):
            total, _ = train_loss(cfg32, m32, b32)
            grads = torch.autograd.grad(total, leaves)
        g_of = {id(p): g for p, g in zip(leaves, grads)}
        del grads

        def f32_loss() -> float:
            with torch.no_grad():
                return float(train_loss(cfg32, m32, b32)[0])

        f0 = float(total.detach())
        noise = abs(f32_loss() - f0)
        rows, worst = [], 0.0
        with torch.no_grad():
            for plabel, ps in parts:
                g = [g_of[id(p)] for p in ps]
                gn = float(torch.sqrt(sum(torch.sum(x.double() ** 2) for x in g)))
                if not gn > 0 or not math.isfinite(gn):
                    fail(f"train depth {name} gradient check: |g| of {plabel} is {gn}")
                eps = DEPTH_DELTA * abs(f0) / gn
                saved = [p.clone() for p in ps]
                f_side = []
                for sign in (1.0, -1.0):
                    for p, x in zip(ps, g):
                        p.add_(x, alpha=sign * eps / gn)
                    f_side.append(f32_loss())
                    for p, w in zip(ps, saved):
                        p.copy_(w)
                deriv = (f_side[0] - f_side[1]) / (2 * eps)
                rel = abs(deriv - gn) / gn
                worst = max(worst, rel)
                rows.append(f"{plabel} |g| {gn:.4e} eps {eps:.3e} D {deriv:.4e} rel {rel:.1e}")
                if not rel <= GRADCHECK_TOL:
                    fail(f"train depth {name} gradient check: {plabel}: the central difference "
                         f"{deriv} against |g| {gn} (relative {rel} > {GRADCHECK_TOL})")
        print(f"train depth {label} gradient check (float32 copy, TF32 off, B 1 x S "
              f"{GRADCHECK_SEQ}" + (", sLSTM r at fan-in dh" if n_slstm else "")
              + f"): loss {f0:.6f}, a repeated forward differs by {noise:.3e} (the loss's "
              f"float32 ulp {float(np.spacing(np.float32(f0))):.3e}); {n_parts} parts, worst "
              f"relative error {worst:.2e} (bar {GRADCHECK_TOL}) in "
              f"{time.perf_counter() - t0:.1f} s: " + "; ".join(rows))
        del m32, g_of, total, parts, leaves
        release()

        # (2) Remat on against off, bf16, B 1 x S 512.
        t0 = time.perf_counter()
        b512 = cut(REMAT_SEQ)

        def gap(xs, ys) -> float:
            return max(float((x.float() - y.float()).abs().max()) for x, y in zip(xs, ys))

        on = grads_with(True, b512)
        spread = gap(on, grads_with(True, b512))
        off = grads_with(False, b512)
        bitwise = all(torch.equal(x, y) for x, y in zip(on, off))
        diff = gap(on, off)
        print(f"train depth {label} remat on against off (bf16, B 1 x S {REMAT_SEQ}, "
              f"{len(own)} gradient tensors): two runs with remat on differ by {spread:.3e}; on "
              f"against off {diff:.3e}: " + ("bit for bit" if bitwise else
                                             "within twice the spread" if diff <= 2 * spread
                                             else "differs") + f" ({time.perf_counter() - t0:.1f} s)")
        if not bitwise and (spread == 0 or diff > 2 * spread):
            fail(f"train depth {name}: remat on and off give gradients {diff} apart (remat on "
                 f"against itself {spread})")
        del on, off
        release()

        # (3) The serving forward's cross-entropy on the fixed batch.
        mb = cfg.microbatch
        size = b // mb
        with torch.no_grad():
            ce = 0.0
            for i in range(mb):
                part = {k: v[i * size:(i + 1) * size] for k, v in fixed.items()}
                logits, _, _ = forward(cfg, model, part["tokens"], mode="train",
                                       frontend=part.get("frontend"))
                ce += float(F.cross_entropy(logits.flatten(0, 1), part["targets"].flatten().long(),
                                            ignore_index=-1)) / mb
                del logits
        # The checks' sLSTM launches: the registered init's gradients
        # (forward, remat's recomputation, backward), the gradient check's
        # (the same), its repeated forward and two forwards a part, remat on
        # twice and off once, a forward a microbatch.
        checks = counts()
        want = expect(slstm_scan=n_slstm * (10 + 2 * n_parts + mb),
                      slstm_scan_backward=5 * n_slstm)
        if checks != want:
            fail(f"train depth {name}: the checks launched {checks}, want {want}")

        # The steps: FIXED_STEPS on the fixed batch.
        ocfg = opt.OptConfig(warmup_steps=1, total_steps=FIXED_STEPS,
                             state_dtype=state_dtype)
        state = opt.init(model, ocfg)
        s_bytes = sum(t.numel() * t.element_size() for key in ("master", "mu", "nu")
                      for _, t in tree_parts(state[key]))
        step = tsteps.make_train_step(cfg, ocfg)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        timed = []
        timed_step = timed_steps(step, timed)
        t0 = time.perf_counter()
        for _ in range(FIXED_STEPS):
            model, state, _ = timed_step(model, state, fixed)
        torch.cuda.synchronize()
        t_steps = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        stepped = counts()
        ms = [a.elapsed_time(e) for (a, e), _ in timed]
        losses = [float(m["loss"]) for _, m in timed]
        norms = [float(m["grad_norm"]) for _, m in timed]
        med = percentile(ms[1:], 0.5)
        want_steps = expect(slstm_scan=2 * mb * n_slstm * FIXED_STEPS,
                            slstm_scan_backward=mb * n_slstm * FIXED_STEPS)
        print(f"train depth {label}: {FIXED_STEPS} steps of B {b} x S {s} on one batch at "
              f"OptConfig(warmup_steps=1) in {t_steps:.2f} s; ms a step (CUDA events) "
              + " ".join(f"{x:.1f}" for x in ms) + f"; warm median {med:.2f} ms "
              f"({b * s / med * 1e3:.1f} tokens/s); losses " + " ".join(f"{x:.4f}" for x in losses)
              + "; grad norms " + " ".join(f"{x:.4f}" for x in norms)
              + f"; the serving forward's cross-entropy {ce:.6f}")
        print(f"train depth {label} memory: peak {gb(peak)} over the steps; reckoned "
              f"{gb(reckon[state_dtype])} (weights {gb(w_bytes)}, float32 accumulator "
              f"{gb(4 * n_params)}, gradients {gb(2 * n_params)}, {state_dtype} state "
              f"{gb(s_bytes)}), peak - reckoned {gb(peak - reckon[state_dtype])} "
              f"(activations, the logits, workspace); {card}")
        if not all(math.isfinite(x) for x in losses + norms):
            fail(f"train depth {name}: losses {losses}, grad norms {norms}")
        if abs(losses[0] - ce) > 2.0**-8 * abs(ce):
            fail(f"train depth {name}: the first step's loss {losses[0]} against the serving "
                 f"forward's cross-entropy {ce}: beyond bf16's unit roundoff")
        if losses[-1] >= losses[0]:
            fail(f"train depth {name}: on one batch the loss went {losses[0]} -> {losses[-1]}")
        if stepped != want_steps:
            fail(f"train depth {name}: the steps launched {stepped}, want {want_steps}")

        # One more step under the profiler.
        scans = [(ssd, "chunked_linear_attention", "scan"), (xlstm, "chunked_linear_attention",
                                                             "scan"), (ops, "slstm_scan", "scan")]
        with spanned([(attn, "_sdpa_chunked", "attention"), (attn, "_sdpa", "attention"),
                      (opt, "apply_updates", "optimizer"), *scans]):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model, state, met = step(model, state, fixed)
                loss = float(met["loss"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        split = decode_split(prof, wall, 1, prefix="train.",
                             regions=("attention", "scan", "optimizer"))
        del prof
        tail = counts()
        want = {k: v * (FIXED_STEPS + 1) // FIXED_STEPS for k, v in want_steps.items()}
        if tail != want:
            fail(f"train depth {name}: {FIXED_STEPS + 1} steps launched {tail}, want {want}")
        for k in ("slstm_scan", "slstm_scan_backward"):
            launches[k] += checks[k] + tail[k]
        n_scan = {k: checks[k] + tail[k] for k in ("slstm_scan", "slstm_scan_backward")}
        print(f"train depth {label} step profile (step {FIXED_STEPS + 1}, loss {loss:.4f}): "
              f"{json.dumps(split)}")
        if n_slstm:
            print(f"train depth {label}: slstm_scan launches {n_scan['slstm_scan']}, "
                  f"slstm_scan_backward {n_scan['slstm_scan_backward']}: a step "
                  f"{want_steps['slstm_scan'] // FIXED_STEPS} and "
                  f"{want_steps['slstm_scan_backward'] // FIXED_STEPS} ({n_slstm} layers x {mb} "
                  f"microbatches, forward and recompute / backward) over {FIXED_STEPS + 1} steps, "
                  f"and the checks' {checks['slstm_scan']} and {checks['slstm_scan_backward']}")

        # The bound: 3 x the forward's FLOP (forward and backward; remat's
        # recomputation is not model work) over the bf16 peak, plus the
        # optimizer's bytes (read a weight, its float32 gradient and the
        # state, write the weight and the state) over HBM's rate.
        flop = 3 * forward_flops(cfg, b, s)
        opt_bytes = n_params * (2 + 4 + 3 * s_size + 2 + 3 * s_size)
        model_ms, opt_ms = flop / PEAK_BF16_FLOPS * 1e3, opt_bytes / PEAK_BYTES_PER_S * 1e3
        bound = model_ms + opt_ms
        print(f"train depth {label} bound: {flop / 1e12:.2f} TFLOP, {model_ms:.2f} ms at "
              f"{PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s (operations); optimizer {gb(opt_bytes)}, "
              f"{opt_ms:.2f} ms (bytes); bound {bound:.2f} ms a step; the warm median is "
              f"{med / bound:.2f}x it (share {bound / med:.4f}); {card}")
        print("train depth summary " + json.dumps({
            "name": name, "card": card, "batch": b, "seq": s, "microbatch": mb,
            "remat": cfg.remat, "state_dtype": state_dtype, "parameters": n_params,
            "step_ms": ms, "step_ms_median": med, "tokens_s": b * s / med * 1e3,
            "losses": losses, "grad_norms": norms, "serving_ce": ce,
            "peak_memory_bytes": peak, "reckoned_bytes": reckon[state_dtype],
            "reckoned_bytes_bf16_state": reckon["bfloat16"], "bound_ms": bound,
            "bound_share": bound / med, "launches_a_step": split["launches_a_step"],
            "host_syncs_a_step": split["host_syncs_a_step"],
            "idle_share": split["idle_share"], "split_ms": split["split_ms_a_step"],
            "gradcheck_worst_rel": worst, "gradcheck_noise": noise, "remat_spread": spread,
            "remat_diff": diff, "slstm_launches": n_scan,
            "wall_s": time.perf_counter() - t_fam}))
        del model, state, step, fixed, row0, b512, own, data
        release()
        walls[name] = time.perf_counter() - t_fam
    print(f"train depth phase wall: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")


def distributed_phase(dev, reset_counts, counts, expect, launches, train) -> None:
    """Phase 4j: the mesh and distributed layer on the card.

    The dry run of (c) starts first, in two subprocesses on the host's
    cores, while the card works.  (a) A one-rank NCCL group (a file store
    in a temporary directory) and a 1 x 1 ``DeviceMesh`` on ``cuda``:
    ``fleet_solve`` at D 256 x R 32 x N 64 x 1,000 steps, one rank's shard
    of the dry run's 16 x 16 fleet cell, on phase 4i's chip-integer
    instances scaled by powers of two (``train["h_s"]``, ``["j_s"]``): its
    spins and energies bit for bit against ``make_ising_solve_step`` on the
    same pre-scaled inputs and phases (energies scaled back the same way),
    the two kernel launches of a call (added to the kernels line) and its
    collectives (three all-reduces, two all-gathers), ms warm, and the peak
    memory beside the dry run's prediction for the cell.  (b) tinyllama-1.1b
    at full width, ``init_params(seed 0)``, one ``make_train_step`` step of
    ``SyntheticTextTask``'s batch 0 (B 8 x 2,048) unsharded and one over the
    mesh, each model built afresh from the seed: the losses within
    SHARDED_LOSS_TOL, then a second step of each under torch.profiler, its
    ms and device launches beside phase 4i's (DTensor's dispatch is host
    work).  (c) ``python -m repro_torch.launch.dryrun --arch tinyllama-1.1b
    --shape train_4k --mesh single`` and ``--arch ising-fleet --mesh
    single``: exit 0 and an ``ok`` record each, printed.
    """
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTextTask
    from repro_torch.distributed import fleet
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import init_params
    from repro_torch.train import optimizer as opt

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    cells = {"tinyllama-1.1b__train_4k__single": ["--arch", "tinyllama-1.1b", "--shape",
                                                  "train_4k", "--mesh", "single"],
             "ising-fleet__solve__single": ["--arch", "ising-fleet", "--mesh", "single"]}
    dry = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", str(tmp / "dry")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in cells.items()}
    try:
        dist.init_process_group("nccl", init_method=f"file://{tmp / 'store'}", rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
        mesh = tmesh.make_mesh((1, 1), ("data", "model"))
        print(f"distributed: one-rank {dist.get_backend()} group, mesh {mesh}")

        # ------------------------------------------------------------ (a)
        h_s, j_s = train["h_s"], train["j_s"]
        d, n = h_s.shape
        r = FLEET_READS
        key = prng.key(7)
        denom = 2.0 * torch.amax(torch.sum(torch.abs(j_s), dim=-1), dim=-1) + torch.amax(
            torch.abs(h_s), dim=-1)
        denom = torch.clamp(denom, min=1e-9)[:, None]
        phi0 = prng.uniform(key, (d, r, n), 0.0, 2.0 * math.pi, device=dev)
        want_s, want_e = tsteps.make_ising_solve_step(steps=FLEET_STEPS)(
            h_s / denom, j_s / denom[..., None], phi0)
        want_e = want_e * denom[:, 0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = dict(fleet.COLLECTIVES)
        reset_counts()
        got_s, got_e = fleet.fleet_solve(mesh, h_s, j_s, key, replicas_per_device=r,
                                         steps=FLEET_STEPS)
        torch.cuda.synchronize()
        c = counts()
        peak = torch.cuda.max_memory_allocated() - base
        coll = {k: v - before.get(k, 0) for k, v in fleet.COLLECTIVES.items()}
        if c != expect(cobi_trajectory_batched=1, ising_energy_batched=1):
            fail(f"distributed fleet: a call launched {c}; want one batched trajectory and one "
                 "batched energy")
        for name in ("cobi_trajectory_batched", "ising_energy_batched"):
            launches[name] += c[name]
        if coll != {"all_reduce": 3, "all_gather": 2}:
            fail(f"distributed fleet: collectives {coll}; want 3 all-reduces and 2 all-gathers")
        same_s, same_e = torch.equal(got_s, want_s), torch.equal(got_e, want_e)
        if not (same_s and same_e):
            fail(f"distributed fleet: spins equal {same_s}, energies equal {same_e} against "
                 "make_ising_solve_step on the same inputs")
        warm_ms = cuda_ms(lambda: fleet.fleet_solve(mesh, h_s, j_s, key, replicas_per_device=r,
                                                    steps=FLEET_STEPS), reps=3, warmup=1)
        reset_counts()
        print(f"distributed fleet (fleet_solve, D {d} x R {r} x N {n}, {FLEET_STEPS} steps, "
              f"one rank of the 16 x 16 cell): spins and energies == make_ising_solve_step bit "
              f"for bit; launches a call {{'cobi_trajectory_batched': 1, "
              f"'ising_energy_batched': 1}}; collectives a call {coll}; warm {warm_ms:.3f} ms "
              f"(CUDA events); peak memory above the inputs {gb(peak)}")

        # ------------------------------------------------------------ (b)
        cfg = get_config("tinyllama-1.1b")
        ocfg = opt.OptConfig(total_steps=4)
        data = SyntheticTextTask(DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                                 cfg.vocab_size)
        runs = {}
        for name, step_mesh in (("unsharded", None), ("sharded", mesh)):
            gc.collect()
            torch.cuda.empty_cache()
            model = init_params(cfg, 0)
            state = opt.init(model)
            step = tsteps.make_train_step(cfg, ocfg, mesh=step_mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, state, m = step(model, state, data.batch(0))
            loss = float(m["loss"])
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model, state, m = step(model, state, data.batch(1))
                float(m["loss"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            split = decode_split(prof, wall, 1, prefix="train.", regions=())
            runs[name] = {"loss": loss, "first_s": first, "wall_ms": wall * 1e3,
                          "launches": split["launches_a_step"],
                          "busy_ms": split["busy_ms_a_step"], "idle_share": split["idle_share"],
                          "placements": str(getattr(model.embed, "placements", None))}
            del model, state, m, prof
        if counts() != expect():
            fail(f"distributed train: kernels of the port launched {counts()}; the train path "
                 "has none")
        diff = abs(runs["sharded"]["loss"] - runs["unsharded"]["loss"])
        print("distributed train tinyllama-1.1b (B 8 x 2048, one step from init_params(0)): "
              + json.dumps(runs) + f"; loss difference {diff:.3e}; phase 4i's warm step "
              f"{train['step_ms']:.1f} ms, {train['launches_a_step']:.0f} launches")
        if not diff <= SHARDED_LOSS_TOL or "Shard" not in runs["sharded"]["placements"]:
            fail(f"distributed train: sharded loss {runs['sharded']['loss']} against "
                 f"{runs['unsharded']['loss']}, embed placements "
                 f"{runs['sharded']['placements']}")
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    # ---------------------------------------------------------------- (c)
    try:
        for name, proc in dry.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                fail(f"distributed dry run {name}: exit {proc.returncode}: {err[-2000:]}")
            rec = json.loads((tmp / "dry" / f"{name}.json").read_text())
            print(f"distributed dry run: {out.strip()}")
            print(f"distributed dry run record {name}: " + json.dumps(
                {k: rec.get(k) for k in ("status", "chips", "seconds", "arg_bytes_per_chip",
                                         "peak_bytes_per_chip", "flops_per_chip",
                                         "collectives_per_chip", "fits")}))
            if rec.get("status") != "ok":
                fail(f"distributed dry run {name}: {rec.get('status')} {rec.get('error')}")
            if name.startswith("ising-fleet"):
                print(f"distributed fleet peak memory on the card {gb(peak)} against the dry "
                      f"run's per-rank peak {gb(rec['peak_bytes_per_chip'])} (plain versions "
                      f"on the host, fake tensors)")
    finally:
        for proc in dry.values():
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"distributed phase wall: {time.perf_counter() - t_phase:.1f} s")


SLSTM_DRY_CELLS = ("train_4k", "prefill_32k")


def start_slstm_dry_runs() -> dict:
    """Phase 4k (e)'s dry runs, started at once in subprocesses on the host's
    cores (no GPU): ``python -m repro_torch.launch.dryrun --arch xlstm-1.3b
    --shape <cell> --mesh single`` for each of SLSTM_DRY_CELLS, records in a
    temporary directory.  Every process is killed at exit if still running."""
    import atexit
    import tempfile

    out = Path(tempfile.mkdtemp(prefix="chip_smoke_slstm_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "xlstm-1.3b", "--shape",
         cell, "--mesh", "single", "--out", str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT) for cell in SLSTM_DRY_CELLS}

    def stop() -> None:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return {"procs": procs, "out": out, "t0": time.perf_counter(), "stop": stop}


def slstm_phase(dev, launches, dry) -> list:
    """Phase 4k: the sLSTM scan kernels (``csrc/slstm_scan.cu``) at
    xlstm-1.3b's call, B 2, S 2,048, D 2,048, 4 heads of 512, float32.

    (a) The forward kernel against ``slstm_scan_plain`` on the card, the
    registered init (``xlstm.Slstm`` from a generator seeded 0 on the card;
    wx = x @ w_in for x ~ N(0, 1)): hs over the first SLSTM_STEPS steps
    (the recurrence is chaotic there, PERF.md §7); then r redrawn at fan-in
    dh (a contractive recurrence): hs, the final c, n, h, m and the saved
    pre-activations and states over all 2,048 steps, each within 2e-5
    (rtol = atol); the decode launch (B 4, S 1, from the plain version's
    state after 16 steps, at the registered init) within the same bar,
    and its time.  (b) The backward kernel against
    ``slstm_scan_backward_plain`` at B 2 x S 256 and at xlstm-1.3b's own
    call, B 2 x S 2,048, r at fan-in dh, from the
    kernel's saved tensors and N(0, 1) gradients of hs and of the final
    state: d_wx (= d_pre), d_r (the per-head product outside) and d_bias,
    and the starting c, h, n's gradients, each within 1e-4 of its largest
    magnitude; the starting stabiliser's (a sum of cancelling terms)
    against the plain version in float64; a second launch equal bit for
    bit; the same at B 40 x S 8 (B x units a block past the kernel's 256
    threads, so a cell thread takes more than one row and a step more than
    one gather).  (c) Times at B 2 x S 2,048 (CUDA events): the forward as
    the main path calls it (nothing saved) and saving for the backward, the
    backward, one rep of each plain version, the bounds, microseconds a
    step; each kernel's timed instance once (``slstm_scan.step_split``: its
    outputs equal the kernel's bit for bit, each phase's mean ns a step in
    block 0 and in the block that published last); ptxas's registers and
    spills for both kernels (from the build's log; a spill in either fails
    the phase); and the exchange alone (``slstm_scan.exchange_probe``: S
    rounds of publish and gather on the forward's grid with no arithmetic,
    the scans' chain floor; the flag scheme beside it).  (d) is phase 4g's
    xlstm-1.3b pass line.  (e) The dry runs
    started by :func:`start_slstm_dry_runs`: exit 0, an ``ok`` record each,
    printed with their walls.  Returns the two
    rows of the ``kernels`` line (their launches are filled from the main
    path's counts of phases 4g, 4h and 4i).
    """
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import slstm_scan as ks
    from repro_torch.models.xlstm import Slstm

    t_phase = time.perf_counter()
    cfg = get_config("xlstm-1.3b")
    b, s, d, nh = 2, 2048, cfg.d_model, cfg.n_heads
    dh = d // nh
    tol_fwd, tol_bwd, s_bwd = 2e-5, 1e-4, 256
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cell = Slstm(cfg, gen)
    r = cell.r.to(torch.float32).contiguous()
    bias = cell.bias.contiguous()
    x = torch.randn((b, s, d), generator=gen, device=dev, dtype=torch.float32)
    wx = (x @ cell.w_in.to(torch.float32)).contiguous()
    zeros = torch.zeros((b, d), device=dev)
    state = (zeros, zeros + 1e-6, zeros.clone(), zeros.clone())
    fwd_plan, bwd_plan = ks.plan(b, d, nh), ks.plan(b, d, nh, backward=True)
    print(f"slstm plan at B {b}, D {d}, NH {nh}: forward {fwd_plan}, backward {bwd_plan}")
    # ptxas's report (the build keeps it beside the library): registers and
    # spills of each kernel; r's slice lives in registers, so a spill fails.
    # The instances' template flags: forward and backward <timed, exact>,
    # the exchange probe <tagged>.
    spills, kernel, name = [], None, ""
    for line in _build._target("slstm_scan").with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line:
            found = re.search(r"slstm_(forward|backward|exchange)_kernelI((?:Lb[01]E)+)", line)
            kernel = found and found.group(1)
            if kernel:
                flags = [f == "1" for f in re.findall(r"Lb([01])E", found.group(2))]
                kind = (("tagged" if flags[0] else "flags") if kernel == "exchange" else
                        ("timed, " if flags[0] else "") + ("exact" if flags[1] else "guarded"))
                name = f"slstm {kernel} kernel ({kind})"
        elif kernel and ("spill" in line or "registers" in line):
            print(f"{name} ptxas: {line.strip().removeprefix('ptxas info    : ')}")
            spilled = re.search(r"(\d+) bytes spill stores", line)
            if kernel != "exchange" and spilled and int(spilled.group(1)) > 0:
                spills.append(f"{name}: {line.strip()}")
    if spills:
        fail(f"slstm kernels spill registers: {spills}")

    def max_err(a, b_) -> float:
        return float((a - b_).abs().max())

    # ---------------------------------------------------------------- (a)
    got = ks.slstm_scan_cuda(wx, r, bias, *state, save=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ks.slstm_scan_plain(wx, r, bias, *state, save=True)
    torch.cuda.synchronize()
    plain_fwd_s = time.perf_counter() - t0
    held = slice(0, SLSTM_STEPS)
    err_first = max_err(got[0][:, held], want[0][:, held])
    by_step = (got[0] - want[0]).abs().amax(dim=(0, 2))
    print(f"slstm forward vs plain, registered init (r at fan-in {nh}), B {b} S {s}: hs max abs "
          f"err over steps 0-{SLSTM_STEPS - 1} {err_first:.3e} (bar {tol_fwd}); by step "
          + " ".join(f"{t}: {float(by_step[t]):.1e}" for t in (0, 4, 8, 16, 64, 256, 2047)))
    if not torch.allclose(got[0][:, held], want[0][:, held], rtol=tol_fwd, atol=tol_fwd):
        fail(f"slstm forward vs plain at the registered init: {err_first} > {tol_fwd}")
    r_dh = (r * (nh / dh) ** 0.5).contiguous()
    got = ks.slstm_scan_cuda(wx, r_dh, bias, *state, save=True)
    want = ks.slstm_scan_plain(wx, r_dh, bias, *state, save=True)
    names = ("hs", "c", "n", "h", "m", "pre", "cnm")
    errs = {k: max_err(g, w) for k, g, w in zip(names, got, want)}
    print(f"slstm forward vs plain, r at fan-in {dh}, B {b} S {s}, every step: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (bar {tol_fwd})")
    bad = [k for k, g, w in zip(names, got, want)
           if not torch.allclose(g, w, rtol=tol_fwd, atol=tol_fwd)]
    if bad:
        fail(f"slstm forward vs plain with r at fan-in dh: {bad} beyond {tol_fwd}: {errs}")
    err_fwd = max(err_first, errs["hs"])
    del got, want
    # The decode launch (phase 4h (4)): B 4, S 1, from a nonzero state (the
    # plain version's after 16 steps), at the registered init.
    wx4 = (torch.randn((4, 17, d), generator=gen, device=dev) @ cell.w_in.to(torch.float32))
    z4 = torch.zeros((4, d), device=dev)
    st4 = ks.slstm_scan_plain(wx4[:, :16].contiguous(), r, bias, z4, z4 + 1e-6, z4.clone(),
                              z4.clone())[1:5]
    one = (wx4[:, 16:].contiguous(), r, bias, *st4)
    got, want = ks.slstm_scan_cuda(*one)[:5], ks.slstm_scan_plain(*one)[:5]
    errs4 = {k: max_err(g, w) for k, g, w in zip(names, got, want)}
    step_ms = cuda_ms(lambda: ks.slstm_scan_cuda(*one), reps=50)
    print(f"slstm forward vs plain, the decode launch (B 4, S 1, from the state after 16 steps; "
          f"registered init): max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs4.items())
          + f" (bar {tol_fwd}); {step_ms * 1e3:.2f} us a launch (CUDA events, 50 back to back)")
    if not all(torch.allclose(g, w, rtol=tol_fwd, atol=tol_fwd) for g, w in zip(got, want)):
        fail(f"slstm forward vs plain at the decode launch: {errs4} beyond {tol_fwd}")
    err_fwd = max(err_fwd, errs4["hs"])
    del got, want, wx4, st4, one

    # ---------------------------------------------------------------- (b)
    def backward_case(wx_b, bb, ss):
        """The backward kernel against its plain version at B bb x S ss, r at
        fan-in dh: the relative errors and d_wx's max abs error."""
        hs, c, n, h, m, pre, cnm = ks.slstm_scan_cuda(wx_b, r_dh, bias, *state_of(bb), save=True)
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        d_hs = torch.randn((bb, ss, d), generator=g, device=dev)
        d_fin = [torch.randn((bb, d), generator=g, device=dev) for _ in range(4)]
        st = state_of(bb)
        bwd_args = (d_hs, *d_fin, r_dh, pre, cnm, st[0], st[1], st[3])
        k_out = ks.slstm_scan_backward_cuda(*bwd_args)
        again = ks.slstm_scan_backward_cuda(*bwd_args)
        p_out = ks.slstm_scan_backward_plain(*bwd_args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, a2) for a, a2 in zip(k_out, again)):
            fail(f"slstm backward at B {bb}: two launches on the same inputs differ")

        def d_r_of(d_pre):
            h_prev = torch.cat([st[2][:, None], hs[:, :-1]], dim=1).reshape(bb * ss, nh, dh)
            return torch.matmul(h_prev.permute(1, 2, 0),
                                d_pre.reshape(bb * ss, nh, 4 * dh).transpose(0, 1))

        pairs = {"d_wx": (k_out[0], p_out[0]), "d_r": (d_r_of(k_out[0]), d_r_of(p_out[0])),
                 "d_bias": (k_out[0].sum((0, 1)), p_out[0].sum((0, 1)))}
        pairs.update({f"d_{k}0": (a, w) for k, a, w in zip("cnh", k_out[1:4], p_out[1:4])})
        rel = {k: max_err(a, w) / max(float(w.abs().max()), 1e-30)
               for k, (a, w) in pairs.items()}
        # d_m0, the starting stabiliser's gradient, is a sum of terms that
        # cancel and is small from the model's starting state (c0 0, n0
        # 1e-6): float32 rounding is a large share of it in the plain version
        # too.  So it is held against the plain version in float64 on the
        # same inputs: no farther than 4x the float32 plain version is, plus
        # 1e-4 of its size.
        p64 = ks.slstm_scan_backward_plain(*(t.double() for t in bwd_args))[4]
        err_k64, err_p64 = max_err(k_out[4].double(), p64), max_err(p_out[4].double(), p64)
        m_bar = 4 * err_p64 + tol_bwd * float(p64.abs().max())
        print(f"slstm backward vs plain, r at fan-in {dh}, B {bb} S {ss}: max abs err / max "
              "magnitude " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
              + f" (bar {tol_bwd}); d_m0 (largest {float(p64.abs().max()):.3e}) against the "
              f"float64 plain: kernel {err_k64:.3e}, float32 plain {err_p64:.3e} (bar "
              f"{m_bar:.3e}); two launches equal bit for bit")
        if any(v > tol_bwd for v in rel.values()) or err_k64 > m_bar:
            fail(f"slstm backward vs plain at B {bb}: {rel} beyond {tol_bwd}, or d_m0 {err_k64} "
                 f"> {m_bar}")
        return max_err(*pairs["d_wx"])

    def state_of(bb):
        z = torch.zeros((bb, d), device=dev)
        return (z, z + 1e-6, z.clone(), z.clone())

    err_bwd = backward_case(wx[:, :s_bwd].contiguous(), b, s_bwd)
    # xlstm-1.3b's own call, B 2 x S 2,048, where (c) times the kernel.
    err_bwd = max(err_bwd, backward_case(wx, b, s))
    # B 40: B x units a block past the kernel's 256 threads, so a cell
    # thread takes more than one row and a step more than one gather.
    x40 = torch.randn((40, 8, d), generator=gen, device=dev, dtype=torch.float32)
    err_bwd = max(err_bwd, backward_case((x40 @ cell.w_in.to(torch.float32)).contiguous(), 40, 8))
    del x40
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    d_fin = [torch.randn((b, d), generator=g, device=dev) for _ in range(4)]

    # ---------------------------------------------------------------- (c)
    fwd_ms = cuda_ms(lambda: ks.slstm_scan_cuda(wx, r, bias, *state), reps=10)
    save_ms = cuda_ms(lambda: ks.slstm_scan_cuda(wx, r_dh, bias, *state, save=True), reps=5)
    hs, c, n, h, m, pre, cnm = ks.slstm_scan_cuda(wx, r_dh, bias, *state, save=True)
    d_hs = torch.randn((b, s, d), generator=g, device=dev)
    bwd_args = (d_hs, *d_fin, r_dh, pre, cnm, state[0], state[1], state[3])
    bwd_ms = cuda_ms(lambda: ks.slstm_scan_backward_cuda(*bwd_args), reps=5)
    plain_fwd_ms = cuda_ms(lambda: ks.slstm_scan_plain(wx, r, bias, *state), reps=1, warmup=0)
    plain_bwd_ms = cuda_ms(lambda: ks.slstm_scan_backward_plain(*bwd_args), reps=1, warmup=0)
    floor_ms = cuda_ms(lambda: ks.exchange_probe(b, d, nh, s), reps=5)
    flags_ms = cuda_ms(lambda: ks.exchange_probe(b, d, nh, s, tagged=False), reps=3)
    splits = {}
    for which, args, kernel in (
            ("forward", (wx, r_dh, bias, *state, True), ks.slstm_scan_cuda),
            ("backward", bwd_args, ks.slstm_scan_backward_cuda)):
        split, timed_out = ks.step_split(which == "backward", *args)
        plain_out = kernel(*args)
        if not all(torch.equal(x, y) for x, y in zip(timed_out, plain_out)):
            fail(f"slstm {which}: the timed instance's outputs differ from the kernel's")
        if not split["complete"]:
            fail(f"slstm {which} split: a step's arrival counter is short of the grid")
        splits[which] = split
        for who, label in (("block0", "block 0"), ("last", "the block that published last")):
            print(f"slstm {which} step split at B {b} S {s}, {label}, ns a step (mean of {s}): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in split[who].items())
                  + f"; sum {split[who + '_sum']:.1f} (SM clock {split['ghz']:.3f} GHz)")
    flops = 2 * b * s * nh * dh * 4 * dh
    f32 = 4
    fwd_bytes = f32 * (wx.numel() + r.numel() + bias.numel() + 4 * b * d + b * s * d + 4 * b * d)
    bwd_bytes = f32 * (d_hs.numel() + 4 * b * d + r.numel() + pre.numel() + cnm.numel()
                       + 3 * b * d + pre.numel() + 4 * b * d)
    f_ms, f_by = bound_ms(flops, fwd_bytes)
    b_ms, b_by = bound_ms(flops, bwd_bytes)
    print(f"time slstm_scan at B {b} S {s} D {d} NH {nh} float32: kernel {fwd_ms:.4f} ms "
          f"({fwd_ms * 1e3 / s:.3f} us a step), saving for the backward {save_ms:.4f} ms, plain "
          f"{plain_fwd_ms:.4f} ms (one rep; {plain_fwd_s:.3f} s in (a)), bound {f_ms:.6f} ms "
          f"({f_by}, {flops / 1e9:.2f} GFLOP, {fwd_bytes / 1e6:.1f} MB), {flops / fwd_ms / 1e9:.2f} "
          f"TFLOP/s; the exchange alone (chain floor) {floor_ms:.4f} ms for {s} rounds "
          f"({floor_ms * 1e3 / s:.3f} us a round; the flag scheme {flags_ms * 1e3 / s:.3f} us)")
    print(f"time slstm_scan_backward at B {b} S {s}: kernel {bwd_ms:.4f} ms "
          f"({bwd_ms * 1e3 / s:.3f} us a step), plain {plain_bwd_ms:.4f} ms (one rep), bound "
          f"{b_ms:.6f} ms ({b_by}, {flops / 1e9:.2f} GFLOP, {bwd_bytes / 1e6:.1f} MB); saved for "
          f"it: pre {pre.numel() * f32 / 1e6:.1f} MB + states {cnm.numel() * f32 / 1e6:.1f} MB "
          f"at B {b} S {s}, {(16 * 4096 * 7 * d) * f32 / 1e9:.2f} GB at B 16 S 4096")
    del hs, c, n, h, m, pre, cnm, bwd_args, d_hs

    # ---------------------------------------------------------------- (e)
    try:
        for cell_name, proc in dry["procs"].items():
            out, err = proc.communicate(timeout=900)
            wall = time.perf_counter() - dry["t0"]
            if proc.returncode != 0:
                fail(f"slstm dry run {cell_name}: exit {proc.returncode}: {err[-2000:]}")
            rec = json.loads((dry["out"] / f"xlstm-1.3b__{cell_name}__single.json").read_text())
            print(f"slstm dry run: {out.strip()}")
            print(f"slstm dry run record xlstm-1.3b x {cell_name} (done {wall:.1f} s after its "
                  "start): " + json.dumps(
                      {k: rec.get(k) for k in ("status", "chips", "seconds", "arg_bytes_per_chip",
                                               "peak_bytes_per_chip", "flops_per_chip",
                                               "collectives_per_chip", "fits")}))
            if rec.get("status") != "ok":
                fail(f"slstm dry run {cell_name}: {rec.get('status')} {rec.get('error')}")
    finally:
        dry["stop"]()
        import shutil
        shutil.rmtree(dry["out"], ignore_errors=True)
    print(f"sLSTM phase wall: {time.perf_counter() - t_phase:.1f} s")
    row = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/slstm_scan.cu",
           "replaces": "src/repro/models/xlstm.py:172", "library_ms": None}
    return [
        {"name": "slstm_scan", **row, "launches": 0, "max_abs_err": err_fwd, "ms": fwd_ms,
         "ms_saving": save_ms, "us_a_step": fwd_ms * 1e3 / s, "chain_floor_ms": floor_ms,
         "ms_decode_launch": step_ms,
         "split_ns": splits["forward"]["last"], "plain_ms": plain_fwd_ms,
         "bound_ms": f_ms, "bound_by": f_by},
        {"name": "slstm_scan_backward", **row, "launches": 0, "max_abs_err": err_bwd,
         "ms": bwd_ms, "us_a_step": bwd_ms * 1e3 / s, "chain_floor_ms": floor_ms,
         "split_ns": splits["backward"]["last"], "plain_ms": plain_bwd_ms,
         "bound_ms": b_ms, "bound_by": b_by},
    ]


def spill_deadline(eng, reqs):
    """The routed run's deadline, from the engine's own profile and policy.

    Admission routes a batch before the driver adopts any of it (empty
    queues, the sim clock where it stands), so its decisions follow from
    the profile alone.  Deadlines on a grid of 4,000 steps from 0 to the
    farm's whole predicted queue are replayed, from the top down, through
    an ``AdmissionController`` with the engine's admission config over a
    ``BackendRouter`` with the engine's backends, router config and a copy
    of its profile (fresh ones, so the engine's counters and EWMA stay as
    they were): the deadline is the middle of the highest run of them at
    which some request goes to the pool and none is rejected (the farm's
    queue outgrows it, as it outgrows ``ROUTE_DEADLINE`` under the
    reference profile).  Returns the deadline and the backend each request
    is predicted to take, or ``(None, None)`` when no deadline sends work
    to the pool without a rejection.
    """
    from repro_torch.serving.admission import AdmissionController, EngineOverloadedError
    from repro_torch.serving.calibration import CalibrationProfile
    from repro_torch.serving.router import BackendRouter

    cfg = eng.cfg
    sim_now = eng.backend.sim_now()
    sels = [eng._to_selection(r) for r in reqs]
    lanes = [eng._estimate_job_lanes(len(sel.items), sel.kofn.m) for sel in sels]
    router = BackendRouter(eng.router.backends,
                           CalibrationProfile.from_json(eng.router.profile.to_json()),
                           eng.router.config)

    def plan(deadline):
        admission = AdmissionController(eng.admission.config, router=router)
        out = []
        for sel, ls in zip(sels, lanes):
            try:
                out.append(admission.admit(sel.request_id, ls, cfg.reads, sim_now + deadline,
                                           sim_now, steps=cfg.steps,
                                           iterations=cfg.iterations).backend)
            except EngineOverloadedError:
                out.append(None)
        return out

    farm = router.profile.model("farm")
    top = sum(farm.request_seconds([(n, cfg.reads) for n in ls], cfg.steps) for ls in lanes)
    def spills(j):
        p = plan(top * j / grid)
        return "pool" in p and None not in p

    grid = 4000
    hi = next((j for j in range(grid - 1, 0, -1) if spills(j)), None)
    if hi is None:
        return None, None
    lo = hi
    while lo > 1 and spills(lo - 1):
        lo -= 1
    deadline = sim_now + top * (hi + lo) / 2 / grid
    return deadline, plan(deadline - sim_now)


def calibration_phase(dev, reset_counts, counts, launches, reqs, served,
                      routed_ref) -> None:
    """Phase 4l: the router's calibration on the card (``launch/calibrate.py``).

    (a) The full cobi-pool fit and the full mcmc fit (``--backend mcmc
    --pool-solver tabu``) through ``launch.calibrate.run`` on the card: the
    warm-up's seconds, each size's median seconds an invocation (the fit's
    quadratic passes through the three), the coefficients, each pool's
    predicted seconds an invocation at n 10, 20, 40 and 59 beside the
    checked-in reference profile's and the checked-in card profile's
    (``serving/profiles/``), every model's knots and each profile's
    JSON on one line; the save's round trip and a finite prediction at
    every n in 2-59, or the phase fails.  (b) The tiny mcmc fit on the card
    and on the CPU: the Tabu pool's and the mcmc model's knots equal, and
    the farm's COBI sweep re-run on both, each instance's normalized curve
    within 0.05.  (c) Phase 4f's routed run (``routed_ref``: the
    reference profile at ``ROUTE_DEADLINE``) beside the same 16 requests
    routed with the card's cobi-pool profile under a deadline derived from
    its predictions through the engine's own admission and router
    (``spill_deadline``): for each, ``backend_used``, ``router.stats()`` and
    each backend's ``ewma_latency`` after the batch (realized against
    predicted); the card profile's run takes the predicted backends, spills
    at least once and answers each request as the farm did, bit for bit.
    """
    import tempfile

    import torch

    from repro_torch import prng
    from repro_torch.core import SolveConfig, solve_es
    from repro_torch.core.metrics import normalized_objective, reference_bounds
    from repro_torch.data.synthetic import benchmark_suite
    from repro_torch.launch import calibrate
    from repro_torch.serving import AdmissionConfig, SummarizationEngine
    from repro_torch.serving.calibration import CalibrationProfile

    t_phase = time.perf_counter()
    card = card_line()
    probe = (10, 20, 40, 59)

    def fit(label, tmp, **kw):
        out = str(Path(tmp) / f"{label}.json")
        t0 = time.perf_counter()
        try:
            prof = calibrate.run(out=out, **kw)
        except AssertionError:
            fail(f"calibration {label}: the saved profile does not reproduce its predictions")
        return prof, time.perf_counter() - t0

    # ------------------------------------------------------------ (a)
    profiles = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, ref_file, kw in (
                ("cobi_pool", "CALIBRATION_cobi_pool.json", dict(pool_solver="cobi")),
                ("mcmc", "CALIBRATION_mcmc.json", dict(pool_solver="tabu", backend="mcmc"))):
            reset_counts()
            prof, wall = fit(label, tmp, device=dev, **kw)
            c = counts()
            for name in c:
                launches[name] += c[name]
            profiles[label] = prof
            ref = CalibrationProfile.load(str(ROOT / "benchmarks" / ref_file))
            pool, ref_pool = prof.model("pool"), ref.model("pool")
            reads, steps = pool.reads_ref, pool.steps_ref
            medians = {n: pool.invocation_seconds(n, reads, steps) for n in prof.meta["sizes"]}
            print(f"calibration {label} (full fit on the card, pool {pool.solver}): wall "
                  f"{wall:.3f} s, median s an invocation (the fit through them) "
                  + ", ".join(f"n {n}: {s:.6f}" for n, s in medians.items())
                  + f"; lat_coef {list(pool.lat_coef)}; launches {c} [{card}]")
            print(f"calibration {label} pool s an invocation ({reads} reads, {steps} steps), card "
                  "against the reference profile: "
                  + ", ".join(f"n {n}: {pool.invocation_seconds(n, reads, steps):.6f} / "
                              f"{ref_pool.invocation_seconds(n, ref_pool.reads_ref, ref_pool.steps_ref):.6f}"
                              for n in probe))
            kept = CalibrationProfile.load(
                str(ROOT / "src" / "repro_torch" / "serving" / "profiles"
                    / f"CALIBRATION_{label}_h100.json")).model("pool")
            print(f"calibration {label} pool s an invocation, this fit against the checked-in "
                  f"card profile ({kept.solver}): "
                  + ", ".join(f"n {n}: {pool.invocation_seconds(n, reads, steps):.6f} / "
                              f"{kept.invocation_seconds(n, kept.reads_ref, kept.steps_ref):.6f}"
                              for n in probe))
            print(f"calibration {label} knots: " + "; ".join(
                f"{name} {list(zip(m.quality_n, m.quality_p))}" for name, m in prof.models.items()))
            print(f"calibration {label} profile: {json.dumps(json.loads(prof.to_json()))}")
            c0, c1, c2 = pool.lat_coef
            raw = {n: c0 + c1 * n + c2 * n * n for n in range(2, 60)}
            bad = [n for n, s in raw.items()
                   if not (math.isfinite(s) and math.isfinite(pool.invocation_seconds(n, reads, steps)))]
            if bad:
                fail(f"calibration {label}: the pool's prediction is not finite at n {bad}")
            neg = [n for n, s in raw.items() if s < 0]
            print(f"calibration {label}: the quadratic over n 2-59 runs from "
                  f"{min(raw.values()):.6f} to {max(raw.values()):.6f} s"
                  + (f"; negative at n {neg} (the model clamps it to 0)" if neg else
                     ", no negative prediction"))

        # ------------------------------------------------------------ (b)
        reset_counts()
        tiny = {}
        for where in (dev, torch.device("cpu")):
            tiny[where.type], wall = fit(f"tiny_mcmc_{where.type}", tmp, tiny=True,
                                         pool_solver="tabu", backend="mcmc", device=where)
            print(f"calibration tiny mcmc on {where.type}: wall {wall:.3f} s")
    c = counts()
    for name in c:
        launches[name] += c[name]
    on_card, on_cpu = tiny[dev.type], tiny["cpu"]
    for name in ("pool", "mcmc", "farm"):
        a, b = on_card.model(name), on_cpu.model(name)
        print(f"calibration tiny {name} knots card / CPU: {list(zip(a.quality_n, a.quality_p))} / "
              f"{list(zip(b.quality_n, b.quality_p))}")
        if name != "farm" and (a.quality_n, a.quality_p) != (b.quality_n, b.quality_p):
            fail(f"calibration tiny: the {name} model's knots differ between the card and the CPU")
    # The farm's knots come from a COBI sweep, whose phases go through sin/cos:
    # its curves are held to the full-anneal bar, instance by instance.
    worst = 0.0
    kw = calibrate.TINY
    cfg = SolveConfig(solver="cobi", formulation="improved", iterations=kw["iterations"],
                      reads=8, steps=kw["steps"], int_range=14, rounding="stochastic")
    for n in kw["sizes"]:
        curves = {}
        for where in (dev, torch.device("cpu")):
            suite = benchmark_suite(kw["n_benchmarks"], n, max(2, min(6, n // 3)), lam=0.5,
                                    device=where)
            curves[where.type] = [
                normalized_objective(solve_es(p, prng.key(6000 + i), cfg, device=where).curve,
                                     reference_bounds(p))
                for i, p in enumerate(suite)]
        for i, (a, b) in enumerate(zip(curves[dev.type], curves["cpu"])):
            d = float(np.max(np.abs(a - b)))
            worst = max(worst, d)
            if d > 0.05:
                fail(f"calibration tiny farm: instance {i} at n {n}: the card's normalized "
                     f"curve {a.tolist()} is {d:.4f} from the CPU's {b.tolist()} (bar 0.05)")
    print(f"calibration tiny farm (COBI sweep re-run): every instance's normalized curve card "
          f"against CPU within {worst:.6f} (bar 0.05)")

    # ------------------------------------------------------------ (c)
    print(f"serve routed, reference cobi_pool profile (4f's run, deadline {ROUTE_DEADLINE} s): "
          f"backend_used {routed_ref['used']}, router {routed_ref['stats']}, ewma_latency "
          f"{routed_ref['ewma']}")
    cfg = SolveConfig(iterations=FARM_ITERATIONS)
    farm_reqs, farm_served = reqs[:-1], served[:-1]
    profile = CalibrationProfile.from_json(profiles["cobi_pool"].to_json())  # the engine folds into it
    reset_counts()
    t0 = time.perf_counter()
    with SummarizationEngine(cfg, n_chips=4, seed=0, routing=True, profile=profile,
                             admission=AdmissionConfig(max_queue_depth=len(FARM_SIZES)),
                             device=dev) as eng:
        deadline, plan = spill_deadline(eng, farm_reqs)
        if deadline is None:
            fail("the card's profile predicts no deadline at which the farm mix spills "
                 "onto the pool without a rejection")
        print(f"serve routed with the card's profile: deadline {deadline} s (sim), "
              f"derived from its predictions; predicted backends {plan}")
        routed = eng.run_batch([dataclasses.replace(r, deadline=deadline)
                                for r in farm_reqs], seed=0)
        stats = eng.router.stats()
    wall = time.perf_counter() - t0
    c = counts()
    for name in c:
        launches[name] += c[name]
    used: dict = {}
    for r in routed:
        used[r.backend_used] = used.get(r.backend_used, 0) + 1
    ewma = {name: m.ewma_latency for name, m in profile.models.items()}
    print(f"serve routed, card cobi_pool profile (16 requests, deadline {deadline:.6f} s): "
          f"backend_used {used}, router {stats}, ewma_latency {ewma}, "
          f"wall {wall:.4f} s, launches {c}")
    if [r.backend_used for r in routed] != plan:
        fail(f"routed with the card's profile: backends {[r.backend_used for r in routed]} "
             f"!= the predicted {plan}")
    if not used.get("pool"):
        fail("the routed run with the card's profile spilled nothing onto the pool")
    for r, s in zip(routed, farm_served):
        if not (np.array_equal(r.selection, s.selection) and r.objective == s.objective):
            fail(f"routed request {r.request_id} (card's profile, via {r.backend_used}) "
                 f"!= its farm solve")
    print(f"serve routed, card cobi_pool profile: all 16 responses ({used['pool']} spilled) == "
          f"the farm's bitwise")
    print(f"calibration phase wall: {time.perf_counter() - t_phase:.1f} s [{card}]")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save-embeddings", metavar="PATH",
                    help="write the card's flash-path embeddings of the direct document and "
                         "farm1 (float32) to this .npz")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch is not beside chip_smoke.py: run it from the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's smoke run needs a GPU")
    from repro_torch import prng
    from repro_torch.core import SolveConfig, improved_ising, solve_es
    from repro_torch.core import metrics, pipeline
    from repro_torch.core.formulation import IsingProblem
    from repro_torch.core.rounding import quantize_ising, quantize_ising_many
    from repro_torch.data.synthetic import synthetic_document
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.embeddings import BackboneEncoder, EncoderStage, problem_from_sentences
    from repro_torch.embeddings import serving as enc_serving
    from repro_torch.models import init_params
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cobi_dynamics as cd
    from repro_torch.kernels import ising_energy as ie
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mcmc_dynamics as md
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import slstm_scan as ks
    from repro_torch.farm import CobiFarm, McmcPoolBackend
    from repro_torch.obs import Observability
    from repro_torch.solvers import cobi as cobi_solver
    from repro_torch.solvers import ising_solver

    # ------------------------------------------------------------ 1. the card
    card = card_line()
    print(f"card: {card}")
    # Full float32 products, and bf16 products summed in float32 (no
    # reduced-precision split-K reductions) in cuBLAS.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} bf16 reduced-precision reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    dev = torch.device("cuda")

    # ------------------------------------------------------------ 2. build
    # Phase 4k's dry-run cells start now, on the host's cores, while the
    # card works through phases 3-4j.
    slstm_dry = start_slstm_dry_runs()
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(libs)}")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "error" in line.lower():
                    print(f"  {name}: {line.strip()}")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(libs["flash_attention"])],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        hgmma = sum("HGMMA" in line for line in sass.splitlines())
        hmma_tf32 = sum("HMMA" in line and "TF32" in line for line in sass.splitlines())
        print(f"flash_attention SASS: {hgmma} HGMMA instructions, {hmma_tf32} HMMA instructions "
              f"on TF32 operands (cuobjdump --dump-sass)")
        if hgmma == 0:
            fail("the flash library has no HGMMA instruction: the wgmma kernel did not compile to it")
        if hmma_tf32 == 0:
            fail("the flash library has no HMMA instruction on TF32 operands: the split-TF32 "
                 "kernel's products did not compile to the tensor cores")
    else:
        print(f"flash_attention SASS: not measured ({cuobjdump} not found)")

    counted = {
        "cobi_trajectory": cd.cobi_trajectory_cuda,
        "ising_energy": ie.ising_energy_cuda,
        "cobi_fused_best": cd.cobi_fused_best_cuda,
        "cobi_readout": cd.cobi_readout_cuda,
        "cobi_trajectory_batched": cd.cobi_trajectory_batched_cuda,
        "cobi_fused_best_batched": cd.cobi_fused_best_batched_cuda,
        "ising_energy_batched": ie.ising_energy_batched_cuda,
        "mcmc_sweep_batched": md.mcmc_sweep_batched,
        "mcmc_fused_best_batched": md.mcmc_fused_best_batched,
        "flash_attention": fa.flash_attention_cuda,
        "slstm_scan": ks.slstm_scan_cuda,
        "slstm_scan_backward": ks.slstm_scan_backward_cuda,
    }

    def reset_counts() -> None:
        for w in counted.values():
            w.launches = 0
        for route in fa.flash_attention_cuda.route_launches:
            fa.flash_attention_cuda.route_launches[route] = 0

    def counts() -> dict:
        return {name: w.launches for name, w in counted.items()}

    def expect(**launched) -> dict:
        return {name: launched.get(name, 0) for name in counted}

    # The direct document's problem and its first rounded instance: the
    # shapes and values the main path hands the kernels.
    sents = synthetic_document(7, 20)
    problem = problem_from_sentences(sents, m=6, lam=0.5, device=dev)
    key = prng.key(0)
    (k_quant, k_solve), = pipeline._iteration_keys(key, 1)
    inst = quantize_ising(improved_ising(problem), key=k_quant).ising

    # ------------------------------------------------------------ 3. kernels vs plain
    errs = {}

    def operands(reads: int, k, h=inst.h, j=inst.j):
        op = ops.anneal_operands(h, j, k, replicas=reads)
        mask, rd = ops.solo_slot(op.n_pad, reads, dev)
        return op, mask, rd

    # A 200-spin integer instance: 256 lanes, where J no longer fits shared
    # memory and the anneal reads it from global memory.
    rng = np.random.default_rng(0)
    wide_j = np.triu(rng.integers(-14, 15, (200, 200)), 1).astype(np.float32)
    wide_h = torch.tensor(rng.integers(-14, 15, 200).astype(np.float32), device=dev)
    wide_j = torch.tensor(wide_j + wide_j.T, device=dev)

    for reads, h, j in ((READS, inst.h, inst.j), (1024, inst.h, inst.j), (16, wide_h, wide_j)):
        op, mask, rd = operands(reads, k_solve, h, j)
        traj_args = (op.j_scaled, op.h_scaled, op.phi0)
        read_args = (op.j_scaled, op.h_scaled, op.j_orig, op.h_orig, op.phi0)
        fused_args = (op.j_scaled, op.h_scaled, op.j_orig, op.h_orig, mask, rd, op.phi0)
        short = dict(steps=50, dt=0.35, ks_max=1.2)
        full = dict(steps=STEPS, dt=0.35, ks_max=1.2)

        # Trajectory: phases within the reference's 50-step bound.
        got = cd.cobi_trajectory_cuda(*traj_args, **short)
        want = cd.cobi_trajectory_plain(*traj_args, **short)
        err = (got - want).abs()
        if not bool((err <= TRAJ_TOL + TRAJ_TOL * want.abs()).all()):
            fail(f"cobi_trajectory vs plain at reads={reads} lanes={op.n_pad}: "
                 f"max err {float(err.max())}")
        errs["cobi_trajectory"] = max(errs.get("cobi_trajectory", 0.0), float(err.max()))

        # Readout and fused best at 50 steps against their plain versions:
        # same spins, same energies, exactly.  At 1024 reads some phase sits
        # within the phase tolerance of a readout boundary, so only the
        # main path's 8 reads are compared spin for spin.
        if reads == READS and op.n_pad == 128:
            s_k, e_k = cd.cobi_readout_cuda(*read_args, **short)
            s_p, e_p = cd.cobi_readout_plain(*read_args, **short)
            if not torch.equal(s_k, s_p) or not torch.equal(e_k, e_p):
                fail(f"cobi_readout vs plain: spins equal {torch.equal(s_k, s_p)}, "
                     f"max energy err {float((e_k - e_p).abs().max())}")
            errs["cobi_readout"] = float((e_k - e_p).abs().max())
            be_k, bs_k = cd.cobi_fused_best_cuda(*fused_args, **short)
            be_p, bs_p = cd.cobi_fused_best_plain(*fused_args, **short)
            if not (torch.equal(be_k[:1], be_p[:1]) and torch.equal(bs_k[:1], bs_p[:1])):
                fail(f"cobi_fused_best vs plain: {be_k[:1].tolist()} vs {be_p[:1].tolist()}")
            errs["cobi_fused_best"] = float((be_k[:1] - be_p[:1]).abs().max())

        # Full anneals, kernel side: the three anneal kernels share one Euler
        # loop, so readout spins == sign(cos(trajectory phases)) and fused
        # best == readout + first argmin, bitwise; energies are exact.
        phi = cd.cobi_trajectory_cuda(*traj_args, **full)
        s_k, e_k = cd.cobi_readout_cuda(*read_args, **full)
        if not torch.equal(s_k, kref.sign_spins(phi)):
            fail(f"readout spins != sign(cos(trajectory phases)) at reads={reads}")
        e_plain = kref.ref_ising_energy(s_k, op.h_orig[0], op.j_orig)
        e_kern = ie.ising_energy_cuda(s_k, op.h_orig, op.j_orig)
        if not (torch.equal(e_k, e_plain) and torch.equal(e_kern, e_plain)):
            fail(f"energies not exact at reads={reads}: readout "
                 f"{float((e_k - e_plain).abs().max())}, ising_energy "
                 f"{float((e_kern - e_plain).abs().max())}")
        errs["ising_energy"] = max(errs.get("ising_energy", 0.0),
                                   float((e_kern - e_plain).abs().max()))
        be_k, bs_k = cd.cobi_fused_best_cuda(*fused_args, **full)
        i = int(torch.argmin(e_k[:reads]))  # first minimum
        if not (float(be_k[0]) == float(e_k[i]) and torch.equal(bs_k[0], s_k[i])):
            fail(f"fused best != readout + first argmin at reads={reads}: "
                 f"{float(be_k[0])} vs {float(e_k[i])} (row {i})")
        if not bool(torch.isinf(be_k[1:]).all()):
            fail("padding slots of the fused best are not +inf")
        print(f"kernels vs plain at reads={reads} lanes={op.n_pad}: ok (best read {i}, E={float(e_k[i])}, "
              f"{int((e_k[:reads] == e_k[i]).sum())} reads tie at the minimum)")
    torch.cuda.synchronize()

    # The anneal loop's cases: live extents 4 to 128 on 128 lanes, an
    # all-zero row and column inside n, a non-symmetric J, 64 and 1024 reads,
    # and the global-J path at N = 256 and 1024.  Each against its plain
    # version at 50 steps within TRAJ_TOL; then, on the card, readout spins ==
    # sign(cos(trajectory phases)), exact energies and fused == readout + first
    # argmin, bit for bit, at 400 steps (100 at N = 1024).
    def int_instance(seed: int, n: int, symmetric: bool = True, zero=None) -> IsingProblem:
        """Chip-range integer instance whose live extent is exactly n."""
        g = np.random.default_rng(seed)
        j = g.integers(-14, 15, (n, n)).astype(np.float32)
        if symmetric:
            j = np.triu(j, 1)
            j = j + j.T
        j[0, n - 1] = j[n - 1, 0] = 5.0
        hv = g.integers(-14, 15, n).astype(np.float32)
        if zero is not None:
            j[zero, :] = j[:, zero] = 0.0
        return IsingProblem(h=torch.tensor(hv, device=dev), j=torch.tensor(j, device=dev))

    loop_cases = [(f"extent {e}", int_instance(e, e), READS) for e in (4, 20, 33, 100, 127, 128)]
    loop_cases += [("zero row and column 17 of 40", int_instance(40, 40, zero=17), READS),
                   ("non-symmetric J, 60 spins", int_instance(60, 60, symmetric=False), READS),
                   ("extent 20, R 64", int_instance(20, 20), 64),
                   ("extent 20, R 1024", int_instance(20, 20), 1024),
                   ("N 256 (global J)", int_instance(256, 256), READS),
                   ("N 1024 (global J)", int_instance(1024, 1024), READS)]
    for label, q, reads in loop_cases:
        op, mask, rd = operands(reads, k_solve, q.h, q.j)
        traj_args = (op.j_scaled, op.h_scaled, op.phi0)
        read_args = (op.j_scaled, op.h_scaled, op.j_orig, op.h_orig, op.phi0)
        short = dict(steps=50, dt=0.35, ks_max=1.2)
        full = dict(steps=100 if op.n_pad == 1024 else STEPS, dt=0.35, ks_max=1.2)
        got = cd.cobi_trajectory_cuda(*traj_args, **short)
        want = cd.cobi_trajectory_plain(*traj_args, **short)
        err = (got - want).abs()
        if not bool((err <= TRAJ_TOL + TRAJ_TOL * want.abs()).all()):
            fail(f"cobi_trajectory vs plain ({label}, R={reads}, {op.n_pad} lanes): "
                 f"max err {float(err.max())}")
        errs["cobi_trajectory"] = max(errs["cobi_trajectory"], float(err.max()))
        phi = cd.cobi_trajectory_cuda(*traj_args, **full)
        s_k, e_k = cd.cobi_readout_cuda(*read_args, **full)
        be_k, bs_k = cd.cobi_fused_best_cuda(*read_args[:4], mask, rd, op.phi0, **full)
        i = int(torch.argmin(e_k[:reads]))
        if not (torch.equal(s_k, kref.sign_spins(phi))
                and torch.equal(e_k, kref.ref_ising_energy(s_k, op.h_orig[0], op.j_orig))
                and float(be_k[0]) == float(e_k[i]) and torch.equal(bs_k[0], s_k[i])
                and bool(torch.isinf(be_k[1:]).all())):
            fail(f"anneal case {label}: readout != sign(cos(trajectory)), inexact energies, or "
                 f"fused != readout + first argmin")
        print(f"anneal case {label}: R={reads} lanes={op.n_pad} max err vs plain "
              f"{float(err.max()):.3e}; readout, energies, fused best bitwise ok ({full['steps']} steps)")

    # A packed bin with jobs at lane offsets 3, 21 and 77: each job's packed
    # anneal equals its solo anneal, phases and fused winner bit for bit.
    jobs = {3: int_instance(303, 15), 21: int_instance(321, 40), 77: int_instance(377, 30)}
    z = lambda *shape: torch.zeros(shape, device=dev)
    pk = {"j": z(1, 128, 128), "h": z(1, 1, 128), "ju": z(1, 128, 128), "hu": z(1, 1, 128),
          "mask": z(1, 128, ops.SLOT_PAD), "reads": z(1, 1, ops.SLOT_PAD), "phi0": z(1, READS, 128)}
    solo_ops = {}
    for si, (off, q) in enumerate(jobs.items()):
        op, mask, rd = operands(READS, prng.split(prng.key(off))[0], q.h, q.j)
        lanes, nj = slice(off, off + q.n), q.n
        pk["j"][0, lanes, lanes], pk["ju"][0, lanes, lanes] = op.j_scaled[:nj, :nj], op.j_orig[:nj, :nj]
        pk["h"][0, 0, lanes], pk["hu"][0, 0, lanes] = op.h_scaled[0, :nj], op.h_orig[0, :nj]
        pk["phi0"][0, :, lanes] = op.phi0[:, :nj]
        pk["mask"][0, lanes, si], pk["reads"][0, 0, si] = 1.0, float(READS)
        solo_ops[off] = (si, op, mask, rd)
    full = dict(steps=STEPS, dt=0.35, ks_max=1.2)
    pk_phi = cd.cobi_trajectory_batched_cuda(pk["j"], pk["h"], pk["phi0"], **full)
    pk_e, pk_s = cd.cobi_fused_best_batched_cuda(
        *(pk[k] for k in ("j", "h", "ju", "hu", "mask", "reads", "phi0")), **full)
    for off, (si, op, mask, rd) in solo_ops.items():
        nj, lanes = jobs[off].n, slice(off, off + jobs[off].n)
        phi = cd.cobi_trajectory_cuda(op.j_scaled, op.h_scaled, op.phi0, **full)
        se, ss = cd.cobi_fused_best_cuda(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig, mask, rd,
                                         op.phi0, **full)
        if not (torch.equal(phi[:, :nj], pk_phi[0, :, lanes]) and float(se[0]) == float(pk_e[0, si])
                and torch.equal(ss[0, :nj], pk_s[0, si, lanes])):
            fail(f"packed job at lane offset {off} ({nj} spins) != its solo anneal")
    print(f"packed bin (jobs at lane offsets {sorted(jobs)}): phases and fused winners == solo, "
          f"bitwise ({STEPS} steps)")
    torch.cuda.synchronize()

    # ------------------------------------------------------------ 3b. batched kernels
    # The farm benchmark's 16 documents and the 96 rounded instances and
    # solve keys their iterations submit (as pipeline._submit_iterations
    # makes them).
    farm_docs = [problem_from_sentences(synthetic_document(100 + i, n), m=5, lam=0.5,
                                        device=dev) for i, n in enumerate(FARM_SIZES)]
    farm_keys = list(prng.split(prng.key(0), len(farm_docs)))
    farm_cfg = SolveConfig(solver="cobi", iterations=FARM_ITERATIONS, reads=READS,
                           steps=STEPS, int_range=14)
    farm_jobs = []
    for doc, k in zip(farm_docs, farm_keys):
        ising_fp = improved_ising(doc)
        for kq, ks in pipeline._iteration_keys(k, FARM_ITERATIONS):
            farm_jobs.append((quantize_ising(ising_fp, key=kq).ising, ks))
    insts = [q for q, _ in farm_jobs]
    opd, slots = packed_operands(insts, [k for _, k in farm_jobs], READS, dev)
    b_bins, s_pad = opd["j"].shape[0], opd["mask"].shape[-1]
    short = dict(steps=50, dt=0.35, ks_max=1.2)
    full = dict(steps=STEPS, dt=0.35, ks_max=1.2)
    four = {k: v[:4] for k, v in opd.items()}
    fused_keys = ("j", "h", "ju", "hu", "mask", "reads", "phi0")

    got = cd.cobi_trajectory_batched_cuda(four["j"], four["h"], four["phi0"], **short)
    want = cd.cobi_trajectory_batched_plain(four["j"], four["h"], four["phi0"], **short)
    err = (got - want).abs()
    if not bool((err <= TRAJ_TOL + TRAJ_TOL * want.abs()).all()):
        fail(f"cobi_trajectory_batched vs plain on 4 bins: max err {float(err.max())}")
    errs["cobi_trajectory_batched"] = float(err.max())
    be_k, bs_k = cd.cobi_fused_best_batched_cuda(*(four[k] for k in fused_keys), **short)
    be_p, bs_p = cd.cobi_fused_best_batched_plain(*(four[k] for k in fused_keys), **short)
    real = four["reads"][:, 0] > 0
    if not (torch.equal(be_k[real], be_p[real]) and torch.equal(bs_k[real], bs_p[real])):
        fail("cobi_fused_best_batched vs plain on 4 bins at 50 steps: winners differ")
    errs["cobi_fused_best_batched"] = float((be_k[real] - be_p[real]).abs().max())

    # 400 steps on every bin of the drain: the fused launch against the
    # two-launch drain (batched trajectory, sign, each job's spins scored at
    # lane offset 0 against its own instance, first argmin), against exact
    # plain re-scoring, and against each job's solo fused best.
    phi = cd.cobi_trajectory_batched_cuda(opd["j"], opd["h"], opd["phi0"], **full)
    spins = kref.sign_spins(phi)
    n_jobs = len(slots)
    s_stack = torch.zeros((n_jobs, READS, 128), device=dev)
    h_stack = torch.zeros((n_jobs, 1, 128), device=dev)
    j_stack = torch.zeros((n_jobs, 128, 128), device=dev)
    for k, (b, _, slot) in enumerate(slots):
        n, lanes = slot.n, slice(slot.offset, slot.offset + slot.n)
        s_stack[k, :, :n] = spins[b, :, lanes]
        h_stack[k, 0, :n] = insts[slot.job_id].h
        j_stack[k, :n, :n] = insts[slot.job_id].j
    e_two = ie.ising_energy_batched_cuda(s_stack, h_stack, j_stack)
    e_plain = ie.ising_energy_batched_plain(s_stack, h_stack, j_stack)
    if not torch.equal(e_two, e_plain):
        fail(f"ising_energy_batched vs plain: max err {float((e_two - e_plain).abs().max())}")
    errs["ising_energy_batched"] = float((e_two - e_plain).abs().max())
    be, bs = cd.cobi_fused_best_batched_cuda(*(opd[k] for k in fused_keys), **full)
    winners = {}
    for k, (b, si, slot) in enumerate(slots):
        n, lanes = slot.n, slice(slot.offset, slot.offset + slot.n)
        i = int(torch.argmin(e_two[k]))  # first minimum
        q = insts[slot.job_id]
        if not (float(be[b, si]) == float(e_two[k, i]) and torch.equal(bs[b, si, lanes], s_stack[k, i, :n])):
            fail(f"fused batched != two-launch drain + first argmin for job {slot.job_id}")
        if float(kref.ref_ising_energy(bs[b, si, lanes][None], q.h, q.j)[0]) != float(be[b, si]):
            fail(f"fused batched energy of job {slot.job_id} is not exact on re-scoring")
        solo = {}
        for name in ("j", "ju"):
            solo[name] = torch.zeros((128, 128), device=dev)
            solo[name][:n, :n] = opd[name][b, lanes, lanes]
        for name in ("h", "hu"):
            solo[name] = torch.zeros((1, 128), device=dev)
            solo[name][0, :n] = opd[name][b, 0, lanes]
        solo["phi0"] = torch.zeros((READS, 128), device=dev)
        solo["phi0"][:, :n] = opd["phi0"][b, :, lanes]
        solo["mask"], solo["reads"] = ops.solo_slot(128, READS, dev)
        se, ss = cd.cobi_fused_best_cuda(*(solo[k] for k in fused_keys), **full)
        if not (float(se[0]) == float(be[b, si]) and torch.equal(ss[0, :n], bs[b, si, lanes])):
            fail(f"packed winner of job {slot.job_id} != its solo fused best")
        winners[slot.job_id] = (float(be[b, si]), bs[b, si, lanes].to(torch.int8).cpu())
    print(f"batched kernels vs plain: ok ({n_jobs} jobs in {b_bins} padded bins, "
          f"S={s_pad}; packed == solo and fused == two-launch for every job)")

    # Fault 1 of the first slice: one bin of 100 one-spin jobs (S = 100,
    # padded to 104 slots) launches and agrees with its plain version.
    rng1 = np.random.default_rng(1)
    ones = [IsingProblem(h=torch.tensor([float(v)]), j=torch.zeros((1, 1)))
            for v in rng1.choice([-3, -2, -1, 1, 2, 3], 100)]
    op1, slots1 = packed_operands(ones, list(prng.split(prng.key(5), 100)), READS, dev)
    be_k, bs_k = cd.cobi_fused_best_batched_cuda(*(op1[k] for k in fused_keys), **full)
    be_p, bs_p = cd.cobi_fused_best_batched_plain(*(op1[k] for k in fused_keys), **full)
    s1 = [si for _, si, _ in slots1]
    if op1["mask"].shape[-1] != 104 or len(s1) != 100:
        fail(f"the one-spin bin has {len(s1)} slots padded to {op1['mask'].shape[-1]}")
    if not (torch.equal(be_k[0, s1], be_p[0, s1]) and torch.equal(bs_k[0, s1], bs_p[0, s1])):
        fail("100-slot bin: fused batched kernel != plain")
    exact = torch.stack([ones[sl.job_id].h[0].to(dev) * bs_k[0, si, sl.offset] for _, si, sl in slots1])
    if not torch.equal(exact, be_k[0, s1]) or not bool(torch.isinf(be_k[0, 100:]).all()):
        fail("100-slot bin: energies not exact or padding slots not +inf")
    print("100-slot bin (S=100 padded to 104): ok")
    torch.cuda.synchronize()

    # ------------------------------------------------------------ 3e. the energy kernel
    # The energy kernel reads the live extent in place.  Against its plain
    # version, bit for bit, on chip-range integer instances: n 1 to 1024
    # lanes x R 1 to 1024, B 3 and 1, int8 and float32 spins, and the live
    # corner of zero-padded operands read at its row strides.  On
    # non-integer instances against the COBI readout epilogue's energies
    # (the same fmaf chain, density and row sum, there over 128 lanes), and
    # the tile-aligned twin against the unpadded call.  One ops.ising_energy
    # call at the main path's shape is one device launch under
    # torch.profiler: no padding copy, no cast.
    def int_stack(seed: int, b: int, n: int):
        g = np.random.default_rng(seed)
        j = np.triu(g.integers(-14, 15, (b, n, n)), 1).astype(np.float32)
        return (torch.tensor(g.integers(-14, 15, (b, n)).astype(np.float32), device=dev),
                torch.tensor(j + j.transpose(0, 2, 1), device=dev))

    def spin_rows(seed: int, *shape):
        g = np.random.default_rng(seed)
        return torch.tensor(np.where(g.random(shape) < 0.5, 1, -1).astype(np.int8), device=dev)

    energy_lanes, energy_rows = (1, 7, 20, 59, 128, 129, 200, 1024), (1, 8, 17, 256, 1024)
    for n in energy_lanes:
        for r in energy_rows:
            h3, j3 = int_stack(1031 * n + r, 3, n)
            s3 = spin_rows(n + r, 3, r, n)
            want = ie.ising_energy_batched_plain(s3, h3[:, None], j3)
            for s in (s3, s3.float()):
                got = ie.ising_energy_batched_cuda(s, h3[:, None], j3)
                one = ie.ising_energy_cuda(s[1], h3[1:2], j3[1])
                if not (torch.equal(got, want) and torch.equal(one, want[1])):
                    fail(f"ising_energy vs plain at n={n} R={r} {s.dtype}: max err "
                         f"{float((got - want).abs().max())} (B 3), "
                         f"{float((one - want[1]).abs().max())} (B 1)")
            sp = torch.zeros((r, n + 5), dtype=torch.int8, device=dev)
            jp = torch.zeros((n + 5, n + 5), device=dev)
            sp[:, :n], jp[:n, :n] = s3[0], j3[0]
            if not torch.equal(ops.ising_energy(sp[:, :n], h3[0], jp[:n, :n]), want[0]):
                fail(f"ising_energy on strided operands at n={n} R={r} != plain")
    for n, reads in ((20, 8), (100, 64), (128, 8)):
        g = np.random.default_rng(n)
        hf = torch.tensor(g.normal(size=n).astype(np.float32), device=dev)
        jf = g.normal(size=(n, n)).astype(np.float32)
        jf = torch.tensor((jf + jf.T) / np.float32(2), device=dev)
        op = ops.anneal_operands(hf, jf, prng.key(n), replicas=reads)
        s_k, e_k = cd.cobi_readout_cuda(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig, op.phi0,
                                        steps=100, dt=0.35, ks_max=1.2)
        live, want = s_k[:reads, :n], e_k[:reads]
        got = [ops.ising_energy(s, hf, jf) for s in (live, live.contiguous(), live.to(torch.int8))]
        got.append(ie.ising_energy_cuda(live, op.h_orig[:, :n], op.j_orig[:n, :n]))
        if torch.equal(want, want.round()) or not all(torch.equal(e, want) for e in got):
            fail(f"ising_energy != the readout epilogue's energies on a non-integer instance "
                 f"(n={n}, R={reads})")
        sp = torch.zeros((8, 128), device=dev)
        sp[:, :n] = live[:8]
        if not torch.equal(ie.ising_energy_cuda(sp, op.h_orig, op.j_orig), want[:8]):
            fail(f"the tile-aligned ising_energy_cuda != the unpadded call (n={n})")
    s_main = spin_rows(20, READS, inst.n)
    ops.ising_energy(s_main, inst.h, inst.j)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ops.ising_energy(s_main, inst.h, inst.j)
        torch.cuda.synchronize()
    energy_launches = [ev.name for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA]
    print(f"ising_energy vs plain: bitwise at n {list(energy_lanes)} x R {list(energy_rows)}, "
          f"B 3 and 1, int8 and float32 spins, strided corners; == the readout epilogue on "
          f"non-integer instances (n 20, 100, 128) and the tile-aligned twin == unpadded; one "
          f"ops.ising_energy call (R={READS}, n={inst.n}, int8): {len(energy_launches)} device "
          f"launch(es) under torch.profiler {energy_launches}")
    if len(energy_launches) != 1:
        fail(f"ops.ising_energy took {len(energy_launches)} device launches, not 1")

    # ------------------------------------------------------------ 3c. MCMC kernels
    def mcmc_operands(instances, keys, replicas, reads):
        """Stacked operands as ops.mcmc_anneal builds them for one instance:
        J (B, L, L), h (B, 1, L), s0 (B, R, L), seeds (B, 4), params (B, 4)."""
        lanes = -(-max(q.n for q in instances) // 128) * 128
        b = len(instances)
        jp = torch.zeros((b, lanes, lanes), device=dev)
        hp = torch.zeros((b, 1, lanes), device=dev)
        s0, seeds, params = [], [], []
        for i, (q, k) in enumerate(zip(instances, keys)):
            jp[i, :q.n, :q.n], hp[i, 0, :q.n] = q.j, q.h
            sd = kref.mcmc_seeds(k)
            seeds.append(sd)
            s0.append(kref.mcmc_init_spins(sd[0], replicas, lanes, device=dev))
            params.append([float(kref.mcmc_t_hi(q.j)), 0.05, float(q.n), float(reads)])
        return (jp, hp, torch.stack(s0), torch.stack(seeds),
                torch.tensor(params, dtype=torch.float32))

    def normal_instance(seed: int, n: int) -> IsingProblem:
        g = np.random.default_rng(seed)
        j = g.standard_normal((n, n)).astype(np.float32)
        j = np.triu(j + j.T, 1) / np.float32(2)
        return IsingProblem(h=torch.tensor(g.standard_normal(n).astype(np.float32), device=dev),
                            j=torch.tensor(j + j.T, device=dev))

    def hold_mcmc(label, mop, reads, **kw) -> None:
        """Both MCMC kernels against their plain versions, bitwise, and the
        fused best against the sweep kernel + first argmin over ``reads``."""
        e_k, s_k = md.mcmc_sweep_batched(*mop, **kw)
        e_p, s_p = md.mcmc_sweep_batched_plain(*mop, **kw)
        be_k, bs_k = md.mcmc_fused_best_batched(*mop, **kw)
        be_p, bs_p = md.mcmc_fused_best_batched_plain(*mop, **kw)
        if not (torch.equal(e_k, e_p) and torch.equal(s_k, s_p)):
            fail(f"mcmc_sweep_batched vs plain ({label}): spins equal {torch.equal(s_k, s_p)}, "
                 f"max energy err {float((e_k - e_p).abs().max())}")
        if not (torch.equal(be_k, be_p) and torch.equal(bs_k, bs_p)):
            fail(f"mcmc_fused_best_batched vs plain ({label}): {be_k.tolist()} vs {be_p.tolist()}")
        rows_b = torch.arange(e_k.shape[0], device=dev)
        first = torch.argmin(e_k[:, :reads], dim=1)
        if not (torch.equal(be_k, e_k[rows_b, first]) and torch.equal(bs_k, s_k[rows_b, first])):
            fail(f"mcmc fused best != sweep kernel + first argmin over {reads} reads ({label})")
        for name, got_e, want_e in (("mcmc_sweep_batched", e_k, e_p),
                                    ("mcmc_fused_best_batched", be_k, be_p)):
            errs[name] = max(errs.get(name, 0.0), float((got_e - want_e).abs().max()))

    mcmc_keys = list(prng.split(prng.key(3), 3))
    integer = [quantize_ising(improved_ising(problem), key=kq).ising
               for kq, _ in pipeline._iteration_keys(key, 3)]
    kinds = {"float-normal": [normal_instance(40 + i, 20) for i in range(3)],
             "chip-integer": integer}
    cases = [(kind, mode, chunk, rb) for kind in kinds for mode in ("sweep", "random")
             for chunk, rb in ((32, 8), (64, 16), (128, 8))]
    cases.append(("wide", "sweep", 128, 8))
    kinds["wide"] = [normal_instance(7, 200)]
    mcmc_reads = 3
    for kind, mode, chunk, rb in cases:
        insts_k = kinds[kind]
        replicas = 8 if kind == "wide" else 16
        mop = mcmc_operands(insts_k, mcmc_keys, replicas, mcmc_reads)
        kw = dict(sweeps=3 if kind == "wide" else 10, chunk=chunk, mode=mode, replica_block=rb)
        hold_mcmc(f"{kind} mode={mode} chunk={chunk} replica_block={rb} B={len(insts_k)} "
                  f"R={replicas}", mop, mcmc_reads, **kw)
    print(f"mcmc kernels vs plain: ok, bitwise in {len(cases)} cases "
          f"(float-normal and chip-integer x sweep/random x chunk/replica_block "
          f"(32, 8) (64, 16) (128, 8), B=3 R=16 reads={mcmc_reads}; 200 spins on 256 lanes)")
    # The redesigned kernel's own cases: live extents around its 32-lane
    # words (1 to 4 words a lane), a batch whose instances differ in extent,
    # a zero row and column, N 1024 with J read from global memory, R 8 (one
    # cluster of 2 blocks), 64 (two passes) and 1024, and chunks 32/64/128.
    extent_cases = []
    for n_live in (1, 31, 32, 33, 64, 65, 128):
        for mode in ("sweep", "random"):
            extent_cases.append((f"extent {n_live} {mode}", [normal_instance(60 + n_live, n_live)],
                                 8, 5, dict(sweeps=5, mode=mode, chunk=128, replica_block=8)))
    zero = normal_instance(9, 40)
    zero.j[17, :] = 0.0
    zero.j[:, 17] = 0.0
    for mode in ("sweep", "random"):
        extent_cases.append((f"mixed extents 7/45/100 {mode}",
                             [normal_instance(81, 7), normal_instance(82, 45),
                              normal_instance(83, 100)],
                             16, 11, dict(sweeps=5, mode=mode, chunk=64, replica_block=16)))
    extent_cases += [
        ("zero row and column 17 of 40", [zero], 8, 8, dict(sweeps=5, chunk=32, replica_block=8)),
        ("N 1024, 1000 spins, J global", [normal_instance(84, 1000)], 8, 8,
         dict(sweeps=2, chunk=32, replica_block=8)),
        ("R 64 replica_block 32", [normal_instance(85, 20)], 64, 50,
         dict(sweeps=5, chunk=64, replica_block=32)),
        ("R 1024 replica_block 256", [normal_instance(86, 20)], 1024, 1000,
         dict(sweeps=3, chunk=128, replica_block=256)),
    ]
    for label, insts_k, replicas, reads, kw in extent_cases:
        keys_k = list(prng.split(prng.key(5), len(insts_k)))
        hold_mcmc(label, mcmc_operands(insts_k, keys_k, replicas, reads), reads, **kw)
    torch.cuda.synchronize()
    print(f"mcmc kernels vs plain: ok, bitwise in {len(extent_cases)} more cases: "
          + "; ".join(label for label, *_ in extent_cases))
    # One fused call at R 8 is one device launch (its two blocks one cluster).
    mop8 = mcmc_operands([normal_instance(87, 20)], mcmc_keys[:1], 8, 8)
    md.mcmc_fused_best_batched(*mop8, sweeps=5, replica_block=8)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        md.mcmc_fused_best_batched(*mop8, sweeps=5, replica_block=8)
        torch.cuda.synchronize()
    fused_kernels = [ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and not ev.name.startswith(("Memcpy", "Memset"))]
    print(f"mcmc fused best at R 8: {len(fused_kernels)} device launch(es) under torch.profiler "
          f"{fused_kernels}")
    if len(fused_kernels) != 1:
        fail(f"mcmc fused best at R 8 took {len(fused_kernels)} device launches, not 1")

    # ------------------------------------------------------------ 3d. flash attention
    # The flash kernel against its plain version (same blocked algorithm;
    # only the float32 summation order differs, and in bf16 where p is
    # rounded against a running max) and against the naive oracle at the
    # reference's bounds, before any path uses it.
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def attn_inputs(b, sq, skv, h, kv, d, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d))]

    f32, bf16 = torch.float32, torch.bfloat16
    fa_cases = [(2, 256, 256, 4, 2, d, dt, causal, None)  # GQA 2:1, each head dim
                for dt in (f32, bf16) for d in (16, 32, 64, 128) for causal in (True, False)]
    for dt in (f32, bf16):
        fa_cases += [(1, 256, 256, 2, 2, 64, dt, True, 64),  # sliding window
                     (1, 256, 256, 8, 1, 32, dt, True, None),  # MQA
                     (1, 64, 256, 2, 2, 64, dt, True, None),  # Sq < Skv
                     (2, 64, 64, 2, 2, 64, dt, True, None),
                     (1, 2048, 2048, 2, 2, 64, dt, True, None)]
        fa_cases += [(1, 128, 64, 2, 2, 64, dt, True, None)]  # Sq > Skv: rows with no real key
    fa_cases += [(8, 2048, 2048, 12, 12, 64, bf16, True, None),  # the stage's buckets
                 (4, 1024, 1024, 12, 12, 64, bf16, True, None),
                 (8, 2048, 2048, 8, 2, 128, bf16, True, None),  # the 2048 bucket, GQA 4:1, D 128
                 (1, 256, 256, 8, 2, 128, bf16, True, 64),  # sliding window, D 128
                 (1, 64, 256, 2, 2, 128, bf16, True, None),  # Sq < Skv, D 128
                 (2, 64, 64, 2, 2, 128, bf16, True, None),  # Skv 64, D 128
                 (2, 256, 256, 4, 2, 80, bf16, True, None),  # zamba2's 80, padded to 128
                 # The model families' calls (phase 4g), each at S 2048:
                 (2, 2048, 2048, 32, 32, 80, bf16, True, None),  # zamba2: D 80 padded, wgmma
                 (2, 2048, 2048, 48, 8, 128, bf16, True, 4096),  # mixtral: GQA 6:1, window 4096
                 (2, 2048, 2048, 32, 8, 128, bf16, True, None),  # llama-3.2-vision: 32 / 8
                 (8, 2048, 2048, 16, 16, 128, bf16, True, None),  # qwen2-moe: the 2048 bucket
                 (2, 2048, 2048, 16, 16, 64, bf16, True, None),  # whisper's decoder, D 64
                 (2, 1024, 1024, 16, 16, 64, bf16, False, None),  # non-causal, D 64
                 # The float32 route at phase 5's shapes: the stage's 2048
                 # bucket and qwen2-moe's call.
                 (8, 2048, 2048, 12, 12, 64, f32, True, None),
                 (8, 2048, 2048, 16, 16, 128, f32, True, None)]
    routes = {"tf32": 0, "wgmma": 0}
    route_rows = {"tf32": "flash_attention_tf32", "wgmma": "flash_attention"}
    for row in route_rows.values():
        errs[row] = 0.0
    for b, sq, skv, h, kv, d, dt, causal, window in fa_cases:
        q, k, v = attn_inputs(b, sq, skv, h, kv, d, dt)
        before = dict(fa.flash_attention_cuda.route_launches)
        got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window).float()
        took = [r for r, n in fa.flash_attention_cuda.route_launches.items() if n > before[r]]
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window).float()
        tol, ref_tol = (2e-5, 2e-3) if dt == f32 else (1.6e-2, 3e-2)
        label = (f"B={b} Sq={sq} Skv={skv} H={h} KV={kv} D={d} {str(dt)[6:]} causal={causal} "
                 f"window={window}")
        wanted_route = "wgmma" if dt == bf16 and d > 32 else "tf32"
        if took != [wanted_route]:
            fail(f"flash_attention ({label}) took route {took}, not {wanted_route}")
        routes[wanted_route] += 1
        err = (got - want).abs()
        if not bool((err <= tol + tol * want.abs()).all()):
            fail(f"flash_attention vs plain ({label}, {took[0]}): max err {float(err.max())}")
        # The naive oracle's -inf masks give NaN on a row with no real key.
        ref_note = ""
        if sq <= skv:
            ref = kref.ref_attention(q, k, v, causal=causal, window=window).float()
            ref_err = (got - ref).abs()
            if not bool((ref_err <= ref_tol + ref_tol * ref.abs()).all()):
                fail(f"flash_attention vs ref_attention ({label}, {took[0]}): max err "
                     f"{float(ref_err.max())}")
            ref_note = f", vs ref {float(ref_err.max()):.3e}"
        print(f"  flash {label}: route {took[0]}, max err vs plain {float(err.max()):.3e}{ref_note}")
        row = route_rows[wanted_route]
        errs[row] = max(errs[row], float(err.max()))
        del q, k, v, got, want
    torch.cuda.synchronize()
    print(f"flash_attention vs plain: ok in {len(fa_cases)} cases ({routes['wgmma']} through "
          f"wgmma, {routes['tf32']} through the split-TF32 kernel; f32 / bf16, causal / full, "
          f"window 64, GQA 2:1, 4:1 and 6:1, MQA, Sq < Skv, Skv 64, Sq > Skv, D 16-128, S "
          f"64-2048, the stage's (8, 2048) and (4, 1024) buckets, the model families' calls); "
          f"max err {errs['flash_attention']:.3e} (wgmma), {errs['flash_attention_tf32']:.3e} "
          f"(split-TF32)")

    # ------------------------------------------------------------ 4. main path
    cfg = SolveConfig(solver="cobi", iterations=ITERATIONS, reads=READS, steps=STEPS)
    bounds = metrics.reference_bounds(problem)
    launches = {}

    reset_counts()
    t0 = time.perf_counter()
    rep = solve_es(problem, key, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    direct = counts()
    score = float(metrics.normalized_objective(rep.objective, bounds))
    rep_cpu = solve_es(problem, key, cfg, device="cpu")
    score_cpu = float(metrics.normalized_objective(rep_cpu.objective, bounds))
    print(f"direct: N={problem.n} M={problem.m} selected {rep.selection.nonzero()[0].tolist()} "
          f"norm_obj {score:.6f} (plain on CPU {score_cpu:.6f}) wall {wall:.3f} s "
          f"launches {direct}")
    if rep.selection.sum() != problem.m or not math.isfinite(rep.objective):
        fail(f"direct summary selects {rep.selection.sum()} != {problem.m}")
    if score <= 0.8:
        fail(f"direct normalized objective {score} <= 0.8")
    if abs(score - score_cpu) > 0.05:
        fail(f"card and CPU objectives differ by {abs(score - score_cpu)} > 0.05")
    want = expect(cobi_trajectory=ITERATIONS, ising_energy=ITERATIONS)
    if direct != want:
        fail(f"direct path launches {direct} != {want}")

    big = problem_from_sentences(synthetic_document(11, 100), m=6, lam=0.5, device=dev)
    dcfg = SolveConfig(solver="cobi", iterations=ITERATIONS, reads=READS, steps=STEPS,
                       decompose=True, p=20, q=10)
    reset_counts()
    t0 = time.perf_counter()
    drep = solve_es(big, prng.key(1), dcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decomposed = counts()
    print(f"decomposed: N={big.n} M={big.m} selected {drep.selection.nonzero()[0].tolist()} "
          f"objective {drep.objective:.6f} solves x iterations {drep.solver_invocations} "
          f"wall {wall:.3f} s launches {decomposed}")
    if drep.selection.sum() != big.m or not math.isfinite(drep.objective):
        fail(f"decomposed summary selects {drep.selection.sum()} != {big.m}")
    n_inv = drep.solver_invocations
    want = expect(cobi_trajectory=n_inv, ising_energy=n_inv)
    if decomposed != want:
        fail(f"decomposed path launches {decomposed} != {want}")

    # The solver's fused readouts over the direct document's rounded
    # instances: reduce="best" must pick what reduce="topk" ranks first.
    cobi = ising_solver("cobi")
    ising_fp = improved_ising(problem)
    reset_counts()
    for kq, ks in pipeline._iteration_keys(key, ITERATIONS):
        q = quantize_ising(ising_fp, key=kq).ising
        best = cobi(q, ks, reads=READS, steps=STEPS, reduce="best")
        top = cobi(q, ks, reads=READS, steps=STEPS, reduce="topk")
        if not (torch.equal(best.energies, top.energies[:1])
                and torch.equal(best.spins, top.spins[:1])):
            fail("solver reduce='best' != reduce='topk' first read")
    reduced = counts()
    print(f"reduce paths: launches {reduced}")
    want = expect(cobi_fused_best=ITERATIONS, cobi_readout=ITERATIONS)
    if reduced != want:
        fail(f"reduce paths launches {reduced} != {want}")
    for name in counted:
        launches[name] = direct[name] + decomposed[name] + reduced[name]
    launches["flash_attention_tf32"] = 0  # "flash_attention" counts the wgmma route's

    # ------------------------------------------------------------ 4b. the chip farm
    n_docs = len(farm_docs)

    def same(a, b) -> bool:
        return (np.array_equal(a.selection, b.selection) and a.objective == b.objective
                and np.array_equal(a.curve, b.curve))

    def drive_lockstep(farm, barrier, cfg=farm_cfg):
        """16 generators in lockstep: every generator submits its round,
        ``barrier()`` (a drain, or a flush hint to the background loop),
        then every generator reduces.  Returns the reports and the host
        seconds of each part: submit (formulation, rounding, submission),
        barrier, and reduce (waiting on futures, repair, best-of)."""
        split = dict(submit=0.0, barrier=0.0, reduce=0.0)
        t = time.perf_counter()
        gens = [pipeline.iter_solve_es(doc, k, cfg, backend=farm)
                for doc, k in zip(farm_docs, farm_keys)]
        reports, active = [None] * len(gens), set(range(len(gens)))
        for g in gens:
            next(g)
        split["submit"] += time.perf_counter() - t
        while active:
            t = time.perf_counter()
            barrier()
            split["barrier"] += time.perf_counter() - t
            t = time.perf_counter()
            for i in sorted(active):
                try:
                    gens[i].send(None)
                except StopIteration as done:
                    reports[i] = done.value
                    active.discard(i)
            split["reduce"] += time.perf_counter() - t
        return reports, split

    def span_seconds(farm) -> dict:
        """Wall seconds per farm span name (the drain's pack, place, launch
        and readout phases) from the farm's tracer."""
        out: dict = {}
        for r in farm.obs.tracer.records():
            if r["kind"] == "span" and r["name"] != "farm.job":
                out[r["name"]] = out.get(r["name"], 0.0) + r["t1"] - r["t0"]
        return {k: round(v, 6) for k, v in sorted(out.items())}

    def farm_line(label, farm, wall, c, n_req) -> None:
        st = farm.stats()
        print(f"{label}: wall {wall:.3f} s drains {st.drains} bins {st.super_instances} "
              f"occupancy {st.mean_occupancy:.4f} bytes/request h2d {st.bytes_h2d / n_req:.1f} "
              f"d2h {st.bytes_d2h / n_req:.1f} launches {c}")
        want = expect(cobi_fused_best_batched=st.drains)  # one (schedule, tier) group
        if c != want:
            fail(f"{label} launches {c} != {want} ({st.drains} drains of one group each)")

    reset_counts()
    t0 = time.perf_counter()
    inline = [solve_es(doc, k, farm_cfg) for doc, k in zip(farm_docs, farm_keys)]
    torch.cuda.synchronize()
    inline_wall = time.perf_counter() - t0
    c = counts()
    print(f"farm mix inline: {n_docs} documents wall {inline_wall:.3f} s launches {c}")
    if c != expect(cobi_trajectory=n_docs * FARM_ITERATIONS, ising_energy=n_docs * FARM_ITERATIONS):
        fail(f"farm mix inline launches {c}")
    for name in counted:
        launches[name] += c[name]

    for policy in ("manual", "bin-full"):
        farm = CobiFarm(4, policy=policy, obs=Observability())
        reset_counts()
        t0 = time.perf_counter()
        reps, split = drive_lockstep(farm, farm.drain if policy == "manual" else farm.flush_hint)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        farm.close()
        farm_line(f"farm {policy}: {n_docs} documents (inline {inline_wall:.3f} s)", farm, wall,
                  c, n_docs)
        print(f"farm {policy} host split (s): " + " ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; drain spans (s): {span_seconds(farm)}")
        for i, (a, b) in enumerate(zip(inline, reps)):
            if not same(a, b):
                fail(f"farm {policy} document {i}: {b.objective} != inline {a.objective}")
        for name in counted:
            launches[name] += c[name]
    print(f"farm paths: all {n_docs} documents equal their inline solves bitwise")

    # The submit phase of the lockstep drive, split: the formulation per
    # document, the stochastic roundings (on the card, one batched call per
    # document as pipeline._submit_iterations makes it, and for the record
    # one call per key), and the farm's submit (host copy of each instance,
    # programmability check).  One batched call syncs the host at most once.
    t = time.perf_counter()
    forms = [improved_ising(doc) for doc in farm_docs]
    torch.cuda.synchronize()
    t_form = time.perf_counter() - t
    doc_keys = [pipeline._iteration_keys(k, FARM_ITERATIONS) for k in farm_keys]
    t = time.perf_counter()
    rounded = []
    for fp, pairs in zip(forms, doc_keys):
        qs = quantize_ising_many(fp, [kq for kq, _ in pairs], farm_cfg.rounding,
                                 int_range=farm_cfg.int_range)
        rounded += [(q.ising, ks) for q, (_, ks) in zip(qs, pairs)]
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t
    t = time.perf_counter()
    per_key = [quantize_ising(fp, farm_cfg.rounding, int_range=farm_cfg.int_range, key=kq).ising
               for fp, pairs in zip(forms, doc_keys) for kq, _ in pairs]
    torch.cuda.synchronize()
    t_per_key = time.perf_counter() - t
    if not all(torch.equal(a.h, b.h) and torch.equal(a.j, b.j)
               for (a, _), b in zip(rounded, per_key)):
        fail("quantize_ising_many != one quantize_ising per key")
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        quantize_ising_many(forms[0], [kq for kq, _ in doc_keys[0]], farm_cfg.rounding,
                            int_range=farm_cfg.int_range)
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    probe = CobiFarm(4)
    t = time.perf_counter()
    for q, ks in rounded:
        probe.submit(q, ks, reads=READS, steps=STEPS, reduce="best")
    t_submit = time.perf_counter() - t
    probe.close(drain=False)
    print(f"farm submit split (s): formulation {t_form:.4f} ({n_docs} documents) rounding "
          f"{t_round:.4f} ({len(rounded)} instances in {n_docs} batched calls; one call per key "
          f"{t_per_key:.4f}) submit {t_submit:.4f}; host syncs of one batched call: {syncs}")
    if syncs > 1:
        fail(f"quantize_ising_many synced the host {syncs} times in one call (at most once)")

    farm = CobiFarm(4)
    reset_counts()
    t0 = time.perf_counter()
    drep_farm = solve_es(big, prng.key(1), dcfg, backend=farm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    farm_line(f"farm decomposed: N={big.n} pipelined windows (inline decomposed above)", farm,
              wall, c, 1)
    if not (np.array_equal(drep_farm.selection, drep.selection)
            and drep_farm.objective == drep.objective):
        fail(f"farm decomposed {drep_farm.objective} != inline decomposed {drep.objective}")
    farm.close()
    for name in counted:
        launches[name] += c[name]

    # The two-launch drain (reduce="none"): every read of the 96 instances
    # comes back; each job's first argmin is the fused winner of phase 3b.
    reset_counts()
    t0 = time.perf_counter()
    results = cobi_solver.solve_batch(insts, [k for _, k in farm_jobs], n_chips=4,
                                      reads=READS, steps=STEPS, reduce="none")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    print(f"farm reduce=none: {n_jobs} jobs wall {wall:.3f} s launches {c}")
    if c != expect(cobi_trajectory_batched=1, ising_energy_batched=1):
        fail(f"farm reduce=none launches {c} != one drain of one group")
    for k, res in enumerate(results):
        i = int(np.argmin(res.energies.numpy()))
        e, s_best = winners[k]
        if not (float(res.energies[i]) == e and torch.equal(res.spins[i], s_best)):
            fail(f"reduce=none job {k}: first argmin != fused winner")
    for name in counted:
        launches[name] += c[name]

    # ------------------------------------------------------------ 4c. the MCMC family
    def bank_line(label, reports, wall, c) -> None:
        tot = {f: sum(getattr(r, f) for r in reports)
               for f in ("chip_seconds", "chip_energy_joules", "bytes_h2d", "bytes_d2h")}
        print(f"{label}: wall {wall:.3f} s receipts chip_seconds {tot['chip_seconds']:.6f} "
              f"energy_joules {tot['chip_energy_joules']:.9f} bytes h2d {tot['bytes_h2d']} "
              f"d2h {tot['bytes_d2h']} launches {({k: v for k, v in c.items() if v})}")

    def mcmc_pair(label, run_inline, run_bank, speculates=False) -> tuple:
        """Run a path inline and through a fresh McmcPoolBackend(4), each
        with the counts set to 0 just before; hold them equal bitwise, the
        inline launches to one sweep per solver invocation and the bank's to
        one fused best per job it ran (all of them, unless the pipelined
        windows cancelled queued speculative jobs)."""
        reset_counts()
        t0 = time.perf_counter()
        inline_reps = run_inline()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c_inline = counts()
        bank_line(f"{label} inline", inline_reps, wall, c_inline)
        bank = McmcPoolBackend(workers=4)
        reset_counts()
        t0 = time.perf_counter()
        bank_reps = run_bank(bank)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c_bank = counts()
        bank.close()
        bank_line(f"{label} McmcPoolBackend(4)", bank_reps, wall, c_bank)
        for i, (a, b) in enumerate(zip(inline_reps, bank_reps)):
            if not same(a, b):
                fail(f"{label} {i}: bank {b.objective} != inline {a.objective}")
        n_inline = sum(r.solver_invocations for r in inline_reps)
        n_bank = sum(r.solver_invocations for r in bank_reps)
        ran = int(bank.obs.registry.get("pool_jobs_total").labels(solver="mcmc").value)
        if c_inline != expect(mcmc_sweep_batched=n_inline):
            fail(f"{label} inline launches {c_inline} != {n_inline} sweeps")
        if c_bank != expect(mcmc_fused_best_batched=ran) or not (
                ran <= n_bank if speculates else ran == n_bank):
            fail(f"{label} bank launches {c_bank}: {ran} jobs ran of {n_bank} submitted")
        for name in counted:
            launches[name] += c_inline[name] + c_bank[name]
        return inline_reps, bank_reps

    mcfg = SolveConfig(solver="mcmc")
    (mrep,), _ = mcmc_pair(
        "mcmc direct", lambda: [solve_es(problem, key, mcfg)],
        lambda bank: [solve_es(problem, key, mcfg, backend=bank)])
    mscore = float(metrics.normalized_objective(mrep.objective, bounds))
    msel = mrep.selection.nonzero()[0].tolist()
    print(f"mcmc direct: N={problem.n} M={problem.m} selected {msel} objective "
          f"{mrep.objective:.6f} norm_obj {mscore:.6f} (cobi {score:.6f}); "
          f"{mcfg.iterations} iterations x {mcfg.reads} reads x {MCMC_SWEEPS} sweeps")
    if msel != MCMC_DIRECT_SELECTION:
        fail(f"mcmc direct selects {msel} != the reference's {MCMC_DIRECT_SELECTION}")
    mdcfg = SolveConfig(solver="mcmc", decompose=True, p=20, q=10)
    (mdrep,), _ = mcmc_pair(
        f"mcmc decomposed N={big.n}", lambda: [solve_es(big, prng.key(1), mdcfg)],
        lambda bank: [solve_es(big, prng.key(1), mdcfg, backend=bank)], speculates=True)
    print(f"mcmc decomposed: selected {mdrep.selection.nonzero()[0].tolist()} objective "
          f"{mdrep.objective:.6f} solves x iterations {mdrep.solver_invocations}")
    if mdrep.selection.sum() != big.m or not math.isfinite(mdrep.objective):
        fail(f"mcmc decomposed selects {mdrep.selection.sum()} != {big.m}")
    mfarm_cfg = dataclasses.replace(farm_cfg, solver="mcmc")
    mcmc_pair(f"mcmc farm mix: {n_docs} documents",
              lambda: [solve_es(doc, k, mfarm_cfg) for doc, k in zip(farm_docs, farm_keys)],
              lambda bank: drive_lockstep(bank, bank.drain, mfarm_cfg)[0])
    print(f"mcmc paths: direct, decomposed and {n_docs} documents equal their inline solves bitwise")

    # ------------------------------------------------------------ 4d. the encoder backbone
    # sbert-paper at full width (12 layers, d 768, 12 heads of 64, SwiGLU
    # 3072, bf16), weights from the port's own init_params(seed 0).  The
    # traffic: the direct document and the farm mix's documents that fit
    # max_len = 2048 (n <= 26; the longer ones the reference truncates):
    # two jobs in the 1024 bucket, eight in the 2048 bucket.
    enc_cfg = get_config("sbert-paper")
    enc_model = init_params(enc_cfg, 0)
    enc_docs = [("direct", sents, 6)] + [
        (f"farm{i} n={n}", synthetic_document(100 + i, n), 5)
        for i, n in enumerate(FARM_SIZES) if n <= ENCODER_MAX_SIZE]
    enc_tokens = sum(1 + sum(len(t.encode("utf-8")) + 1 for t in d) for _, d, _ in enc_docs)

    def encode_all(impl: str) -> tuple:
        """Submit every document at once to a fresh stage; returns the
        stage (closed), the embeddings, the receipts and the flash launches
        of its drains (prewarm excluded)."""
        stage = EncoderStage(enc_cfg, enc_model, max_len=2048, attn_impl=impl,
                             linger=ENCODER_LINGER)
        for length, b_pad in ((1024, 4), (2048, 8)):
            stage.prewarm(lengths=[length], batches=[b_pad], segments=[32])
        reset_counts()
        futs = [stage.submit(d, tag=i) for i, (_, d, _) in enumerate(enc_docs)]
        embs = [f.result(timeout=600) for f in futs]
        c = counts()
        stage.close()
        return stage, embs, [f.receipt() for f in futs], c

    enc_paths = {}
    for impl in ("flash", "sdpa", "auto"):
        t0 = time.perf_counter()
        stage, embs, receipts, c = encode_all(impl)
        wall = time.perf_counter() - t0
        st = stage.stats()
        want = expect(flash_attention=enc_cfg.n_layers * st.launches if impl == "flash" else 0)
        if c != want:
            fail(f"encoder {impl}: launches {c} != {want} ({st.launches} stage launches)")
        if impl == "flash":
            add_flash_launches(launches, c, "wgmma")
        for (name, d, _), e in zip(enc_docs, embs):
            if e.shape != (len(d), enc_cfg.d_model) or not bool(torch.isfinite(e).all()):
                fail(f"encoder {impl} {name}: embeddings {tuple(e.shape)} not finite / not "
                     f"({len(d)}, {enc_cfg.d_model})")
        per_bucket = {}
        for r in receipts:
            per_bucket[r.padded_len] = per_bucket.get(r.padded_len, 0.0) + r.encoder_seconds
        print(f"encoder {impl}: {len(enc_docs)} documents {enc_tokens} tokens, stage wall "
              f"{wall:.3f} s (with prewarm), encode wall per bucket (s) "
              + " ".join(f"{k}: {v:.6f}" for k, v in sorted(per_bucket.items()))
              + f", tokens/s {st.tokens / st.busy_seconds:.1f}, launches {c}")
        print(f"encoder {impl} stats: {dataclasses.asdict(st)}")
        print(f"encoder {impl} busy intervals (s): "
              f"{[(round(a - stage._t0, 6), round(b - stage._t0, 6)) for a, b in stage.busy_intervals()]}")
        enc_paths[impl] = (embs, receipts)
    for r in enc_paths["flash"][1]:
        print(f"encoder flash receipt: {dataclasses.asdict(r)}")

    # Flash against sdpa and auto on the same texts.
    flash_embs = enc_paths["flash"][0]
    for impl in ("sdpa", "auto"):
        other = enc_paths[impl][0]
        err = max(float((a - b).abs().max()) for a, b in zip(flash_embs, other))
        cos = min(float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())
                  for a, b in zip(flash_embs, other))
        print(f"encoder flash vs {impl}: max abs err {err:.3e}, min sentence cosine {cos:.6f}")
        if cos < 0.999:
            fail(f"encoder flash vs {impl}: min sentence cosine {cos} < 0.999")

    # Batch composition: the direct document (row 0 of the 2048 drain of
    # eight) alone in a padded batch of the same shape, through the stage's
    # own batch function, bit for bit; and through a fresh stage's solo
    # submit (a batch padded to 4), printed.
    tok = ByteTokenizer()
    d_tokens, d_segs = tok.encode_sentences(sents, 2048)
    tokens8 = torch.zeros((8, 2048), dtype=torch.int32, device=dev)
    segs8 = torch.full((8, 2048), -1, dtype=torch.int32, device=dev)
    tokens8[0], segs8[0] = torch.from_numpy(d_tokens), torch.from_numpy(d_segs)
    alone = enc_serving._embed_batch(enc_cfg.replace(attn_impl="flash"), enc_model, tokens8,
                                     segs8, 32)[0, :len(sents)]
    if not torch.equal(alone, flash_embs[0]):
        fail(f"direct document alone in a batch of 8 != its batched drain: max err "
             f"{float((alone - flash_embs[0]).abs().max())}")
    with EncoderStage(enc_cfg, enc_model, max_len=2048, attn_impl="flash") as solo_stage:
        f = solo_stage.submit(sents)
        solo = f.result(timeout=600)
    print(f"encoder batch composition: direct document alone in a padded batch of 8 == batched "
          f"drain bit for bit; solo submit (padded batch {enc_serving._bucket(1, 4)}, "
          f"{f.receipt().batch_jobs} job) max abs diff {float((solo - flash_embs[0]).abs().max()):.3e}")

    # The synchronous twin: BackboneEncoder pads the direct document to
    # max_len alone (batch 1) and runs the same pass; 12 flash launches.
    flash_cfg = enc_cfg.replace(attn_impl="flash")
    reset_counts()
    benc = BackboneEncoder(flash_cfg, enc_model, max_len=2048).encode(sents)
    c = counts()
    if c != expect(flash_attention=enc_cfg.n_layers):
        fail(f"BackboneEncoder launches {c} != {enc_cfg.n_layers} flash")
    add_flash_launches(launches, c, "wgmma")
    cos = float(torch.nn.functional.cosine_similarity(benc, flash_embs[0], dim=-1).min())
    print(f"encoder BackboneEncoder: direct document at batch 1, max abs diff "
          f"{float((benc - flash_embs[0]).abs().max()):.3e} from the stage's row, min sentence "
          f"cosine {cos:.6f}")
    if benc.shape != flash_embs[0].shape or cos < 0.999:
        fail(f"BackboneEncoder {tuple(benc.shape)} vs the stage's row: min cosine {cos}")
    if args.save_embeddings:
        saved = {name.split()[0]: e.float().cpu().numpy()
                 for (name, _, _), e in zip(enc_docs, flash_embs)
                 if name.split()[0] in ("direct", "farm1")}
        Path(args.save_embeddings).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.save_embeddings, **saved)
        print(f"encoder embeddings saved: {sorted(saved)} to {args.save_embeddings}")

    # The slice end to end: each path's embeddings -> mu/beta -> solve_es on
    # the card with SolveConfig().  As in phase 4, the direct document's
    # flash summary must clear the reference's bar, and every flash summary
    # must come within 0.05 (normalized) of the plain versions' solve of the
    # same embeddings on the CPU.
    def solve_embedded(d, m, e, device):
        prob = problem_from_sentences(d, m=m, lam=0.5, device=device,
                                      encoder=types.SimpleNamespace(encode=lambda _s: e))
        erep = solve_es(prob, key, SolveConfig(), device=device)
        return erep, float(metrics.normalized_objective(erep.objective,
                                                        metrics.reference_bounds(prob)))

    cpu_scores = {name: solve_embedded(d, m, e.cpu(), "cpu")[1]
                  for (name, d, m), e in zip(enc_docs, enc_paths["flash"][0])}
    reset_counts()
    for impl, (embs, _) in enc_paths.items():
        for (name, d, m), e in zip(enc_docs, embs):
            erep, escore = solve_embedded(d, m, e, dev)
            print(f"encoder {impl} {name}: N={len(d)} M={m} selected "
                  f"{erep.selection.nonzero()[0].tolist()} norm_obj {escore:.6f}"
                  + (f" (plain on CPU {cpu_scores[name]:.6f})" if impl == "flash" else ""))
            if impl != "flash":
                continue
            if erep.selection.sum() != m or abs(escore - cpu_scores[name]) > 0.05:
                fail(f"encoder flash {name}: selects {erep.selection.sum()} of {m}, normalized "
                     f"objective {escore} vs {cpu_scores[name]} on the CPU")
            if name == "direct" and escore <= 0.8:
                fail(f"encoder flash direct: normalized objective {escore} <= 0.8")
    c = counts()
    n_solves = len(enc_paths) * len(enc_docs) * SolveConfig().iterations
    if c != expect(cobi_trajectory=n_solves, ising_energy=n_solves):
        fail(f"encoder solves launches {c}")
    for name in counted:
        launches[name] += c[name]

    # The query cache: a repeated submit_query is a hit with the same row.
    with EncoderStage(enc_cfg, enc_model, max_len=2048, attn_impl="flash") as qstage:
        e1 = qstage.submit_query(sents[0]).result(timeout=600)
        e2 = qstage.submit_query(sents[0]).result(timeout=600)
        print(f"encoder query cache: {qstage.cache_stats()}")
        if not torch.equal(e1, e2) or qstage.cache_stats()["hits"] != 1:
            fail("encoder query cache: the repeated query was not a bit-identical hit")

    # ------------------------------------------------------------ 4e. where the encode time goes
    # The first drain of each bucket in a prewarmed stage (its prewarm ran
    # on the drive thread, so that pass should be warm too) against the
    # same pass warm on this thread, timed to a synchronise as the stage
    # times its passes, in five paired rounds: a fresh flash stage (whose
    # embeddings must equal 4d's bit for bit), then each bucket's warm pass
    # after the idle that a first drain follows (the stage's linger).  The
    # median of the rounds' ratios is held to 1.5x: the 1024 bucket's pass
    # is host-bound (its Python launches take about as long as its device
    # work), so one pass varies with the host's load, up to 2x on a shared
    # H100 host, and drifts over a run.  Then the 2048 bucket's pass under
    # torch.profiler, its device time split by kernel: flash, cuBLAS GEMMs,
    # the rest; what the device does not cover of the wall is idle.
    passes = {}
    for length in (1024, 2048):
        group = [d for (_, d, _), r in zip(enc_docs, enc_paths["flash"][1]) if r.padded_len == length]
        b_pad = enc_serving._bucket(len(group), enc_serving.BATCH_BUCKET)
        tk = torch.zeros((b_pad, length), dtype=torch.int32, device=dev)
        sg = torch.full((b_pad, length), -1, dtype=torch.int32, device=dev)
        for i, d in enumerate(group):
            t_np, s_np = tok.encode_sentences(d, length)
            tk[i], sg[i] = torch.from_numpy(t_np), torch.from_numpy(s_np)
        passes[length] = lambda tk=tk, sg=sg: enc_serving._embed_batch(flash_cfg, enc_model, tk, sg, 32)
        passes[length]()
    torch.cuda.synchronize()
    rounds = {length: [] for length in passes}  # (first drain, warm pass) seconds
    for _ in range(5):
        _, embs, receipts, _ = encode_all("flash")
        if any(not torch.equal(a, b) for a, b in zip(embs, flash_embs)):
            fail("encoder: a fresh flash stage's embeddings differ from phase 4d's")
        per_bucket = {}
        for r in receipts:
            per_bucket[r.padded_len] = per_bucket.get(r.padded_len, 0.0) + r.encoder_seconds
        for length, run in passes.items():
            time.sleep(ENCODER_LINGER)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            rounds[length].append((per_bucket[length], time.perf_counter() - t0))
    for length, pairs in rounds.items():
        ratio = float(np.median([first / w for first, w in pairs]))
        print(f"encoder first drain vs warm, {length} bucket (s, first drain / warm pass after "
              f"{ENCODER_LINGER} s idle): " + " ".join(f"{f:.6f}/{w:.6f}" for f, w in pairs)
              + f"; median ratio {ratio:.3f}")
        if ratio > 1.5:
            fail(f"encoder {length} bucket: the prewarmed stage's first pass took {ratio:.2f}x "
                 f"the warm pass")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        passes[2048]()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split, kernels_us = {"flash": 0.0, "gemm": 0.0, "other": 0.0}, {}
    flash_by_name = dict.fromkeys(fa.KERNEL_NAMES, 0.0)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        name, us = ev.key, ev.self_device_time_total
        kernels_us[name] = us
        flash_name = next((n for n in fa.KERNEL_NAMES if n in name), None)
        kind = "flash" if flash_name else "gemm" if is_gemm(name) else "other"
        split[kind] += us
        if flash_name:
            flash_by_name[flash_name] += us
    busy_ms = sum(split.values()) / 1e3
    if busy_ms <= 0:
        print("encoder profile: the profiler recorded no device time: split not measured")
    else:
        print(f"encoder profile, 2048 bucket (B=8): wall {wall * 1e3:.3f} ms, device busy "
              f"{busy_ms:.3f} ms (idle share {1 - busy_ms / (wall * 1e3):.4f}); flash "
              f"{split['flash'] / 1e3:.3f} ms ("
              + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us in flash_by_name.items())
              + f"), GEMMs {split['gemm'] / 1e3:.3f} ms, other kernels "
              f"{split['other'] / 1e3:.3f} ms")
        top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:10]
        print("encoder profile, top kernels (ms): "
              + "; ".join(f"{n[:60]} {us / 1e3:.3f}" for n, us in top))
    del enc_paths, flash_embs, passes

    # ------------------------------------------------------------ 4f. the serving engine
    t_phase = time.perf_counter()
    served_batch = serve_phase(dev, reset_counts, counts, launches, problem, key)
    print(f"serve phase wall: {time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------------------------------ 4g. the model families
    families_phase(dev, reset_counts, counts, expect, launches, enc_docs, key)

    # ------------------------------------------------------------ 4h. prefill and decode
    decode_phase(dev, reset_counts, counts, expect, launches)
    depth_phase(dev, reset_counts, counts, expect, launches)

    # ------------------------------------------------------------ 4i. training
    train = train_phase(dev, reset_counts, counts, expect, launches)
    train_depth_phase(dev, reset_counts, counts, expect, launches, enc_docs)
    print(f"run wall after phase 4i (2): {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------------ 4j. distributed
    distributed_phase(dev, reset_counts, counts, expect, launches, train)

    # ------------------------------------------------------------ 4k. the sLSTM scan
    slstm_rows = slstm_phase(dev, launches, slstm_dry)

    # ------------------------------------------------------------ 4l. calibration
    calibration_phase(dev, reset_counts, counts, launches, *served_batch)

    # ------------------------------------------------------------ 5. timing
    op, mask, rd = operands(READS, k_solve)
    full = dict(steps=STEPS, dt=0.35, ks_max=1.2)
    spins = kref.sign_spins(cd.cobi_trajectory_cuda(op.j_scaled, op.h_scaled, op.phi0, **full))
    jobs = {
        "cobi_trajectory": (
            lambda: cd.cobi_trajectory_cuda(op.j_scaled, op.h_scaled, op.phi0, **full),
            lambda: cd.cobi_trajectory_plain(op.j_scaled, op.h_scaled, op.phi0, **full),
            "src/repro/kernels/cobi_dynamics.py:232", "cobi_dynamics.cu"),
        "cobi_fused_best": (
            lambda: cd.cobi_fused_best_cuda(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig,
                                            mask, rd, op.phi0, **full),
            lambda: cd.cobi_fused_best_plain(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig,
                                             mask, rd, op.phi0, **full),
            "src/repro/kernels/cobi_dynamics.py:300", "cobi_dynamics.cu"),
        "cobi_readout": (
            lambda: cd.cobi_readout_cuda(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig,
                                         op.phi0, **full),
            lambda: cd.cobi_readout_plain(op.j_scaled, op.h_scaled, op.j_orig, op.h_orig,
                                          op.phi0, **full),
            "src/repro/kernels/cobi_dynamics.py:419", "cobi_dynamics.cu"),
    }
    # Two bounds: at the operands as the reference's kernels take them (R=8
    # rows, 128 padded lanes, 8 padded slots), and at the instance's own n
    # spins, its reads and its one slot; every row carries both.  bound_ms is
    # the work this run's data needs: the COBI kernels run repro::anneal,
    # whose loop skips the lanes past the live extent, the MCMC kernels
    # anneal the instance's own spins only, and the energy kernel is handed
    # the instance's own spins, h and J, so theirs is the latter; the stacked
    # energy scores the farm's stack at its width (128 lanes), so its bound
    # is the former.
    n_real = problem.n

    def bounds(name, padded, own) -> dict:
        """The row's bound keys from its (ms, by) at the padded shapes and at
        the instances' own spins."""
        (p_ms, p_by), (u_ms, u_by) = padded, own
        skips_padding = name == "ising_energy" or name.startswith(("cobi_", "mcmc_"))
        return {"bound_ms": u_ms if skips_padding else p_ms,
                "bound_by": u_by if skips_padding else p_by,
                "bound_padded_ms": p_ms, "bound_padded_by": p_by,
                "bound_unpadded_ms": u_ms, "bound_unpadded_by": u_by}

    reset_counts()  # timing launches are not the main path's
    rows = []
    for name, (kern, plain, replaces, source) in jobs.items():
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        (b_ms, by), (u_ms, u_by) = (bound_ms(*work(name, op.r_pad, op.n_pad, mask.shape[1])),
                                    bound_ms(*work(name, READS, n_real, 1)))
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            **bounds(name, (b_ms, by), (u_ms, u_by)),
        })
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.6f} ms ({by}) at R={op.r_pad} N={op.n_pad}, "
              f"{u_ms:.6f} ms ({u_by}) at R={READS} N={n_real}; steps={STEPS}")

    # The energy kernel as the main path calls it: cobi_anneal(reduce="none")
    # hands ops.ising_energy the int8 (8, 20) spins of the direct document's
    # instance and its unpadded h and J.  Timed with CUDA events through ops
    # (ms, the wrapper included), from the C entry (ms_entry), as the
    # tile-aligned twin ising_energy_cuda on the (8, 128) float32 padded
    # operands (ms_twin), and from the C entry at R 1, n 1 (ms_floor: the
    # launch floor).  Back-to-back calls of a kernel this short measure the
    # host, so the kernel's own device time under torch.profiler stands
    # beside them (ms_device, ms_floor_device).  The bound counts the int8
    # spins at a byte each.
    e_lib = _build.library("ising_energy")

    def energy_entry(s, h, j):
        """A call of the energy kernel's C entry on one instance, its output
        made beforehand."""
        out = torch.empty((1, s.shape[0]), device=dev)
        args = (s.data_ptr(), int(s.dtype == torch.int8), h.data_ptr(), j.data_ptr(),
                out.data_ptr(), 1, s.shape[0], s.shape[1], s.numel(), s.stride(0), h.shape[-1],
                j.numel(), j.stride(0), _build.stream_of(s))
        return lambda: _build.check(e_lib.ising_energy(*args), "ising_energy")

    s_main = spins[:, :n_real].to(torch.int8)
    ms = cuda_ms(lambda: ops.ising_energy(s_main, inst.h, inst.j), reps=200)
    entry_ms = cuda_ms(energy_entry(s_main, inst.h, inst.j), reps=500)
    twin_ms = cuda_ms(lambda: ie.ising_energy_cuda(spins, op.h_orig, op.j_orig), reps=200)
    s_one = torch.ones((1, 1), dtype=torch.int8, device=dev)
    floor_entry = energy_entry(s_one, inst.h[:1], inst.j[:1, :1].contiguous())
    floor_ms = cuda_ms(floor_entry, reps=500)
    dev_ms = device_ms(lambda: ops.ising_energy(s_main, inst.h, inst.j), reps=200)
    floor_dev_ms = device_ms(floor_entry, reps=200)
    plain_ms = cuda_ms(lambda: ie.ising_energy_plain(s_main, inst.h[None], inst.j), reps=50,
                       warmup=1)
    (b_ms, by) = bound_ms(*work("ising_energy", op.r_pad, op.n_pad, 0))
    (u_ms, u_by) = bound_ms(*work("ising_energy", READS, n_real, 0, spin_bytes=1))
    rows.append({
        "name": "ising_energy", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ising_energy.cu",
        "replaces": "src/repro/kernels/ising_energy.py:43", "launches": launches["ising_energy"],
        "max_abs_err": errs["ising_energy"], "ms": ms, "ms_entry": entry_ms, "ms_twin": twin_ms,
        "ms_floor": floor_ms, "ms_device": dev_ms, "ms_floor_device": floor_dev_ms,
        "plain_ms": plain_ms, "library_ms": None,
        **bounds("ising_energy", (b_ms, by), (u_ms, u_by)),
    })
    print(f"time ising_energy: {ms:.4f} ms through ops.ising_energy (R={READS}, n={n_real}, int8), "
          f"{entry_ms:.4f} ms from its C entry, device {dev_ms:.5f} ms (profiler), tile-aligned "
          f"twin {twin_ms:.4f} ms (R={op.r_pad}, N={op.n_pad}, float32), launch floor "
          f"{floor_ms:.4f} ms (C entry, R=1, n=1; device {floor_dev_ms:.5f} ms), plain "
          f"{plain_ms:.4f} ms, bound {u_ms:.6f} ms ({u_by}) at R={READS} n={n_real} int8, "
          f"{b_ms:.6f} ms ({by}) at R={op.r_pad} N={op.n_pad} float32")

    # The batched kernels at the 16-document drain's shapes: the fused best
    # and the trajectory on its padded bins (B, R=8, 128 lanes, S slots),
    # the stacked energy on the two-launch drain's (jobs, R=8, 128) stack.
    # Unpadded: each job's own n spins, its reads and its one slot.
    fused_ops = [opd[k] for k in fused_keys]
    job_shapes = [(READS, slot.n, 1) for _, _, slot in slots]
    batched = {
        "cobi_trajectory_batched": (
            lambda: cd.cobi_trajectory_batched_cuda(opd["j"], opd["h"], opd["phi0"], **full),
            lambda: cd.cobi_trajectory_batched_plain(opd["j"], opd["h"], opd["phi0"], **full),
            "src/repro/kernels/cobi_dynamics.py:262", "cobi_dynamics.cu",
            [(READS, 128, s_pad)] * b_bins),
        "ising_energy_batched": (
            lambda: ie.ising_energy_batched_cuda(s_stack, h_stack, j_stack),
            lambda: ie.ising_energy_batched_plain(s_stack, h_stack, j_stack),
            "src/repro/kernels/ising_energy.py:69", "ising_energy.cu",
            [(READS, 128, 0)] * n_jobs),
        "cobi_fused_best_batched": (
            lambda: cd.cobi_fused_best_batched_cuda(*fused_ops, **full),
            lambda: cd.cobi_fused_best_batched_plain(*fused_ops, **full),
            "src/repro/kernels/cobi_dynamics.py:358", "cobi_dynamics.cu",
            [(READS, 128, s_pad)] * b_bins),
    }
    for name, (kern, plain, replaces, source, shapes) in batched.items():
        energy = name == "ising_energy_batched"
        ms = cuda_ms(kern, reps=200 if energy else 10)
        plain_ms = cuda_ms(plain, reps=20 if energy else 2, warmup=1)
        (b_ms, by), (u_ms, u_by) = (bound_ms(*batched_work(name, shapes)),
                                    bound_ms(*batched_work(name, job_shapes)))
        extra = {"ms_device": device_ms(kern, reps=200)} if energy else {}
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, **extra, "plain_ms": plain_ms,
            "library_ms": None, **bounds(name, (b_ms, by), (u_ms, u_by)),
        })
        print(f"time {name}: kernel {ms:.4f} ms"
              + (f" (device {extra['ms_device']:.5f} ms, profiler)" if energy else "")
              + f", plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({by}) at {len(shapes)} x "
              f"(R={READS}, N=128, S={shapes[0][2]}), {u_ms:.6f} ms ({u_by}) at the {n_jobs} jobs' "
              f"own n; steps={STEPS}")

    # The MCMC kernels at the main path's shape: the direct document's first
    # rounded instance (20 spins on 128 lanes), 8 replicas, 50 sweeps, sweep
    # mode, through the wrapper and from the C entry (back-to-back wrapper
    # calls, each with its ladder and three host-to-device copies, can outrun
    # the device).  bound_padded_ms counts 128 proposals a sweep on 128
    # lanes, as the reference's kernel makes them; bound_ms the 20 live ones
    # on the instance's own 20 spins, which is all the kernel anneals.
    mcmc_lib = _build.library("mcmc_dynamics")

    def mcmc_entry(name, mop, sweeps, replica_block):
        """A call of the C entry of kernel ``name`` on operands ``mop``
        (sweep mode, chunk 128), its ladder and outputs made beforehand."""
        j, h, s0, seeds, params = mop
        b, r, n = s0.shape
        temps = md._ladders(params, sweeps).to(dev)
        seeds, params = seeds.to(dev), params.to(dev)
        nblk = r // mcmc_lib.mcmc_block_rows()
        outs = ((torch.empty((b, r), device=dev), torch.empty_like(s0))
                if name == "mcmc_sweep_batched" else
                (torch.empty((b, nblk), device=dev), torch.empty((b, nblk, n), device=dev),
                 torch.empty(b, device=dev), torch.empty((b, n), device=dev)))
        entry = getattr(mcmc_lib, "mcmc_sweep" if name == "mcmc_sweep_batched" else
                        "mcmc_fused_best")
        args = (j.data_ptr(), h.data_ptr(), s0.data_ptr(), seeds.data_ptr(), params.data_ptr(),
                temps.data_ptr(), *(t.data_ptr() for t in outs), b, r, n, sweeps, 128, 0,
                replica_block, _build.stream_of(s0))
        return lambda: _build.check(entry(*args), name)

    mop = mcmc_operands([inst], [k_solve], READS, READS)
    mkw = dict(sweeps=MCMC_SWEEPS, mode="sweep", replica_block=READS)
    mcmc_jobs = {
        "mcmc_sweep_batched": (md.mcmc_sweep_batched, md.mcmc_sweep_batched_plain,
                               "src/repro/kernels/mcmc_dynamics.py:173"),
        "mcmc_fused_best_batched": (md.mcmc_fused_best_batched,
                                    md.mcmc_fused_best_batched_plain,
                                    "src/repro/kernels/mcmc_dynamics.py:222"),
    }
    for name, (kern, plain, replaces) in mcmc_jobs.items():
        ms = cuda_ms(lambda: kern(*mop, **mkw), reps=50)
        entry_ms = cuda_ms(mcmc_entry(name, mop, MCMC_SWEEPS, READS), reps=100)
        plain_ms = cuda_ms(lambda: plain(*mop, **mkw), reps=2, warmup=1)
        b_ms, by = bound_ms(*mcmc_work(name, READS, 128, 128, MCMC_SWEEPS))
        u_ms, u_by = bound_ms(*mcmc_work(name, READS, inst.n, inst.n, MCMC_SWEEPS))
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mcmc_dynamics.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "ms_entry": entry_ms, "plain_ms": plain_ms,
            "library_ms": None, **bounds(name, (b_ms, by), (u_ms, u_by)),
        })
        print(f"time {name}: kernel {ms:.4f} ms through the wrapper, {entry_ms:.4f} ms from its "
              f"C entry, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({by}) at B=1 R={READS} "
              f"N=128 128 proposals a sweep, {u_ms:.6f} ms ({u_by}) at N={inst.n}; "
              f"sweeps={MCMC_SWEEPS}")
    # Flash attention at the stage's buckets (bf16, causal, 12 heads of 64):
    # the kernel (the wgmma route) through its wrapper and from its C entry
    # (back-to-back wrapper calls at the 1024 bucket outrun the host's
    # checks and tensor-map set-up), its plain version, and one PyTorch call
    # of the same function as a yardstick (the port never calls it).  The
    # bound counts 4 B H D flops per unmasked (q, k) pair, S (S + 1) / 2
    # pairs, on the bf16 tensor cores, and q, k, v, o once each; the buckets
    # have no padded lanes, so padded and unpadded bounds agree.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fa_lib = _build.library("flash_attention")
    for b, s_len in ((8, 2048), (4, 1024)):
        q, k, v = attn_inputs(b, s_len, s_len, 12, 12, 64, bf16)
        o_entry = torch.empty_like(q)
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v), reps=20)
        entry_ms = cuda_ms(lambda: _build.check(fa_lib.flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_entry.data_ptr(), b, s_len, s_len, 12, 12,
            64, 1, 0, 0, 64**-0.5, _build.stream_of(q)), "flash_attention (wgmma)"), reps=50)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), reps=5, warmup=1)
        lib_ms = cuda_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      is_causal=True), reps=50)
        flops = 4 * b * 12 * 64 * (s_len * (s_len + 1) // 2)
        nbytes = 4 * q.numel() * q.element_size()
        b_ms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        if (b, s_len) == (8, 2048):
            rows.append({
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:75",
                "launches": launches["flash_attention"],
                "max_abs_err": errs["flash_attention"], "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms,
                **bounds("flash_attention", (b_ms, by), (b_ms, by)),
            })
        print(f"time flash_attention at B={b} S={s_len} H=12 D=64 bf16 causal: kernel (wgmma) "
              f"{ms:.4f} ms through the wrapper ({flops / ms / 1e9:.1f} TFLOP/s), {entry_ms:.4f} ms "
              f"from its C entry ({flops / entry_ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), "
              f"bound {b_ms:.6f} ms ({by}, {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        del q, k, v, o_entry
    # The model families' flash calls (phase 4g): qwen2-moe's stage pass at
    # the 2048 bucket (B 8, 16 heads of 128, qkv bias outside the kernel)
    # and zamba2's shared block (B 2, 32 heads of 80, padded to 128 inside
    # the wrapper), through the wrapper beside their plain version and one
    # SDPA call; bounds at the heads' own D (the padding is the wrapper's).
    flash_row = next(row for row in rows if row["name"] == "flash_attention")
    flash_row["shapes"] = []
    for label, (b, s_len, h, d) in (("qwen2-moe-a2.7b", (8, 2048, 16, 128)),
                                    ("zamba2-2.7b", (2, 2048, 32, 80))):
        q, k, v = attn_inputs(b, s_len, s_len, h, h, d, bf16)
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v), reps=20)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), reps=3, warmup=1)
        lib_ms = cuda_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      is_causal=True), reps=20)
        flops = 4 * b * h * d * (s_len * (s_len + 1) // 2)
        nbytes = 4 * q.numel() * q.element_size()
        b_ms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        flash_row["shapes"].append({"at": f"{label} B={b} S={s_len} H={h} D={d} bf16 causal",
                                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                    "bound_ms": b_ms, "bound_by": by})
        print(f"time flash_attention at {label}'s call (B={b} S={s_len} H={h} D={d} bf16 causal): "
              f"kernel {ms:.4f} ms through the wrapper ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), "
              f"bound {b_ms:.6f} ms ({by}, {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        del q, k, v

    # The float32 route (the split-TF32 kernel) at the stage's 2048 bucket
    # and qwen2-moe's call, float32, causal: through the wrapper and from
    # its C entry (its error against the plain version from the entry's
    # output), the plain version, and SDPA in float32 with its backend
    # pinned to EFFICIENT_ATTENTION (its device kernels by name and its own
    # max error against the plain version, so the reader sees whether it is
    # a like-for-like float32 call; the port never calls it).  Bounds: the
    # FLOP at the CUDA cores' float32 rate, and three split-TF32 passes of
    # them at the tensor cores' TF32 rate, the least time for float32-grade
    # products on this card (bound_ms); q, k, v, o once each either way.
    from torch.nn.attention import SDPBackend, sdpa_kernel

    tf32_row = None
    for label, (b, s_len, h, d) in (("stage", (8, 2048, 12, 64)),
                                    ("qwen2-moe-a2.7b", (8, 2048, 16, 128))):
        q, k, v = attn_inputs(b, s_len, s_len, h, h, d, f32)
        o_entry = torch.empty_like(q)
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v), reps=20)
        entry_ms = cuda_ms(lambda: _build.check(fa_lib.flash_attention_tf32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_entry.data_ptr(), b, s_len, s_len, h, h,
            d, 0, 1, 0, 0, d**-0.5, _build.stream_of(q)), "flash_attention (tf32)"), reps=20)
        want = fa.flash_attention_plain(q, k, v)
        entry_err = float((o_entry - want).abs().max())
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sdpa_err = float((sdpa(qt, kt, vt, is_causal=True).transpose(1, 2) - want).abs().max())
            lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), reps=20)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    sdpa(qt, kt, vt, is_causal=True)
                torch.cuda.synchronize()
        # The profiler has returned no kernel for this call in some runs.
        sdpa_kernels = sorted(ev.key for ev in prof.key_averages()
                              if ev.device_type == torch.autograd.DeviceType.CUDA
                              and ev.self_device_time_total > 0) or ["not recorded by the profiler"]
        flops = 4 * b * h * d * (s_len * (s_len + 1) // 2)
        nbytes = 4 * q.numel() * q.element_size()
        core_ms, _ = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
        split_ms, split_by = bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)
        at = {"at": f"{label} B={b} S={s_len} H={h} D={d} float32 causal", "ms": ms,
              "ms_entry": entry_ms, "max_abs_err_entry": entry_err, "plain_ms": plain_ms,
              "library_ms": lib_ms, "sdpa_backend": "EFFICIENT_ATTENTION",
              "sdpa_kernels": sdpa_kernels, "sdpa_max_abs_err": sdpa_err,
              "bound_ms": split_ms, "bound_by": split_by, "bound_cuda_core_ms": core_ms,
              "bound_split_tf32_ms": split_ms,
              "bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
        if tf32_row is None:
            tf32_row = {"name": "flash_attention_tf32", "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "replaces": "src/repro/kernels/flash_attention.py:75",
                        "launches": launches["flash_attention_tf32"],
                        "max_abs_err": errs["flash_attention_tf32"], **at, "shapes": []}
            rows.append(tf32_row)
        else:
            tf32_row["shapes"].append(at)
        print(f"time flash_attention_tf32 at {at['at']}: kernel {ms:.4f} ms through the wrapper "
              f"({flops / ms / 1e9:.1f} TFLOP/s), {entry_ms:.4f} ms from its C entry "
              f"({flops / entry_ms / 1e9:.1f} TFLOP/s; max err vs plain {entry_err:.3e}), plain "
              f"{plain_ms:.4f} ms, sdpa in float32 (EFFICIENT_ATTENTION: "
              f"{', '.join(sdpa_kernels)}) {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s; "
              f"its max err vs plain {sdpa_err:.3e}), bounds {split_ms:.6f} ms ({split_by}, three "
              f"split-TF32 passes), {core_ms:.6f} ms (CUDA-core float32) ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
        del q, k, v, o_entry, want, qt, kt, vt

    for row in slstm_rows:
        row["launches"] = launches[row["name"]]
        rows.append(row)
    if any(row["launches"] == 0 for row in rows):
        fail(f"a kernel of the path never launched: {[r['name'] for r in rows if not r['launches']]}")

    # The anneal at 1024 reads (128 thread blocks): how the kernel scales.
    op_big, mask_big, rd_big = operands(1024, k_solve)
    for name, fn in (
        ("cobi_trajectory", lambda: cd.cobi_trajectory_cuda(
            op_big.j_scaled, op_big.h_scaled, op_big.phi0, **full)),
        ("cobi_fused_best", lambda: cd.cobi_fused_best_cuda(
            op_big.j_scaled, op_big.h_scaled, op_big.j_orig, op_big.h_orig,
            mask_big, rd_big, op_big.phi0, **full)),
    ):
        ms = cuda_ms(fn, reps=10)
        b_ms, by = bound_ms(*work(name, op_big.r_pad, op_big.n_pad, mask_big.shape[1]))
        u_ms, u_by = bound_ms(*work(name, 1024, n_real, 1))
        print(f"time {name} at reads=1024: kernel {ms:.4f} ms, bound {b_ms:.6f} ms ({by}) at "
              f"N={op_big.n_pad}, {u_ms:.6f} ms ({u_by}) at N={n_real}")
    mop_big = mcmc_operands([inst], [k_solve], 1024, 1024)
    for name, kern in (("mcmc_sweep_batched", md.mcmc_sweep_batched),
                       ("mcmc_fused_best_batched", md.mcmc_fused_best_batched)):
        ms = cuda_ms(lambda: kern(*mop_big, **{**mkw, "replica_block": 256}), reps=10)
        entry_ms = cuda_ms(mcmc_entry(name, mop_big, MCMC_SWEEPS, 256), reps=20)
        b_ms, by = bound_ms(*mcmc_work(name, 1024, 128, 128, MCMC_SWEEPS))
        u_ms, u_by = bound_ms(*mcmc_work(name, 1024, inst.n, inst.n, MCMC_SWEEPS))
        print(f"time {name} at reads=1024: kernel {ms:.4f} ms through the wrapper, "
              f"{entry_ms:.4f} ms from its C entry, bound {b_ms:.6f} ms ({by}) at N=128, "
              f"{u_ms:.6f} ms ({u_by}) at N={inst.n}")

    # ------------------------------------------------------------ 6. result
    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s, the kernels' builds included")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
