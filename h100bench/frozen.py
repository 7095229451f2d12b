"""The benchmark's frozen arithmetic: the card's peaks, the operations and
bytes each kernel needs, and the encoder's model FLOPs.

Copies, held here so that a change to the program cannot move the
yardstick: ``chip_smoke.py``'s ``work()``, ``batched_work()`` and
``bound_ms()`` (the COBI anneal and energy counts: each input read once,
each output written once, sin/cos and the elementwise update not counted),
the flash count (4 B H D FLOP a causal pair) and the H100 SXM peaks of
``src/repro_torch/core/hardware.py`` (NVIDIA's data sheet, dense, at
700 W).  ``h100bench/tests/test_h100bench_frozen.py`` holds each to a
worked value of ``PERF.md``'s kernel table.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989.4e12  # tensor cores, bf16 in, float32 accumulate
PEAK_TF32_FLOPS = 494.7e12
PEAK_F32_FLOPS = 67e12  # float32 FMA outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3
ANNEAL_STEPS = 400  # SolveConfig.steps, the COBI anneal's steps a read

# Device kernels by name in a profiler trace (demangled names contain these).
COBI_KERNELS = ("trajectory_kernel", "readout_kernel", "fused_best_blocks_kernel",
                "fused_best_reduce_kernel")
FLASH_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_tf32_kernel")


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of FLOP over the peak
    rate and bytes over HBM bandwidth, in ms, and which of the two binds."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def work(name: str, r: int, n: int, s: int, spin_bytes: int = 4,
         steps: int = ANNEAL_STEPS) -> tuple[float, float]:
    """(FLOP, bytes) of one call of kernel ``name`` on r reads, n lanes and
    s slots at ``steps`` steps.  The anneal counts the stacked [cos; sin] @ J
    product; the energy kernel's spins count at ``spin_bytes`` a spin.  A
    batched kernel's work is the sum of its instances' (:func:`batched_work`)."""
    f32 = 4
    anneal = steps * 2 * (2 * r) * n * n
    score = 2 * r * n * n + 4 * r * n
    return {
        "cobi_trajectory": (anneal, f32 * (n * n + n + 2 * r * n)),
        "ising_energy": (score, spin_bytes * r * n + f32 * (n + n * n + r)),
        "cobi_fused_best": (anneal + score + 2 * r * n * s,
                            f32 * (2 * n * n + 2 * n + n * s + s + r * n + s + s * n)),
        "cobi_readout": (anneal + score, f32 * (2 * n * n + 2 * n + 2 * r * n + r)),
    }[name.removesuffix("_batched")]


def batched_work(name: str, shapes, steps: int = ANNEAL_STEPS) -> tuple[float, float]:
    """(FLOP, bytes) of one batched call over instances of (r, n, s) shapes."""
    flops, nbytes = zip(*(work(name, r, n, s, steps=steps) for r, n, s in shapes))
    return sum(flops), sum(nbytes)


def flash_flops(batch: int, heads: int, head_dim: int, seq: int) -> float:
    """FLOP of one causal flash pass: 4 B H D for each of the S (S + 1) / 2
    query-key pairs (QK^T and PV, two FLOP a multiply-add)."""
    return 4.0 * batch * heads * head_dim * seq * (seq + 1) / 2


def encoder_flops(sizes: dict, tokens: int) -> float:
    """Model FLOP of one causal pass of the dense encoder over ``tokens``
    packed tokens: every layer's projections (q, k, v, o: 4 d^2; the gated
    MLP: 3 d f; two FLOP a multiply-add) for each token, plus its causal
    attention (4 d a pair).  The embedding lookup and the pooling count
    nothing; the unembedding is not run."""
    d, f, layers = sizes["hidden_size"], sizes["intermediate_size"], sizes["num_hidden_layers"]
    dense = 2.0 * tokens * (4 * d * d + 3 * d * f)
    attention = 4.0 * d * tokens * (tokens + 1) / 2
    return layers * (dense + attention)
