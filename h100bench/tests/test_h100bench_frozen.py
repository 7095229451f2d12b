"""The benchmark's frozen arithmetic held to worked values of PERF.md's
kernel table (NVIDIA H100 80GB HBM3 rows; bounds in ms)."""

from __future__ import annotations

import pytest

from h100bench import frozen

# The farm benchmark's document mix (chip_smoke.py FARM_SIZES), 6 iterations
# a document: the 96 jobs of the 20-bin drain, each at its own spins.
FARM_SIZES = [10, 14, 18, 22, 26, 30, 34, 38, 12, 16, 20, 24, 28, 32, 36, 40]
DRAIN_JOBS = [(8, n, 1) for n in FARM_SIZES for _ in range(6)]


@pytest.mark.parametrize("name, shapes, bound, by", [
    # Row 1: the energy kernel at R 8 on the direct document's 20 int8 spins.
    ("ising_energy", [(8, 20, 0)], 5.59e-7, "bytes"),
    # Row 3: the trajectory at R 8 on the direct document's 20 spins.
    ("cobi_trajectory", [(8, 20, 0)], 7.64e-5, "operations"),
    # Rows 4 and 6: the batched trajectory and fused best-of at the drain.
    ("cobi_trajectory_batched", DRAIN_JOBS, 0.0130, "operations"),
    ("cobi_fused_best_batched", DRAIN_JOBS, 0.0130, "operations"),
])
def test_kernel_bounds_match_the_kernel_table(name, shapes, bound, by):
    spin_bytes = 1 if name == "ising_energy" else 4
    if len(shapes) == 1:
        flops, nbytes = frozen.work(name, *shapes[0], spin_bytes=spin_bytes)
    else:
        flops, nbytes = frozen.batched_work(name, shapes)
    ms, got_by = frozen.bound_ms(flops, nbytes)
    assert got_by == by
    assert ms == pytest.approx(bound, rel=5e-3)


def test_flash_count_matches_row_10a():
    """Row 10a: the encoder stage's 2,048 bucket, (8, 2048, 12 x 64) bf16."""
    flops = frozen.flash_flops(8, 12, 64, 2048)
    ms, by = frozen.bound_ms(flops, 0.0, peak=frozen.PEAK_BF16_FLOPS)
    assert by == "operations" and ms == pytest.approx(0.0521, rel=5e-3)


def test_peaks_are_the_data_sheets():
    assert (frozen.PEAK_BF16_FLOPS, frozen.PEAK_TF32_FLOPS, frozen.PEAK_F32_FLOPS,
            frozen.PEAK_BYTES_PER_S) == (989.4e12, 494.7e12, 67e12, 3.35e12)


def test_encoder_flops_of_bert_base_widths():
    """12 layers of d 768, FFN 3,072: 18,874,368 FLOP a token a layer in the
    projections (2 (4 d^2 + 3 d f)), plus 4 d a causal pair of attention."""
    sizes = {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12}
    t = 2048
    want = 12 * (t * 18_874_368 + 4 * 768 * t * (t + 1) / 2)
    assert frozen.encoder_flops(sizes, t) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(541.2e9, rel=1e-3)
    # The attention part is the flash count of one row of all 12 heads.
    assert 12 * frozen.flash_flops(1, 12, 64, t) == pytest.approx(12 * 4 * 768 * t * (t + 1) / 2)
