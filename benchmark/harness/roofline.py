"""The yardstick for kernel roofline shares, frozen here so that it does
not move with the kernels it measures.

Copied from chip_smoke.py:380-470 (`PEAK_BYTES_S`, `PEAK_INT32_OPS_S`,
`OPS_WORD`, `OPS_COL`, `OPS_CELL`, `OPS_LEVEL`, `bound`, `scan_ops`),
where the smoke recounts the operation constants in each build's
machine code (H100, CUDA 12.8). No metric reads these yet: a K1/K2/K3/K4
roofline needs each batch's pair and cell counts, which the program does
not yet return per batch under a stream."""
from __future__ import annotations

# H100 SXM data sheet: 3.35 TB/s of HBM; the int32 ALU issues 64
# lane-operations a clock per SM, a quarter of the 67 TFLOP/s fp32 rate
# (which counts a fused multiply-add as two)
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 67e12 / 4
# int32 operations of the Myers recurrence: per word and column, and per
# (query, column) step; of the rescore: per DP cell and per look-back
# doubling
OPS_WORD, OPS_COL = 10.59, 2
OPS_CELL, OPS_LEVEL = 22, 3


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the int32 peak."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = ops / PEAK_INT32_OPS_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def scan_ops(pairs: float, cols: float, W: int) -> float:
    """int32 operations of a Myers scan of `pairs` pairs over `cols`
    columns at W words."""
    return pairs * cols * (OPS_WORD * W + OPS_COL)
