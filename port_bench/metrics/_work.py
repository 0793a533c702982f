"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of the work, counted from the sparse matrix and the widths, never
from a route or a kernel, so that the same work reads the same whatever
implements it.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit (the
run records the card's ``power.limit`` beside them).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

PEAK_FP32_FLOPS = 67e12      # FP32 outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12
INDEX_BYTES = 4              # the port keeps rowptr, col and row as int32
VALUE_BYTES = 4              # float32


def spmm_flops(nnz: int, K: int) -> float:
    """One multiply and one add an edge and column."""
    return 2.0 * nnz * K


def spmm_bytes(nnz: int, M: int, N: int, K: int, valued: bool) -> float:
    """What one ``(M, N) @ (N, K)`` product needs to move: each edge's
    column index (and value, where the matrix has values), the row
    pointer, the operand read once and the output written once.  A
    backward ``A^T @ g`` moves the same with M and N swapped."""
    per_edge = INDEX_BYTES + (VALUE_BYTES if valued else 0)
    return (nnz * per_edge + (M + 1) * INDEX_BYTES
            + N * K * VALUE_BYTES + M * K * VALUE_BYTES)


def spmm_min_seconds(nnz: int, M: int, N: int, K: int,
                     valued: bool) -> Tuple[float, str]:
    """The least time the card could take for one product, and what
    bounds it (``"flops"`` or ``"bytes"``)."""
    t_f = spmm_flops(nnz, K) / PEAK_FP32_FLOPS
    t_b = spmm_bytes(nnz, M, N, K, valued) / PEAK_HBM_BYTES_PER_S
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")


def mm_flops(M: int, K: int, N: int) -> float:
    """A dense ``(M, K) @ (K, N)``."""
    return 2.0 * M * K * N


def dense_layer_flops(M: int, fan_in: int, fan_out: int,
                      input_grad: bool) -> Tuple[float, float]:
    """Forward and backward operations of ``x @ W`` over M rows: the
    backward is the weight's gradient, plus the input's where it needs
    one."""
    f = mm_flops(M, fan_in, fan_out)
    return f, f * (2.0 if input_grad else 1.0)


def share_pct(bound_s: Iterable[float], measured_s: Iterable[float]
              ) -> Optional[float]:
    """``100 * sum(bounds) / sum(measured)``, or None where nothing was
    measured."""
    b, m = sum(bound_s), sum(measured_s)
    if m <= 0.0:
        return None
    return 100.0 * b / m
