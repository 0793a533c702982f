"""``ctypes`` wrapper over the port's host library ``csrc/host_spgemm.cpp``
(the Gustavson SpGEMM): the counterpart of ``spgemm`` in
``pytorch_sparse_tpu/csrc/bindings.py`` (``:472-511``), with the same
arguments, dtype rules and outputs.  The library is built with the host
C++ compiler at first use (``_build.load``); without a compiler it
raises."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .. import _build

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64 = ctypes.c_int64
_SIGNATURES = {
    # rowptrA, colA, rowptrB, colB, P, row_lo, row_hi, rowptrC
    "spgemm_nnz": ([_i64p, _i64p, _i64p, _i64p, _i64, _i64, _i64, _i64p],
                   _i64),
    # rowptrA, colA, valA, rowptrB, colB, valB, P, row_lo, row_hi,
    # rowptrC, colC, valC
    "spgemm_fill": ([_i64p, _i64p, _f64p, _i64p, _i64p, _f64p, _i64, _i64,
                     _i64, _i64p, _i64p, _f64p], None),
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("host_spgemm")
    for fn_name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _p(a: Optional[np.ndarray], ptype=_i64p):
    return None if a is None else a.ctypes.data_as(ptype)


def _i64_array(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def spgemm(
    rowptrA: np.ndarray, colA: np.ndarray, valA: Optional[np.ndarray],
    rowptrB: np.ndarray, colB: np.ndarray, valB: Optional[np.ndarray],
    P: int, row_lo: int = 0, row_hi: Optional[int] = None,
    count_only: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Gustavson SpGEMM over A's rows ``[row_lo, row_hi)``.

    Returns host ``(rowptrC, colC, valC)``: ``rowptrC`` local to the
    range (``row_hi - row_lo + 1`` entries, from 0), ``colC`` ascending
    in each row, ``valC`` float64, each entry summed in float64 over A's
    row and then B's rows in order (None when both values are None).
    ``count_only=True`` runs the count pass alone: ``colC`` and ``valC``
    are None.  ``colB`` must lie in ``[0, P)``."""
    rowptrA, colA = _i64_array(rowptrA), _i64_array(colA)
    rowptrB, colB = _i64_array(rowptrB), _i64_array(colB)
    M, K = rowptrA.shape[0] - 1, rowptrB.shape[0] - 1
    if row_hi is None:
        row_hi = M
    row_lo, row_hi, P = int(row_lo), int(row_hi), int(P)
    if not 0 <= row_lo <= row_hi <= M or K < 0 or P < 0:
        raise ValueError(f"rows [{row_lo}, {row_hi}) of {M}, or P = {P}, "
                         "out of range")
    if (rowptrA[-1] != colA.shape[0] or rowptrB[-1] != colB.shape[0]):
        raise ValueError("a row pointer does not end at its column count")
    seen = colA[rowptrA[row_lo]:rowptrA[row_hi]]
    if seen.size and (seen.min() < 0 or seen.max() >= K):
        raise ValueError("`colA` holds a column outside B's rows")
    va = None if valA is None else np.ascontiguousarray(valA, np.float64)
    vb = None if valB is None else np.ascontiguousarray(valB, np.float64)
    if ((va is not None and va.shape != colA.shape)
            or (vb is not None and vb.shape != colB.shape)):
        raise ValueError("a value array needs one value per column index")
    lib = _lib()
    rowptrC = np.empty(row_hi - row_lo + 1, np.int64)
    nnz = lib.spgemm_nnz(_p(rowptrA), _p(colA), _p(rowptrB), _p(colB), P,
                         row_lo, row_hi, _p(rowptrC))
    if count_only:
        return rowptrC, None, None
    colC = np.empty(nnz, np.int64)
    valC = (np.empty(nnz, np.float64)
            if va is not None or vb is not None else None)
    lib.spgemm_fill(_p(rowptrA), _p(colA), _p(va, _f64p), _p(rowptrB),
                    _p(colB), _p(vb, _f64p), P, row_lo, row_hi, _p(rowptrC),
                    _p(colC), _p(valC, _f64p))
    return rowptrC, colC, valC
