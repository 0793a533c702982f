"""Host-side stable sorts over numpy arrays.

Counterpart of ``pytorch_sparse_tpu/utils/host_sort.py`` with numpy
stable sorts only.  Every helper returns exactly what the numpy
reference expression named in its docstring returns: stable sorts have
a unique result, so the order agrees with any other stable sort of the
same keys.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")``."""
    return np.argsort(keys, kind="stable")


def _pair_range(primary: np.ndarray, secondary: np.ndarray,
                secondary_range: Optional[int]) -> Optional[int]:
    """Exclusive bound of ``secondary`` when the combined key
    ``primary * range + secondary`` fits int64 with no negatives, else
    None."""
    if primary.dtype.kind not in "iu" or secondary.dtype.kind not in "iu":
        return None
    if primary.size == 0:
        return None
    srange = (int(secondary.max()) + 1 if secondary_range is None
              else int(secondary_range))
    if int(secondary.min()) < 0 or int(primary.min()) < 0 or srange <= 0:
        return None
    if int(primary.max()) > ((1 << 63) - srange) // srange:
        return None
    return srange


def lexsort2(primary: np.ndarray, secondary: np.ndarray,
             secondary_range: Optional[int] = None) -> np.ndarray:
    """``np.lexsort((secondary, primary))``: stable order by ``primary``,
    ties by ``secondary``.  Non-negative integer keys sort as one int64
    key, which is faster than a two-pass lexsort and gives the same
    permutation."""
    srange = _pair_range(primary, secondary, secondary_range)
    if srange is None:
        return np.lexsort((secondary, primary))
    key = primary.astype(np.int64) * srange + secondary.astype(np.int64)
    return np.argsort(key, kind="stable")


def lexsort2_decode(primary: np.ndarray, secondary: np.ndarray,
                    secondary_range: Optional[int] = None):
    """``lexsort2`` plus the sorted arrays:
    ``(perm, primary[perm], secondary[perm])``."""
    perm = lexsort2(primary, secondary, secondary_range)
    return perm, primary[perm], secondary[perm]
