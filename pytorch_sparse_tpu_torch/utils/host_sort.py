"""Host-side stable sorts over numpy arrays.

Counterpart of ``pytorch_sparse_tpu/utils/host_sort.py``.  Every helper
returns exactly what the numpy expression named in its docstring
returns: stable sorts have a unique result, so the order agrees with any
other stable sort of the same keys.  From ``_TORCH_MIN`` keys up,
integer keys take one ``torch.sort(stable=True)`` on the host
(:func:`~pytorch_sparse_tpu_torch.utils.index_sort.index_sort`), which
runs on all of torch's threads; smaller or other inputs take numpy.
Pairs sort as one combined int64 key where it fits, else as numpy's
two-key lexsort.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .index_sort import index_sort

# The JAX package's crossover between numpy and its native sorts, kept
# for torch's sort: on an H100 machine's 8-core host the two tie at
# 16,384 int64 keys and torch's wins 1.09x at 32,768 and 2.2x at 65,536
# (``tools/time_host_sorts.py``).
_TORCH_MIN = 32768


def _torch_keys(keys: np.ndarray) -> Optional[torch.Tensor]:
    """The 1-D integer keys as a host tensor that ``torch.sort`` takes
    (no copy for signed keys), or None where numpy serves them."""
    if keys.ndim != 1 or keys.shape[0] < _TORCH_MIN:
        return None
    if keys.dtype.kind == "u" and keys.dtype.itemsize < 8:
        keys = keys.astype(np.int64)
    elif keys.dtype.kind != "i":
        return None
    if not (keys.flags.writeable and keys.flags.c_contiguous):
        keys = np.ascontiguousarray(keys).copy()
    return torch.from_numpy(keys)


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")``."""
    t = _torch_keys(keys)
    if t is None:
        return np.argsort(keys, kind="stable")
    return index_sort(t)[1].numpy()


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


def _combined(primary: np.ndarray, secondary: np.ndarray,
              srange: int) -> np.ndarray:
    return primary.astype(np.int64) * srange + secondary.astype(np.int64)


def lexsort2(primary: np.ndarray, secondary: np.ndarray,
             secondary_range: Optional[int] = None) -> np.ndarray:
    """``np.lexsort((secondary, primary))``: stable order by ``primary``,
    ties by ``secondary``.  Non-negative integer keys sort as one int64
    key, which is faster than a two-pass lexsort and gives the same
    permutation.  ``secondary_range`` (an exclusive bound of
    ``secondary``, such as the column count) saves a max scan."""
    srange = _pair_range(primary, secondary, secondary_range)
    if srange is None:
        return np.lexsort((secondary, primary))
    return stable_argsort(_combined(primary, secondary, srange))


def lexsort2_decode(primary: np.ndarray, secondary: np.ndarray,
                    secondary_range: Optional[int] = None):
    """``lexsort2`` plus the sorted arrays:
    ``(perm, primary[perm], secondary[perm])``, in the inputs' dtypes.
    On torch's sort the sorted arrays are decoded from the sorted
    combined keys, in place of two gathers."""
    srange = _pair_range(primary, secondary, secondary_range)
    if srange is None or primary.shape[0] < _TORCH_MIN:
        perm = lexsort2(primary, secondary, secondary_range)
        return perm, primary[perm], secondary[perm]
    key_s, perm = index_sort(torch.from_numpy(
        _combined(primary, secondary, srange)))
    p_s = torch.div(key_s, srange, rounding_mode="floor")
    s_s = key_s - p_s * srange
    return (perm.numpy(), p_s.numpy().astype(primary.dtype, copy=False),
            s_s.numpy().astype(secondary.dtype, copy=False))
