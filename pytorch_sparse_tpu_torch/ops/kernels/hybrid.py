"""Hybrid block-dense + CSR SpMM, and the whole-matrix dense route.

PyTorch counterpart of ``pytorch_sparse_tpu/ops/kernels/hybrid.py``.  On
community graphs laid out community-contiguously, most edges fall into
a few (B, B) blocks that are dense enough to store densely; their SpMM
becomes block products (``block_spmm``) and the remaining edges run
through the CSR kernel (``csr_spmm``).  When the whole matrix clears the
densify threshold, :class:`DenseFormat` stores it as one dense matrix
and the SpMM is one matrix product.

Format (built host-side, then uploaded):

* ``blocks``   (nb+1, B, B) dense block values in (row-block, col-block)
  order; slot ``nb`` is an all-zero block, kept as in the JAX format.
* ``slot_row`` / ``slot_col`` (nb,) int32 block coordinates of each
  slot, sorted by row-block; ``rb_ptr`` (R+1,) int32 points into them
  per row-block.
* ``rest`` — the edges outside dense blocks as a CSR
  ``(rowptr, col, value)`` in CSR edge order, or None.

Forward (:func:`hybrid_spmm`)::

    out = block_spmm(blocks, slot_col, rb_ptr, pad(x))[:M]
    out = out + csr_spmm(rest, x)          # remainder added after

The block and dense stores bake the build-time values; the storage
layer drops the view on ``set_value``.

The densify break-even (:func:`block_break_even`) and the router that
uses it keep the JAX package's rule and constants, which were priced
for a TPU v5e; they are unchanged here so that both packages route a
graph alike, and have not been re-priced for this port's GPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...typing import DeviceLike, resolve_device
from ...utils.host_sort import stable_argsort
from .block_spmm import block_spmm
from .csr_spmm import csr_spmm

# ----------------------------------------------------------------------
# Precision of the bf16-store dense route.  "high" splits an f32
# operand into two bf16 terms, "highest" into three, "default" casts it
# to bf16 once, as the JAX package's Precision.HIGH/HIGHEST/DEFAULT do
# in ``_dense_matmul``.  The block kernel and the f32 routes compute in
# full fp32 at every setting.
# ----------------------------------------------------------------------

_PRECISION_PARTS = {"default": 1, "high": 2, "highest": 3}
_BLOCK_PRECISION = "high"


def set_block_precision(precision: str) -> None:
    """Set the split of the bf16-store dense route: ``"default"``,
    ``"high"`` (the library default) or ``"highest"``."""
    global _BLOCK_PRECISION
    if precision not in _PRECISION_PARTS:
        raise ValueError(f"precision must be one of {list(_PRECISION_PARTS)}")
    _BLOCK_PRECISION = precision


def get_block_precision() -> str:
    return _BLOCK_PRECISION


# ----------------------------------------------------------------------
# Store dtype rule: bf16 when the values' measured quantization error
# fits the declared budget (default 0.0: lossless only).
# ----------------------------------------------------------------------

_STORE_BUDGET = 0.0


def set_store_budget(rel_err: float) -> None:
    """Declare the acceptable relative output error from storing dense
    blocks in bf16.  Default 0.0: bf16 only when values round-trip
    exactly (e.g. implicit ones)."""
    global _STORE_BUDGET
    _STORE_BUDGET = float(rel_err)


def get_store_budget() -> float:
    return _STORE_BUDGET


def quantization_rel_err(values: Optional[np.ndarray]) -> float:
    """RMS relative error of storing ``values`` in bf16.  ``None``
    (implicit ones) is exact.  Rounds with ``torch.bfloat16``
    (round-to-nearest-even)."""
    if values is None:
        return 0.0
    v = np.asarray(values)
    if v.dtype.kind != "f" or v.size == 0:
        return 0.0
    t = torch.from_numpy(np.ascontiguousarray(v))
    d = (t.float() - t.to(torch.bfloat16).float()).numpy()
    denom = float(np.sqrt(np.mean(np.square(v, dtype=np.float64))))
    if denom == 0.0:
        return 0.0
    return float(np.sqrt(np.mean(np.square(d, dtype=np.float64)))) / denom


# The JAX package's break-even constants, measured on a TPU v5e
# (pytorch_sparse_tpu/ops/kernels/hybrid.py:174-177).  They decide the
# route only; no time in this package is derived from them.
_HBM_BW = 819e9
_MXU_BF16 = 197e12
_ELL_NS_PER_NNZ = 2.9


def block_break_even(B: int, K_hint: int = 128, elem: int = 4,
                     passes: float = 3.0) -> float:
    """Minimum block density at which the JAX package's cost model
    prefers a dense block to per-edge gathers."""
    t_block = (
        passes * (B * B * elem + 3 * B * K_hint * 4) / _HBM_BW
        + 2.0 * B * B * K_hint / _MXU_BF16
    )
    ell_ns = _ELL_NS_PER_NNZ * (0.7 + 0.3 * K_hint / 128.0)
    edges = t_block / (ell_ns * 1e-9)
    return min(edges / (B * B), 1.0)


class HybridFormat:
    def __init__(self, blocks, slot_row, slot_col, rb_ptr,
                 rest: Optional[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]],
                 M: int, N: int, B: int, dense_nnz: int):
        self.blocks = blocks
        self.slot_row = slot_row
        self.slot_col = slot_col
        self.rb_ptr = rb_ptr
        self.rest = rest
        self.M, self.N, self.B = M, N, B
        self.dense_nnz = dense_nnz

    @property
    def nb(self) -> int:
        return int(self.slot_col.shape[0])

    def __repr__(self) -> str:
        return (f"HybridFormat(M={self.M}, N={self.N}, B={self.B}, "
                f"blocks={self.nb}, dense_nnz={self.dense_nnz}, "
                f"dtype={self.blocks.dtype})")


class DenseFormat:
    """Whole-matrix dense store: the degenerate hybrid for matrices whose
    overall density clears the densify break-even."""

    def __init__(self, dense, M: int, N: int):
        self.dense = dense
        self.M, self.N = M, N

    def __repr__(self) -> str:
        return f"DenseFormat(M={self.M}, N={self.N}, dtype={self.dense.dtype})"


# Host-to-device upload granule: the store is cast to its dtype on the
# device, one chunk at a time, so no full-size f32 copy lands there.
_UPLOAD_CHUNK_BYTES = 256 << 20


def _upload(arr: np.ndarray, device: torch.device,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    src = torch.from_numpy(arr)
    dtype = src.dtype if dtype is None else dtype
    if device.type == "cpu":
        return src.to(dtype)
    out = torch.empty(tuple(arr.shape), dtype=dtype, device=device)
    if arr.size == 0:
        return out
    step = max(1, _UPLOAD_CHUNK_BYTES // max(arr[:1].nbytes, 1))
    for s in range(0, arr.shape[0], step):
        out[s:s + step].copy_(src[s:s + step].to(device))
    return out


def _sum_duplicates(flat: np.ndarray, vals: np.ndarray, size: int,
                    dt) -> np.ndarray:
    """Dense buffer of ``size`` with ``vals`` summed at ``flat``
    (sort + reduceat; duplicates accumulate)."""
    buf = np.zeros(size, dt)
    if flat.size:
        order = np.argsort(flat, kind="stable")
        fs, vs = flat[order], vals[order]
        starts = np.concatenate([[0], np.flatnonzero(np.diff(fs)) + 1])
        buf[fs[starts]] = np.add.reduceat(vs, starts)
    return buf


def build_dense(row: np.ndarray, col: np.ndarray,
                value: Optional[np.ndarray], M: int, N: int,
                dtype: Optional[torch.dtype] = None,
                device: DeviceLike = None) -> DenseFormat:
    """The full (M, N) matrix (duplicate edges accumulate), stored in
    ``dtype`` (default float32) on ``device``."""
    dev = resolve_device(device)
    acc_dt = (np.float64 if value is not None
              and np.asarray(value).dtype == np.float64 else np.float32)
    v = np.ones(row.shape[0], acc_dt) if value is None else (
        np.asarray(value).astype(acc_dt))
    flat = np.asarray(row, np.int64) * N + np.asarray(col, np.int64)
    dense = _sum_duplicates(flat, v, M * N, acc_dt).reshape(M, N)
    store = torch.float32 if dtype is None else dtype
    if acc_dt == np.float64 and dtype is None:
        store = torch.float64
    return DenseFormat(_upload(dense, dev, store), M, N)


def dense_fraction(row: np.ndarray, col: np.ndarray, M: int, N: int,
                   B: int = 512, min_density: Optional[float] = None,
                   K_hint: int = 128) -> Tuple[float, int]:
    """Fraction of edges in (B, B) blocks of at least ``min_density``,
    and the number of such blocks."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    if row.size == 0:
        return 0.0, 0
    if min_density is None:
        min_density = block_break_even(B, K_hint)
    C = -(-N // B)
    bkey = (row // B) * C + col // B
    _, counts = np.unique(bkey, return_counts=True)
    thresh = max(int(min_density * B * B), 1)
    dense = counts[counts >= thresh]
    return float(dense.sum()) / row.size, int(dense.size)


def build_hybrid(
    row: np.ndarray, col: np.ndarray, value: Optional[np.ndarray],
    M: int, N: int, B: int = 512, min_density: Optional[float] = None,
    K_hint: int = 128, block_dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
) -> HybridFormat:
    """Split edges into dense (B, B) blocks and a CSR remainder
    (host-side), then upload.  ``block_dtype`` (default float32) is the
    store dtype; bf16 is cast on the device."""
    dev = resolve_device(device)
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    E = row.shape[0]
    if value is None:
        val = np.ones(E, np.float32)
    else:
        val = np.asarray(value)
        if val.dtype.kind != "f":
            val = val.astype(np.float32)
    if min_density is None:
        min_density = block_break_even(B, K_hint)

    R = -(-M // B)
    C = -(-N // B)
    bkey = (row // B) * C + col // B
    if E:
        occ_keys, inv_key, occ_counts = np.unique(
            bkey, return_inverse=True, return_counts=True)
    else:
        occ_keys = inv_key = occ_counts = np.zeros(0, np.int64)
    thresh = max(int(min_density * B * B), 1)
    occ_is_dense = occ_counts >= thresh
    dense_sel = occ_is_dense[inv_key] if E else np.zeros(0, bool)

    dsel = np.flatnonzero(dense_sel)
    dense_keys = occ_keys[occ_is_dense]  # sorted: row-block major
    nb = dense_keys.size
    occ_slot = np.full(occ_keys.size, nb, np.int64)
    occ_slot[occ_is_dense] = np.arange(nb)
    blk_dt = np.float64 if val.dtype == np.float64 else np.float32
    # Flat offsets (slot*B + r)*B + c reach past int32 at real sizes.
    flat = (occ_slot[inv_key[dsel]] * B + row[dsel] % B) * B + col[dsel] % B
    blocks = _sum_duplicates(flat, val[dsel].astype(blk_dt),
                             (nb + 1) * B * B, blk_dt).reshape(nb + 1, B, B)
    slot_row = dense_keys // C
    slot_col = dense_keys % C
    rb_ptr = np.searchsorted(slot_row, np.arange(R + 1))

    rest = None
    rest_ids = np.flatnonzero(~dense_sel)
    if rest_ids.size:
        rr = rest_ids[stable_argsort(row[rest_ids])]
        rptr = np.searchsorted(row[rr], np.arange(M + 1))
        rest = (
            torch.from_numpy(rptr.astype(np.int32)).to(dev),
            torch.from_numpy(col[rr].astype(np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(val[rr])).to(dev),
        )

    def _idx(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    store = block_dtype
    if store is None:
        store = torch.float64 if blk_dt == np.float64 else torch.float32
    return HybridFormat(
        _upload(blocks, dev, store), _idx(slot_row), _idx(slot_col),
        _idx(rb_ptr), rest, M, N, B, int(dsel.size),
    )


def hybrid_spmm(h, x: torch.Tensor) -> torch.Tensor:
    """``out = A @ x`` through a :class:`HybridFormat` or
    :class:`DenseFormat`; (N, K) -> (M, K) in ``x``'s dtype.  Half
    precision operands compute in float32."""
    if isinstance(h, DenseFormat):
        return dense_spmm(h, x)
    B, M, N = h.B, h.M, h.N
    K = x.shape[1]
    C = -(-N // B)
    xa = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous()
    xb = xa
    if C * B != N:
        xb = torch.cat([xa, xa.new_zeros((C * B - N, K))])
    out = block_spmm(h.blocks, h.slot_col, h.rb_ptr, xb)[:M].to(x.dtype)
    if h.rest is not None:
        rowptr, col, val = h.rest
        out = out + csr_spmm(rowptr, col, val.to(xa.dtype), xa).to(x.dtype)
    return out


def _split_bf16(x: torch.Tensor, parts: int):
    """``parts`` bf16 terms summing to about ``x``: the head, then
    successive residuals."""
    comps = []
    r = x
    for _ in range(parts - 1):
        c = r.to(torch.bfloat16)
        comps.append(c)
        r = r - c.float()
    comps.append(r.to(torch.bfloat16))
    return comps


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices, accumulated and returned in
    float32 (on the CPU, which lacks that product, in exact f32
    arithmetic on the widened operands)."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _dense_matmul(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` with the store-dtype rules of the JAX package: a bf16
    store times an f32 operand splits the operand into bf16 terms that
    ride one widened product (the store is read once); other mixes cast
    the operand to the store dtype.  f32 products run with TF32 off
    (PyTorch's default)."""
    if a.dtype == torch.bfloat16:
        if x.dtype == torch.float32:
            parts = _PRECISION_PARTS[_BLOCK_PRECISION]
            k = x.shape[1]
            o = _mm_f32(a, torch.cat(_split_bf16(x, parts), dim=1))
            out = o[:, :k]
            for i in range(1, parts):
                out = out + o[:, i * k:(i + 1) * k]
            return out
        return _mm_f32(a, x.to(torch.bfloat16))
    return torch.mm(a, x.to(a.dtype))


def dense_spmm(d: DenseFormat, x: torch.Tensor) -> torch.Tensor:
    return _dense_matmul(d.dense, x).to(x.dtype)
