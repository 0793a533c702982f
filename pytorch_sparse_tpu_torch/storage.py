"""Core sparse storage: sorted COO/CSR/CSC with observable format caches.

PyTorch counterpart of ``pytorch_sparse_tpu/storage.py``.  Same
information model: mandatory ``col``, one of ``row``/``rowptr``, optional
``value``, and five derived caches (``rowcount``, ``colptr``,
``colcount``, ``csr2csc``, ``csc2csr``) filled lazily and reported by
:meth:`SparseStorage.cached_keys`.

Index work (sortedness probe, bounds checks, the canonical (row, col)
sort, coalescing, the hybrid router's statistics) runs on host numpy
copies kept in ``_np_cache``; the index tensors themselves live on the
storage's device as int32.  Values stay a tensor on the device.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from .segment import Runs, segment_max, segment_min
from .typing import DeviceLike, resolve_device
from .utils.convert import INDEX_DTYPE
from .utils.host_sort import lexsort2, lexsort2_decode

layouts = ["coo", "csr", "csc"]

_CACHE_KEYS = ("rowcount", "colptr", "colcount", "csr2csc", "csc2csr")


def get_layout(layout: Optional[str] = None) -> str:
    """Default layout is COO, with a warning when unspecified."""
    if layout is None:
        layout = "coo"
        warnings.warn(
            "`layout` argument unset, using default layout `coo`. "
            "This may lead to unexpected behavior."
        )
    if layout not in layouts:
        raise ValueError(f"unknown layout {layout!r}")
    return layout


def _host_int64(x) -> Optional[np.ndarray]:
    """A fresh host int64 copy of an index array (numpy, list or tensor)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if arr.size and arr.dtype.kind not in "iu":
        raise TypeError(f"index arrays must be integral, got {arr.dtype}")
    if arr.ndim != 1:
        raise ValueError("index arrays must be 1-D")
    return arr.astype(np.int64)


def _dev_index(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.int32)).to(device)


def _as_value(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.ascontiguousarray(value)).to(device)


def _cache_arg(x, n: int, name: str, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    x = x.to(device=device, dtype=INDEX_DTYPE)
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"`{name}` must have shape ({n},)")
    return x


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor; bf16 (which numpy lacks) widens to f32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class SparseStorage:
    """Single source of truth for a sparse matrix layout."""

    # Router constants, kept equal to the JAX package's
    # (``pytorch_sparse_tpu/storage.py:799-809``) so that both packages
    # route a graph alike.  They were priced for a TPU v5e (16 GB HBM);
    # they have not been re-priced for this port's GPU.
    _HYBRID_B = 512
    _HYBRID_MIN_EDGES = 200_000
    _HYBRID_MIN_FRACTION = 0.30
    _HYBRID_MAX_BLOCK_BYTES = 8 << 30
    _DENSE_MAX_BYTES = int(2.5e9)

    def __init__(
        self,
        row=None,
        rowptr=None,
        col=None,
        value=None,
        sparse_sizes: Optional[Tuple[Optional[int], Optional[int]]] = None,
        rowcount=None,
        colptr=None,
        colcount=None,
        csr2csc=None,
        csc2csr=None,
        is_sorted: bool = False,
        trust_data: bool = False,
        device: DeviceLike = None,
    ):
        if col is None or (row is None and rowptr is None):
            raise ValueError("`col` and one of `row`/`rowptr` are required")
        dev = resolve_device(device)
        host_row = _host_int64(row)
        host_col = _host_int64(col)
        host_rowptr = _host_int64(rowptr)
        E = host_col.shape[0]
        if host_row is not None and host_row.shape[0] != E:
            raise ValueError("`row` and `col` differ in length")

        M: Optional[int] = None
        N: Optional[int] = None
        if sparse_sizes is not None:
            M, N = sparse_sizes[0], sparse_sizes[1]
        if M is None:
            if host_rowptr is not None:
                M = host_rowptr.shape[0] - 1
            else:
                M = int(host_row.max()) + 1 if E else 0
        if N is None:
            N = int(host_col.max()) + 1 if E else 0
        M, N = int(M), int(N)

        if not trust_data and E:
            if host_col.min() < 0 or host_col.max() >= N:
                raise ValueError("`col` contains indices outside [0, N)")
            if host_row is not None and (
                    host_row.min() < 0 or host_row.max() >= M):
                raise ValueError("`row` contains indices outside [0, M)")
        if host_rowptr is not None and not trust_data:
            if (host_rowptr.shape[0] != M + 1 or host_rowptr[0] != 0
                    or host_rowptr[-1] != E
                    or np.any(np.diff(host_rowptr) < 0)):
                raise ValueError("`rowptr` is not a valid CSR pointer")

        if value is not None and len(value) != E:
            raise ValueError("`value` and `col` differ in length")

        rowcount = _cache_arg(rowcount, M, "rowcount", dev)
        colptr = _cache_arg(colptr, N + 1, "colptr", dev)
        colcount = _cache_arg(colcount, N, "colcount", dev)
        csr2csc = _cache_arg(csr2csc, E, "csr2csc", dev)
        csc2csr = _cache_arg(csc2csr, E, "csc2csr", dev)

        # Sortedness probe + canonical (row, col) sort on the host.
        if not is_sorted and host_rowptr is None and E > 1:
            keys_sorted = bool(np.all(
                (host_row[1:] > host_row[:-1])
                | ((host_row[1:] == host_row[:-1])
                   & (host_col[1:] >= host_col[:-1]))
            ))
            if not keys_sorted:
                perm, host_row, host_col = lexsort2_decode(host_row,
                                                           host_col)
                if value is not None:
                    if isinstance(value, torch.Tensor):
                        value = value[torch.from_numpy(perm).to(
                            value.device)]
                    else:
                        value = np.asarray(value)[perm]
                csr2csc = csc2csr = None

        np_cache = {"col": host_col}
        if host_row is not None:
            np_cache["row"] = host_row
        if host_rowptr is not None:
            np_cache["rowptr"] = host_rowptr
        self._init(
            row=None if host_row is None else _dev_index(host_row, dev),
            rowptr=(None if host_rowptr is None
                    else _dev_index(host_rowptr, dev)),
            col=_dev_index(host_col, dev),
            value=None if value is None else _as_value(value, dev),
            sparse_sizes=(M, N), rowcount=rowcount, colptr=colptr,
            colcount=colcount, csr2csc=csr2csc, csc2csr=csc2csr,
            np_cache=np_cache,
        )

    def _init(self, row, rowptr, col, value, sparse_sizes, rowcount=None,
              colptr=None, colcount=None, csr2csc=None, csc2csr=None,
              np_cache=None, csc_row=None) -> None:
        self._row = row
        self._rowptr = rowptr
        self._col = col
        self._value = value
        self._sparse_sizes = (int(sparse_sizes[0]), int(sparse_sizes[1]))
        self._rowcount = rowcount
        self._colptr = colptr
        self._colcount = colcount
        self._csr2csc = csr2csc
        self._csc2csr = csc2csr
        self._csc_row = csc_row
        self._hybrid = None
        self._hybrid_skip = None
        self._np_cache = {} if np_cache is None else dict(np_cache)

    @classmethod
    def _new(cls, **fields) -> "SparseStorage":
        """Internal constructor over already validated, sorted device
        tensors (no host round trip)."""
        out = object.__new__(cls)
        out._init(**fields)
        return out

    @property
    def device(self) -> torch.device:
        return self._col.device

    # ------------------------------------------------------------------
    # Host copies.  Every storage holds host int64 copies of ``col`` and
    # of ``row`` or ``rowptr`` (the constructor, ``coalesce`` and the
    # diagonal ops seed them), so every derived index below is computed
    # on the host and uploaded once.
    # ------------------------------------------------------------------
    def _np_seed(self, name: str, arr: np.ndarray) -> np.ndarray:
        self._np_cache[name] = np.ascontiguousarray(arr, np.int64)
        return self._np_cache[name]

    def numpy_view(self, name: str) -> np.ndarray:
        """Host int64 copy of ``row/rowptr/col/colptr/csr2csc/csc2csr``,
        memoized; a cache handed to the constructor is pulled from the
        device."""
        if name not in self._np_cache:
            arr = getattr(self, name)()
            if name not in self._np_cache:
                self._np_seed(name, arr.cpu().numpy())
        return self._np_cache[name]

    def _upload(self, name: str, arr: np.ndarray) -> torch.Tensor:
        return _dev_index(self._np_seed(name, arr), self.device)

    # ------------------------------------------------------------------
    # Format views
    # ------------------------------------------------------------------
    def has_row(self) -> bool:
        return self._row is not None

    def row(self) -> torch.Tensor:
        if self._row is None:
            hptr = self._np_cache["rowptr"]
            self._row = self._upload("row", np.repeat(
                np.arange(hptr.shape[0] - 1, dtype=np.int64), np.diff(hptr)))
        return self._row

    def has_rowptr(self) -> bool:
        return self._rowptr is not None

    def rowptr(self) -> torch.Tensor:
        if self._rowptr is None:
            self._rowptr = self._upload("rowptr", np.searchsorted(
                self._np_cache["row"],
                np.arange(self._sparse_sizes[0] + 1, dtype=np.int64)))
        return self._rowptr

    def col(self) -> torch.Tensor:
        return self._col

    def has_value(self) -> bool:
        return self._value is not None

    def value(self) -> Optional[torch.Tensor]:
        return self._value

    def set_value(self, value, layout: Optional[str] = None
                  ) -> "SparseStorage":
        """New storage with ``value`` replaced; a ``'csc'``-ordered value
        is permuted back into CSR order via ``csc2csr``.  Index caches
        carry over; the hybrid view does not (its blocks bake the old
        values)."""
        if value is not None:
            value = _as_value(value, self.device)
            if get_layout(layout) == "csc":
                value = value[self.csc2csr()]
            if value.shape[0] != self.nnz():
                raise ValueError("`value` must have one entry per nnz")
        return self._new(
            row=self._row, rowptr=self._rowptr, col=self._col, value=value,
            sparse_sizes=self._sparse_sizes, rowcount=self._rowcount,
            colptr=self._colptr, colcount=self._colcount,
            csr2csc=self._csr2csc, csc2csr=self._csc2csr,
            np_cache=self._np_cache, csc_row=self._csc_row,
        )

    set_value_ = set_value

    # ------------------------------------------------------------------
    # Sizes
    # ------------------------------------------------------------------
    def sparse_sizes(self) -> Tuple[int, int]:
        return self._sparse_sizes

    def sparse_size(self, dim: int) -> int:
        return self._sparse_sizes[dim]

    def nnz(self) -> int:
        return int(self._col.shape[0])

    # ------------------------------------------------------------------
    # Derived caches
    # ------------------------------------------------------------------
    def has_rowcount(self) -> bool:
        return self._rowcount is not None

    def rowcount(self) -> torch.Tensor:
        if self._rowcount is None:
            self._rowcount = _dev_index(np.diff(self.numpy_view("rowptr")),
                                        self.device)
        return self._rowcount

    def has_colptr(self) -> bool:
        return self._colptr is not None

    def colptr(self) -> torch.Tensor:
        if self._colptr is None:
            counts = np.bincount(self._np_cache["col"],
                                 minlength=self._sparse_sizes[1])
            self._colptr = self._upload(
                "colptr", np.concatenate([[0], np.cumsum(counts)]))
        return self._colptr

    def has_colcount(self) -> bool:
        return self._colcount is not None

    def colcount(self) -> torch.Tensor:
        if self._colcount is None:
            self._colcount = _dev_index(
                np.bincount(self._np_cache["col"],
                            minlength=self._sparse_sizes[1]), self.device)
        return self._colcount

    def has_csr2csc(self) -> bool:
        return self._csr2csc is not None

    def csr2csc(self) -> torch.Tensor:
        """Permutation taking CSR-ordered nnz to CSC order: a stable sort
        by (col, row)."""
        if self._csr2csc is None:
            self._csr2csc = self._upload("csr2csc", lexsort2(
                self._np_cache["col"], self.numpy_view("row"),
                max(self._sparse_sizes[0], 1)))
        return self._csr2csc

    def has_csc2csr(self) -> bool:
        return self._csc2csr is not None

    def csc2csr(self) -> torch.Tensor:
        if self._csc2csr is None:
            perm = self.numpy_view("csr2csc")
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.shape[0], dtype=np.int64)
            self._csc2csr = self._upload("csc2csr", inv)
        return self._csc2csr

    def csc_row(self) -> torch.Tensor:
        """``row[csr2csc]``, int32: the column indices of the transpose's
        CSR, which the ``grad_mat`` pass of the CSR route reads."""
        if self._csc_row is None:
            self._csc_row = self.row()[self.csr2csc()]
        return self._csc_row

    # ------------------------------------------------------------------
    # Hybrid block-dense + CSR view (ops/kernels/hybrid.py).  Built
    # eagerly on the first request when the block-density statistics
    # predict that densifying pays; uniform and sparse graphs record a
    # skip marker and stay on the CSR kernel.
    #
    # The block and dense stores hold copies of the values.  Every
    # request holds the view against the current values
    # (``hybrid.refresh_plan``: one compare on the device, whose result
    # the host waits for) and, after any write to them, an optimizer
    # step or a write through ``.data``, serves a view whose store was
    # written anew from them on the device; the structure is kept.
    # ------------------------------------------------------------------
    def has_hybrid(self) -> bool:
        return self._hybrid is not None

    def set_hybrid_(self, h) -> "SparseStorage":
        """Install a pre-built :class:`HybridFormat` or
        :class:`DenseFormat`, built from this storage's edges in CSR
        order (``build_hybrid_from_tensor``, or ``build_hybrid`` over
        ``numpy_view("row")``/``numpy_view("col")``).  A view whose store
        requires grad is served as it is; any other follows the values
        (:meth:`hybrid`)."""
        self._hybrid = h
        self._hybrid_skip = None
        return self

    def hybrid(self, auto: bool = True, K_hint: Optional[int] = None):
        """Cached hybrid view; ``auto`` builds it when the density
        statistics say the block routes win.  Returns None on graphs
        where the format would not pay.

        ``K_hint`` is the caller's feature width: the break-even prices
        the block cost (which grows with K) against the per-edge cost.
        The view is priced at the first call's K and cached; a prior
        skip is re-evaluated when a narrower K arrives.  The decision
        rule and its constants are the JAX package's, unchanged.  A view
        whose values have changed since it was built is refreshed from
        the current ones on the device; only a bf16 store chosen for
        values that no longer fit it is dropped, so the router decides
        (and builds) again.
        """
        K = int(K_hint) if K_hint else 128
        if self._hybrid is not None:
            from .ops.kernels.hybrid import refresh_plan

            plan = refresh_plan(self._hybrid, self._value)
            if plan is None:
                return self._hybrid
            # Drop the old view first, so that its store is freed before
            # the new one is written (unless a pending backward holds it).
            self._hybrid = None
            if plan:
                self._hybrid = plan()
                return self._hybrid
            self._hybrid_skip = None
        skip_K = self._hybrid_skip
        if not auto or (skip_K is not None and K >= skip_K):
            return None
        value = self._value
        if value is not None and not value.is_floating_point():
            self._hybrid_skip = 0  # int/bool values stay on the CSR path
            return None
        M, N = self._sparse_sizes
        B = self._HYBRID_B
        if self.nnz() < self._HYBRID_MIN_EDGES or min(M, N) < 4 * B:
            self._hybrid_skip = 0
            return None
        row = self.numpy_view("row")
        col = self.numpy_view("col")
        from .ops.kernels.hybrid import (
            block_break_even, build_dense, build_hybrid, dense_fraction,
            get_store_budget, quantization_rel_err,
        )

        elem = 4 if value is None else max(4, value.element_size())
        # Store dtype: bf16 when the values' quantization error fits the
        # declared budget (default 0: lossless only, e.g. implicit ones).
        q = quantization_rel_err(value) if elem <= 4 else float("inf")
        store_bf16 = q <= get_store_budget()
        s_elem = 2 if store_bf16 else elem
        be = block_break_even(B, K_hint=K, elem=s_elem,
                              passes=1.0 if store_bf16 else 3.0)
        E = row.shape[0]
        store_dtype = torch.bfloat16 if store_bf16 else None
        if (E / (M * N) >= be
                and M * N * s_elem <= self._DENSE_MAX_BYTES):
            return self._keep_hybrid(build_dense(
                row, col, value, M, N, dtype=store_dtype,
                device=self.device), store_bf16)
        frac, nb = dense_fraction(row, col, M, N, B=B, min_density=be)
        if frac < self._HYBRID_MIN_FRACTION:
            self._hybrid_skip = K  # re-evaluate only for narrower K
            return None
        blk_bytes = (nb + 1) * B * B * s_elem
        if blk_bytes > self._HYBRID_MAX_BLOCK_BYTES:
            if (elem <= 4
                    and (nb + 1) * B * B * 2 <= self._HYBRID_MAX_BLOCK_BYTES):
                store_dtype = torch.bfloat16
            else:
                self._hybrid_skip = 0
                return None
        return self._keep_hybrid(build_hybrid(
            row, col, value, M, N, B=B, min_density=be,
            block_dtype=store_dtype, device=self.device), store_bf16)

    def _keep_hybrid(self, h, store_bf16: bool):
        """Cache a view built by the router; a bf16 store chosen because
        the values fit the store budget holds later values to it too."""
        if store_bf16:
            from .ops.kernels.hybrid import get_store_budget

            h.index.bf16_budget = get_store_budget()
        self._hybrid = h
        return h

    # ------------------------------------------------------------------
    # Coalescing: dedupe sorted (row, col) pairs on the host; values that
    # require grad are reduced on the device, the rest on the host.
    # ------------------------------------------------------------------
    def is_coalesced(self) -> bool:
        hrow = self.numpy_view("row")
        hcol = self.numpy_view("col")
        if hrow.shape[0] < 2:
            return True
        return not bool(np.any((hrow[1:] == hrow[:-1])
                               & (hcol[1:] == hcol[:-1])))

    def coalesce(self, reduce: str = "add") -> "SparseStorage":
        if reduce not in ("add", "sum", "mean", "min", "max"):
            raise ValueError(f"Unknown reduce: {reduce!r}")
        hrow = self.numpy_view("row")
        hcol = self.numpy_view("col")
        E = hrow.shape[0]
        if E == 0:
            return self
        keep = np.concatenate(
            [[True], (hrow[1:] != hrow[:-1]) | (hcol[1:] != hcol[:-1])])
        if keep.all():
            return self
        new_row, new_col = hrow[keep], hcol[keep]
        new_value = None
        value = self._value
        if value is not None and value.requires_grad:
            # Reduce on the device so that the gradient reaches ``value``;
            # sums add each run of duplicates in edge order (Runs), so
            # the card gives the same bits on every run.
            starts = np.flatnonzero(keep)
            if reduce in ("add", "sum", "mean"):
                ptr = np.concatenate([starts, [E]])
                new_value = Runs(ptr, value.device).sum(value)
                if reduce == "mean":
                    cnt = torch.from_numpy(np.diff(ptr)).to(
                        device=value.device, dtype=new_value.dtype)
                    new_value = new_value / cnt.reshape(
                        (-1,) + (1,) * (new_value.dim() - 1))
            else:
                seg = torch.from_numpy(np.cumsum(keep) - 1).to(value.device)
                reducer = segment_min if reduce == "min" else segment_max
                new_value = reducer(value, seg, new_row.shape[0])
        elif value is not None:
            starts_trunc = np.flatnonzero(keep)
            v = _to_numpy(value)
            if reduce in ("add", "sum"):
                out = np.add.reduceat(v, starts_trunc, axis=0)
            elif reduce == "mean":
                cnt = np.diff(np.concatenate([starts_trunc, [E]]))
                shape = (-1,) + (1,) * (v.ndim - 1)
                out = (np.add.reduceat(v.astype(np.float64), starts_trunc,
                                       axis=0)
                       / cnt.reshape(shape)).astype(v.dtype)
            elif reduce == "min":
                out = np.minimum.reduceat(v, starts_trunc, axis=0)
            else:
                out = np.maximum.reduceat(v, starts_trunc, axis=0)
            new_value = torch.from_numpy(np.ascontiguousarray(out)).to(
                device=self.device, dtype=value.dtype)
        dev = self.device
        return self._new(
            row=_dev_index(new_row, dev), rowptr=None,
            col=_dev_index(new_col, dev), value=new_value,
            sparse_sizes=self._sparse_sizes,
            np_cache={"row": new_row, "col": new_col},
        )

    # ------------------------------------------------------------------
    # Cache control
    # ------------------------------------------------------------------
    def fill_cache_(self) -> "SparseStorage":
        self.row()
        self.rowptr()
        self.rowcount()
        self.colptr()
        self.colcount()
        self.csr2csc()
        self.csc2csr()
        return self

    def clear_cache_(self) -> "SparseStorage":
        for key in _CACHE_KEYS:
            setattr(self, f"_{key}", None)
        self._csc_row = None
        self._hybrid = None
        self._hybrid_skip = None
        return self

    def cached_keys(self) -> List[str]:
        return [key for key in _CACHE_KEYS
                if getattr(self, f"_{key}") is not None]

    def num_cached_keys(self) -> int:
        return len(self.cached_keys())

    def copy(self) -> "SparseStorage":
        out = self._new(
            row=self._row, rowptr=self._rowptr, col=self._col,
            value=self._value, sparse_sizes=self._sparse_sizes,
            rowcount=self._rowcount, colptr=self._colptr,
            colcount=self._colcount, csr2csc=self._csr2csc,
            csc2csr=self._csc2csr, np_cache=self._np_cache,
            csc_row=self._csc_row,
        )
        out._hybrid = self._hybrid
        out._hybrid_skip = self._hybrid_skip
        return out

    clone = copy

    def __repr__(self) -> str:
        M, N = self._sparse_sizes
        return (f"{self.__class__.__name__}(sparse_sizes=({M}, {N}), "
                f"nnz={self.nnz()}, device={self.device}, "
                f"cached={self.cached_keys()})")
