"""Save and load sparse tensors (counterpart of
``pytorch_sparse_tpu/utils/serialize.py``).

An ``.npz`` archive of the storage's arrays and filled caches, under the
JAX package's keys (``sparse_sizes`` and ``_FIELDS``), so that each
package reads the other's storage fields; a value of a type numpy lacks
(bfloat16, float8) is stored as unsigned words plus a ``<key>.dtype``
record, as the JAX package stores it.  The port's routed view (a
:class:`HybridFormat` or :class:`DenseFormat` with its
:class:`StoreIndex`) is saved under keys of its own, ``_view.*``, so that
a graph's expensive host build is paid once and served again with the
same bits.  The JAX package's views (``_ell*``, ``_hybrid.*``) are TPU
layouts: the loader skips them, and the port builds its own when asked.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..typing import DeviceLike, resolve_device

_FIELDS = (
    "_row", "_rowptr", "_col", "_value", "_rowcount", "_colptr",
    "_colcount", "_csr2csc", "_csc2csr",
)
# Element types numpy lacks, by the name the JAX package records (the
# ml_dtypes name) for their unsigned words.
_WORD_TYPES = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}
_UNSIGNED = {1: np.uint8, 2: np.uint16}
_SIGNED = {1: torch.uint8, 2: torch.int16}
_VIEW = "_view."


def _pack(t: torch.Tensor, payload: dict, key: str) -> None:
    """Store ``t`` under ``key`` as a numpy array; a type numpy lacks
    goes in as its unsigned words with a ``<key>.dtype`` record."""
    t = t.detach().cpu().contiguous()
    name = {v: k for k, v in _WORD_TYPES.items()}.get(t.dtype)
    if name is not None:
        payload[f"{key}.dtype"] = np.str_(name)
        payload[key] = t.view(_SIGNED[t.element_size()]).numpy().view(
            _UNSIGNED[t.element_size()])
    else:
        payload[key] = t.numpy()


def _unpack(data: dict, key: str, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(data[key])
    dt = data.get(f"{key}.dtype")
    if dt is None:
        return torch.from_numpy(a).to(device)
    words = torch.from_numpy(a.view(np.dtype(f"i{a.dtype.itemsize}")))
    return words.view(_WORD_TYPES[str(dt)]).to(device)


def _get(data: dict, key: str, device) -> Optional[torch.Tensor]:
    return _unpack(data, key, device) if key in data else None


def _save_csr(payload: dict, prefix: str, csr) -> None:
    if csr is not None:
        for i, t in enumerate(csr):
            _pack(t, payload, f"{prefix}.{i}")


def _load_csr(data: dict, prefix: str, device):
    if f"{prefix}.0" not in data:
        return None
    return tuple(_unpack(data, f"{prefix}.{i}", device) for i in range(3))


def _save_index(payload: dict, index) -> None:
    """The view's :class:`StoreIndex`: where each edge's value lands in
    the store and in the remainder."""
    p = _VIEW + "index."
    payload[p + "meta"] = np.asarray(
        [index.n_edges, len(index.dups)], np.int64)
    _pack(index.first, payload, p + "first")
    _pack(index.pos, payload, p + "pos")
    for d, (runs, edges) in enumerate(index.dups):
        _pack(runs, payload, f"{p}runs{d}")
        _pack(edges, payload, f"{p}edges{d}")
    for name in ("rest", "rest_t"):
        if getattr(index, name) is not None:
            _pack(getattr(index, name), payload, p + name)
    if index.bf16_budget is not None:
        payload[p + "bf16_budget"] = np.float64(index.bf16_budget)


def _load_index(data: dict, device):
    from ..ops.kernels.hybrid import StoreIndex

    p = _VIEW + "index."
    n_edges, n_dups = (int(x) for x in data[p + "meta"])
    index = object.__new__(StoreIndex)
    index.first = _unpack(data, p + "first", device)
    index.pos = _unpack(data, p + "pos", device)
    index.dups = [(_unpack(data, f"{p}runs{d}", device),
                   _unpack(data, f"{p}edges{d}", device))
                  for d in range(n_dups)]
    index.rest = _get(data, p + "rest", device)
    index.rest_t = _get(data, p + "rest_t", device)
    index.n_edges = n_edges
    index.bf16_budget = (float(data[p + "bf16_budget"])
                         if p + "bf16_budget" in data else None)
    return index


def _save_view(payload: dict, h, value: Optional[torch.Tensor]) -> None:
    from ..ops.kernels.block_spmm import store_layout
    from ..ops.kernels.hybrid import DenseFormat, HybridFormat, _same_bits

    if h.index is None:
        raise ValueError(f"{type(h).__name__} has no StoreIndex: it cannot "
                         "follow the values after a load, so it is not saved")
    if isinstance(h, DenseFormat):
        payload[_VIEW + "kind"] = np.str_("dense")
        payload[_VIEW + "meta"] = np.asarray([h.M, h.N], np.int64)
        _pack(h.dense, payload, _VIEW + "dense")
    else:
        assert isinstance(h, HybridFormat), type(h)
        payload[_VIEW + "kind"] = np.str_("hybrid")
        payload[_VIEW + "meta"] = np.asarray(
            [h.M, h.N, h.B, h.dense_nnz, h.M_pad], np.int64)
        # The padded buffer the kernels read, padding included.
        _pack(store_layout(h.blocks), payload, _VIEW + "blocks")
        for name in ("slot_row", "slot_col", "rb_ptr", "order_t",
                     "cb_ptr"):
            _pack(getattr(h, name), payload, _VIEW + name)
        if h.row_map is not None:
            _pack(h.row_map, payload, _VIEW + "row_map")
        _save_csr(payload, _VIEW + "rest", h.rest)
        _save_csr(payload, _VIEW + "rest_t", h.rest_t)
    _save_index(payload, h.index)
    # ``source``, the values the store holds: restored from the storage's
    # value when they hold the same bits (``source.same``), else saved.
    if h.source is not None:
        if value is not None and _same_bits(value, h.source):
            payload[_VIEW + "source.same"] = np.bool_(True)
        else:
            _pack(h.source, payload, _VIEW + "source")


def _load_view(data: dict, value: Optional[torch.Tensor], device):
    from ..ops.kernels.hybrid import DenseFormat, HybridFormat

    kind = data.get(_VIEW + "kind")
    if kind is None:
        return None
    index = _load_index(data, device)
    if _VIEW + "source.same" in data:
        source = value.detach().clone()
    else:
        source = _get(data, _VIEW + "source", device)
    if str(kind) == "dense":
        M, N = (int(x) for x in data[_VIEW + "meta"])
        return DenseFormat(_unpack(data, _VIEW + "dense", device), M, N,
                           index=index, source=source)
    M, N, B, dense_nnz, M_pad = (int(x) for x in data[_VIEW + "meta"])
    buf = _unpack(data, _VIEW + "blocks", device)
    blocks = buf if buf.shape[2] == B else buf[:, :, :B]
    return HybridFormat(
        blocks, *(_unpack(data, _VIEW + n, device) for n in (
            "slot_row", "slot_col", "rb_ptr", "order_t", "cb_ptr")),
        _load_csr(data, _VIEW + "rest", device),
        _load_csr(data, _VIEW + "rest_t", device), M, N, B, dense_nnz,
        row_map=_get(data, _VIEW + "row_map", device), M_pad=M_pad,
        index=index, source=source)


def save_npz(path: str, src) -> None:
    """Save ``src``: its arrays, its filled caches and its routed view
    (hybrid or dense), if it has one."""
    st = src.storage
    payload = {"sparse_sizes": np.asarray(st.sparse_sizes(), np.int64)}
    for f in _FIELDS:
        t = getattr(st, f)
        if t is not None:
            _pack(t, payload, f)
    if st._hybrid is not None:
        _save_view(payload, st._hybrid, st._value)
    np.savez(path, **payload)


def load_npz(path: str, device: DeviceLike = None):
    """Load a tensor saved by either package onto ``device`` (default
    ``"cuda"``).  A routed view saved by the port is restored and serves
    ``spmm`` with no host rebuild; the JAX package's views are skipped."""
    from ..storage import SparseStorage
    from ..tensor import SparseTensor

    dev = resolve_device(device)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    host = {f: np.asarray(data[f]) if f in data else None
            for f in ("_row", "_rowptr", "_col")}
    M, N = (int(x) for x in data["sparse_sizes"])
    value = _get(data, "_value", dev)
    storage = SparseStorage(
        row=host["_row"], rowptr=host["_rowptr"], col=host["_col"],
        value=value, sparse_sizes=(M, N),
        rowcount=_get(data, "_rowcount", dev),
        colptr=_get(data, "_colptr", dev),
        colcount=_get(data, "_colcount", dev),
        csr2csc=_get(data, "_csr2csc", dev),
        csc2csr=_get(data, "_csc2csr", dev),
        is_sorted=True, trust_data=True, device=dev,
    )
    h = _load_view(data, storage.value(), dev)
    if h is not None:
        storage.set_hybrid_(h)
    return SparseTensor.from_storage(storage)
