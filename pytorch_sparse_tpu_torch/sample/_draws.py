"""The native samplers' draw stream, in numpy ``uint64``.

The JAX package's host samplers run in its C++ library
(``pytorch_sparse_tpu/csrc/native.cpp``), whose draws come from a
xoshiro256** generator seeded through SplitMix64 for each
``(seed, stream, element)``: ``element`` is a row's position in the
frontier, ``stream`` 0 for ``sample_adj`` and ``hop + 1`` for
``neighbor_sample``.  This module reproduces those draws bit for bit,
so that the port's samplers pick exactly the edges that the JAX
package's default path picks.

Rows are independent streams, so they step in lockstep: the generator
state is four ``(n_rows,)`` arrays, and one numpy pass advances every
row by one draw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_U64 = np.uint64
_MASK32 = _U64(0xFFFFFFFF)
_GOLDEN = _U64(0x9E3779B97F4A7C15)
_MIX1 = _U64(0xBF58476D1CE4E5B9)
_MIX2 = _U64(0x94D049BB133111EB)


def native_seed(seed: Optional[int]) -> int:
    """The ``uint64`` seed of the native path: an ``int`` taken mod 2**64,
    ``None`` as 0.  Any other type raises ``TypeError`` (the JAX package
    draws from 0 for every non-``int`` seed on its native path)."""
    if seed is None:
        return 0
    if isinstance(seed, (bool, np.bool_)) or not isinstance(
            seed, (int, np.integer)):
        raise TypeError(f"seed must be an int or None, got {type(seed)!r}")
    return int(seed) % (1 << 64)


def _rotl(x: np.ndarray, k: int) -> np.ndarray:
    return (x << _U64(k)) | (x >> _U64(64 - k))


def _splitmix64(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(new state, output)`` of one SplitMix64 step (``native.cpp:43``)."""
    x = x + _GOLDEN
    z = (x ^ (x >> _U64(30))) * _MIX1
    z = (z ^ (z >> _U64(27))) * _MIX2
    return x, z ^ (z >> _U64(31))


def seed_states(seed: int, stream: int, elements: np.ndarray) -> np.ndarray:
    """``(4, n)`` xoshiro states of ``rng_seed_at(seed, stream, element)``
    for each of ``elements`` (``native.cpp:50``, ``:92``)."""
    with np.errstate(over="ignore"):
        e = np.asarray(elements).astype(_U64)
        x = (np.full(e.shape, seed, _U64)
             ^ (_GOLDEN * _U64((stream + 1) % (1 << 64)))
             ^ (_MIX1 * (e + _U64(1))))
        state = np.empty((4,) + e.shape, _U64)
        for i in range(4):
            x, state[i] = _splitmix64(x)
    return state


def next_u64(state: np.ndarray) -> np.ndarray:
    """One xoshiro256** step of every row (``rng_next``, ``native.cpp:58``);
    ``state`` is advanced in place."""
    s0, s1, s2, s3 = state
    with np.errstate(over="ignore"):
        result = _rotl(s1 * _U64(5), 7) * _U64(9)
        t = s1 << _U64(17)
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        state[3] = _rotl(s3, 45)
    return result


def _mulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The high 64 bits of the 128-bit products ``a * b``, from 32-bit
    limbs (numpy has no 128-bit integer)."""
    a_lo, a_hi = a & _MASK32, a >> _U64(32)
    b_lo, b_hi = b & _MASK32, b >> _U64(32)
    with np.errstate(over="ignore"):
        lo_lo = a_lo * b_lo
        hi_lo = a_hi * b_lo
        lo_hi = a_lo * b_hi
        cross = (lo_lo >> _U64(32)) + (hi_lo & _MASK32) + lo_hi
        return a_hi * b_hi + (hi_lo >> _U64(32)) + (cross >> _U64(32))


def below(state: np.ndarray, n: np.ndarray) -> np.ndarray:
    """``rng_below(n)`` of every row: a draw in ``[0, n)`` as the high
    word of ``next() * n`` (``native.cpp:70``)."""
    return _mulhi64(next_u64(state), np.asarray(n).astype(_U64)).astype(
        np.int64)


def sample_sizes(deg: np.ndarray, num: int, replace: bool) -> np.ndarray:
    """Edges drawn from each row (``sample_size_of``, ``native.cpp:144``):
    0 for an empty row, the whole row when ``num < 0`` or when it has no
    more than ``num`` edges and draws go without replacement, else
    ``num``."""
    deg = np.asarray(deg, np.int64)
    if num < 0:
        return deg
    if replace:
        return np.where(deg > 0, num, 0).astype(np.int64)
    return np.minimum(deg, num)


def draw_candidates(starts: np.ndarray, deg: np.ndarray, num: int,
                    replace: bool, seed: int, stream: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The edges the native ``draw_candidates`` (``native.cpp:106``) picks
    for frontier rows whose edges are ``starts[i] .. starts[i]+deg[i]-1``.

    Returns ``(rix, edge)``: for each pick, its frontier position and its
    absolute edge position, grouped by row in the native order (a whole
    row in edge order, else the order of the draws).  Without
    replacement a row draws by Robert Floyd's method: step ``t`` draws
    ``below(j)`` with ``j = deg - num + t`` and takes ``j`` when that
    pick was taken before.
    """
    starts = np.asarray(starts, np.int64)
    deg = np.asarray(deg, np.int64)
    sizes = sample_sizes(deg, num, replace)
    n = deg.shape[0]
    out_ptr = np.concatenate([[0], np.cumsum(sizes)])
    rix = np.repeat(np.arange(n, dtype=np.int64), sizes)
    edge = np.empty(int(out_ptr[-1]), np.int64)
    full = (sizes == deg) if num < 0 or not replace else np.zeros(n, bool)
    full &= sizes > 0
    # Whole rows: every edge in order, no draw.
    f = np.flatnonzero(full)
    if f.size:
        fr = np.repeat(f, sizes[f])
        off = np.arange(fr.shape[0]) - np.repeat(
            np.cumsum(sizes[f]) - sizes[f], sizes[f])
        edge[out_ptr[fr] + off] = starts[fr] + off
    d = np.flatnonzero(~full & (sizes > 0))
    if d.size:
        state = seed_states(seed, stream, d)
        picks = np.empty((d.size, num), np.int64)
        dd = deg[d]
        for t in range(num):
            if replace:
                picks[:, t] = below(state, dd)
                continue
            j = dd - num + t
            r = below(state, j)
            if t:
                taken = (picks[:, :t] == r[:, None]).any(axis=1)
                r = np.where(taken, j, r)
            picks[:, t] = r
        edge[(out_ptr[d][:, None] + np.arange(num)).reshape(-1)] = (
            starts[d][:, None] + picks).reshape(-1)
    return rix, edge
