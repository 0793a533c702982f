"""Probe: is a column-locality SpMM that gathers from on-chip tiles
expressible, and does it pay, on a CUDA card?

The counterpart of the JAX package's ``benchmarks/probe_vmem_gather.py``.
That probe asked whether SpMM can stream X's row tiles through VMEM, the
TPU core's on-chip memory, and gather each edge's row from the resident
tile, fusing the gather and the segment reduce in one pass.  Mosaic
refused the gather: ``take_along_axis`` reaches one vreg, 8 rows
("Multiple source vregs along gather dimension"), so the JAX probe
recorded a negative result.  Here VMEM is the SM's shared memory, up to
227 KB a block, and the probe measures, with the kernels of
``ops/kernels/smem_gather.py``:

1. :func:`probe_gather_restriction`: the row gather from a table held in
   shared memory (K13a, ``smem_gather``) at the JAX probe's T = 2048 and
   T = 8, K = 128, against ``index_select`` in :data:`GATHER_ROUNDS`
   alternating pairs; the inputs are the JAX probe's (``RandomState(0)``).
2. :func:`_loop_time`: the edge-axis scan ``sum_{i<R} cumsum(h + i)``
   (K13b, ``edge_scan_loop``) at R = 8 and 40 inside one launch, and the
   time a pass as the slope between them (``h`` from ``RandomState(1)``).
3. :func:`tiled_vs_csr`: the design itself, K13c (``tiled_spmm``), X's
   row tiles staged in shared memory where a (row block, tile) pair holds
   enough edges, against the CSR kernel K1 (``csr_spmm``) on the same
   graph, bit for bit, and against cuSPARSE (``torch.sparse_csr_tensor
   @ x``), all timed, with the floor that shared memory's rate puts under
   the staged edges.  The same walk with no tile staged is the control.

Each time is given twice: ``ms``, the slope of a chain of calls timed
with CUDA events (the host's launch path where it is slower than the
kernel), and ``device_ms``, the kernels' own time a call in a
``torch.profiler`` trace of :data:`TRACE_CALLS` calls.

Run it on one card (it fails without one)::

    python -m pytorch_sparse_tpu_torch.benchmarks.probe_vmem_gather \
        [--only gather|scan|tiled] [--out FILE]

It builds the ogbn-arxiv-scale uniform graph and the community hybrid
graph of ``chip_smoke.py``, prints the card, each measurement, and ends
with the verdict: whether the big-table gather works on this card and
beats ``index_select``, and whether the staged SpMM, and apart from it
the walk with nothing staged, beats K1 and cuSPARSE on each graph, in
call and in device ms; a gap within :data:`TIE` is a tie.  :func:`run`
returns the same results as a dict (``chip_smoke.py`` phase 17 calls it
with its own graphs); every check it makes is listed under
``"failures"``.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.kernels import csr_spmm
from ..ops.kernels.smem_gather import (
    SLAB, edge_scan_loop, edge_scan_loop_plain, smem_gather,
    smem_gather_plain, tiled_spmm, tiled_spmm_plain, tiled_spmm_plan)
from ..tensor import SparseTensor
from ..testing import community_graph
from .timing import device_time

T = 2048    # edges per chunk
K = 128
REPS = (8, 40)
GATE = 1e-5                 # kernel vs plain version, relative to max |ref|
UNIFORM = (169_343, 1_166_243)             # ogbn-arxiv nodes and edges
HYBRID = (232_965, 16_000_000, 200)        # nodes, draws, communities
# The all-staged case, at T=64: its 12 tiles of 64 rows fit in a block.
SMALL = (768, 37_500, 4)
# K13c's tile heights (rows of X): a block stages at most 1, 3 and 6
# of them on the community hybrid.
TILES = (512, 256, 128)
TRACE_CALLS = 10            # calls a profiler trace holds
# K13a's calls take microseconds, near the host's noise: a chain of 500
# calls against one, the best of GATHER_REPEATS, each function timed in
# turns with the others GATHER_ROUNDS times; a call's time is the median
# of its rounds.
GATHER_CHAIN = (1, 501)
GATHER_REPEATS = 5
GATHER_ROUNDS = 10
# Two times within this share of the larger are a tie: the spread of one
# kernel's time across runs on the card (PERF.md section 7).
TIE = 0.04
SMEM_BYTES_PER_CLOCK = 128  # an SM's shared memory, bytes a clock


def gather_inputs(device) -> list:
    """The JAX probe's two gathers, ``[(idx, table)]`` at T = 2048 and
    T = 8, from one ``RandomState(0)`` in its order; ``idx`` flat."""
    rng = np.random.RandomState(0)
    out = []
    for n in (T, 8):
        x = rng.randn(n, K).astype(np.float32)
        idx = rng.randint(0, n, (n, 1)).astype(np.int32)
        out.append((torch.from_numpy(idx[:, 0]).to(device),
                    torch.from_numpy(x).to(device)))
    return out


def scan_input(device) -> torch.Tensor:
    """The JAX probe's ``h``: ``RandomState(1).randn(T, K)``."""
    h = np.random.RandomState(1).randn(T, K).astype(np.float32)
    return torch.from_numpy(h).to(device)


def uniform_graph(device) -> SparseTensor:
    """The ogbn-arxiv-scale uniform graph of the JAX package's
    ``bench.py`` (same seed and draws)."""
    M, E = UNIFORM
    rng = np.random.RandomState(0)
    row = np.sort(rng.randint(0, M, E)).astype(np.int32)
    col = rng.randint(0, M, E).astype(np.int32)
    order = np.lexsort((col, row))
    return SparseTensor(
        row=row[order], col=col[order],
        value=rng.randn(E).astype(np.float32), sparse_sizes=(M, M),
        is_sorted=True, trust_data=True, device=device)


def probe_graphs(device) -> Dict[str, SparseTensor]:
    """The uniform and the community hybrid graph of ``chip_smoke.py``."""
    M, E, n = HYBRID
    return {"uniform": uniform_graph(device),
            "community hybrid": community_graph(
                M, E, n_comm=n, seed=1, equal_sizes=True, device=device)}


def _errors(got, ref):
    diff = (got.double() - ref.double()).abs().max().item() if got.numel() \
        else 0.0
    scale = ref.double().abs().max().item() if ref.numel() else 0.0
    return diff, diff / scale if scale > 0 else diff


def call_ms(fn, ref, repeats, n_lo=4, n_hi=24):
    """Milliseconds a call of ``fn``, by :func:`device_time` on the
    device of ``ref``."""
    return 1e3 * device_time(lambda c: fn(), ref, n_lo=n_lo, n_hi=n_hi,
                             repeats=repeats)


def digest(t: torch.Tensor) -> str:
    """SHA-1 of a tensor's bytes: equal digests, equal bits."""
    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()
                        ).hexdigest()


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_ms(fn, ref, calls: int = TRACE_CALLS) -> Optional[float]:
    """The device's own milliseconds a call of ``fn``: in a
    ``torch.profiler`` trace of ``calls`` calls after one warm-up, each
    kernel's mean time times the launches it makes a call (at least one:
    the trace may drop a few events).  None off the card, or where the
    trace holds no device time after three tries (on an H100, one trace
    in a phase's dozens came back empty twice in a row)."""
    if ref.device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(ref.device)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(ref.device)
        us = sum(_device_us(e) / e.count * max(1, round(e.count / calls))
                 for e in prof.key_averages()
                 if e.device_type.name == "CUDA" and e.count)
        if us > 0:
            return us / 1e3
    return None


def _smi(query: str) -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def card_line(device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    None off the card."""
    return _smi("name,power.limit") if device.type == "cuda" else None


def smem_bytes_per_s(device) -> Optional[float]:
    """What shared memory serves over the whole card, bytes a second:
    the SMs times :data:`SMEM_BYTES_PER_CLOCK` at the card's highest SM
    clock (``nvidia-smi``'s ``clocks.max.sm``); None off the card."""
    if device.type != "cuda":
        return None
    mhz = _smi("clocks.max.sm")
    try:
        mhz = float(mhz.split()[0])
    except (AttributeError, IndexError, ValueError):
        return None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * SMEM_BYTES_PER_CLOCK * mhz * 1e6


def probe_gather_restriction(device) -> list:
    """The row gather from a table in shared memory at T = 2048 (the
    table the JAX probe could not gather from) and T = 8 (the one vreg
    it could), against ``index_select``.  The kernel, its plain version
    and ``index_select`` are timed in turns, :data:`GATHER_ROUNDS`
    rounds; a case's ``ms`` is the median of its rounds, and
    ``pairs_won`` counts the rounds in which the kernel's call was the
    faster."""
    cases = []
    for idx, table in gather_inputs(device):
        ref = smem_gather_plain(idx, table)

        def library():
            return torch.index_select(table, 0, idx)

        fns = {"kernel": functools.partial(smem_gather, idx, table),
               "plain": functools.partial(smem_gather_plain, idx, table),
               "library": library}
        rounds = {k: [] for k in fns}
        for _ in range(GATHER_ROUNDS):
            for k, fn in fns.items():
                rounds[k].append(call_ms(fn, table, GATHER_REPEATS,
                                         *GATHER_CHAIN))
        ms = {k: float(np.median(v)) for k, v in rounds.items()}
        got = smem_gather(idx, table)
        abs_e, rel_e = _errors(got, ref)
        n = table.shape[0]
        case = {
            "T": n, "K": K, "exact": bool(torch.equal(got, ref)),
            "max_abs_err": abs_e, "max_rel_err": rel_e,
            "digest": digest(got), "ms": ms["kernel"],
            "device_ms": device_ms(fns["kernel"], table),
            "rounds_ms": rounds["kernel"],
            "library_rounds_ms": rounds["library"],
            "pairs_won": sum(a < b for a, b in zip(rounds["kernel"],
                                                    rounds["library"])),
            "plain_ms": ms["plain"], "library_ms": ms["library"],
            "library_device_ms": device_ms(library, table)}
        cases.append(case)
        name = "big-table gather" if n == T else f"{n}-row window gather"
        print(f"{name} (T={n}, K={K}): "
              f"{'works, exact' if case['exact'] else 'WRONG'} (max err "
              f"{case['max_abs_err']}); {case['ms'] * 1e3:.2f} us a call "
              f"(median of {GATHER_ROUNDS}), {_us(case['device_ms'])} on the "
              f"device; index_select {case['library_ms'] * 1e3:.2f} us, "
              f"{_us(case['library_device_ms'])}; the kernel's call faster "
              f"in {case['pairs_won']} of {GATHER_ROUNDS} pairs", flush=True)
    return cases


def _us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def _ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _loop_time(h, label, reps=REPS, repeats: int = 3):
    """Time ``edge_scan_loop(h, R)`` (R passes in one launch) at the two
    ``reps``; the slope is the time a pass."""
    times = [device_time(lambda c, R=R: edge_scan_loop(h, R), h,
                         repeats=repeats) for R in reps]
    per = max((times[1] - times[0]) / (reps[1] - reps[0]), 1e-12)
    per_edge_ns = per / h.shape[0] * 1e9
    print(f"{label}: {per * 1e6:.2f} us/pass, {per_edge_ns:.3f} ns/edge "
          f"({h.shape[0] / per / 1e9:.2f} Gedge/s)", flush=True)
    return per, times


def tiled_vs_csr(rowptr, col, value, x, T_tile: int,
                 stage_min: Optional[int] = None, timed: bool = True,
                 repeats: int = 3, smem_rate: Optional[float] = None
                 ) -> dict:
    """K13c on one CSR matrix against its plain version (within
    :data:`GATE`) and K1 (bit for bit), and both timed, in call and in
    device ms.  ``smem_floor_ms``: the staged edges' rows (4K bytes an
    edge) at ``smem_rate`` bytes a second, the least time shared memory
    takes to serve them."""
    plan = tiled_spmm_plan(rowptr, col, x.shape[0], T=T_tile,
                           stage_min=stage_min)
    got = tiled_spmm(rowptr, col, value, x, plan)
    k1 = csr_spmm(rowptr, col, value, x)
    ref = tiled_spmm_plain(rowptr, col, value, x, plan)
    abs_e, rel_e = _errors(got, ref)
    E, Kx = col.shape[0], x.shape[1]
    smem_edge_bytes = plan.staged_edges * 4 * Kx
    res = {
        "T": T_tile, "stage_min": plan.stage_min, "slab": SLAB,
        "K": Kx, "values": value is not None, "M": rowptr.shape[0] - 1,
        "E": E, "pairs": plan.n_pairs, "staged_pairs": plan.n_staged,
        "staged_edge_share": plan.staged_edges / max(E, 1),
        "staged_bytes": plan.staged_bytes(Kx),
        "smem_edge_bytes": smem_edge_bytes,
        "smem_floor_ms": (None if smem_rate is None
                          else 1e3 * smem_edge_bytes / smem_rate),
        "direct_gather_bytes": (E - plan.staged_edges) * 4 * Kx,
        "k1_gather_bytes": E * (4 * Kx + (8 if value is not None else 4)),
        "smem_bytes": plan.smem_bytes(),
        "max_abs_err": abs_e, "max_rel_err": rel_e, "ok": rel_e <= GATE,
        "equal_k1": bool(torch.equal(got, k1)), "digest": digest(got)}
    if timed:
        def tiled():
            return tiled_spmm(rowptr, col, value, x, plan)

        def walk():
            return csr_spmm(rowptr, col, value, x)

        res["ms"] = call_ms(tiled, x, repeats)
        res["device_ms"] = device_ms(tiled, x)
        res["k1_ms"] = call_ms(walk, x, repeats)
        res["k1_device_ms"] = device_ms(walk, x)
        # The plain version takes a few launches a tile: a short chain.
        res["plain_ms"] = call_ms(
            lambda: tiled_spmm_plain(rowptr, col, value, x, plan), x, 1,
            n_lo=1, n_hi=3)
    return res


PARTS = ("gather", "scan", "tiled")


def run(device, graphs: Optional[Dict[str, SparseTensor]] = None,
        repeats: int = 3, parts=PARTS) -> dict:
    """Every measurement of the probe on ``device`` ("cuda", or "cpu"
    for the plain versions, where no device time is measured); ``graphs``
    (default :func:`probe_graphs`) maps a name to a graph with values,
    whose structure also runs with implicit ones.  ``parts`` picks the
    measurements (K13a's ``"gather"``, K13b's ``"scan"``, K13c's
    ``"tiled"``); the verdict needs ``"gather"`` and ``"tiled"``.  Failed
    checks are listed under ``"failures"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    card = card_line(dev)
    print(f"device: {name}; card: {card or 'not measured'}", flush=True)
    smem_rate = smem_bytes_per_s(dev)
    res = {"device": name, "card": card, "slab": SLAB,
           "smem_bytes_per_s": smem_rate, "failures": []}
    fail = res["failures"].append

    if "gather" in parts:
        res["gather"] = probe_gather_restriction(dev)
    for c in res.get("gather", ()):
        if not c["exact"]:
            fail(f"smem_gather at T={c['T']} differs from index_select")

    if "scan" in parts:
        _scan(dev, res, repeats)
    if "tiled" in parts:
        _tiled(dev, res, graphs, repeats, smem_rate)
    if "gather" in parts and "tiled" in parts:
        res["verdict"] = verdict(res, [g for g in dict.fromkeys(
            r["graph"] for r in res["tiled"]) if g != SMALL_NAME])
        print(verdict_line(name, res["verdict"]), flush=True)
    return res


SMALL_NAME = "small, every pair staged"


def _scan(dev, res, repeats) -> None:
    """K13b against its plain version at R = 1, 8 and 40, timed."""
    fail = res["failures"].append
    h = scan_input(dev)
    scan = []
    for R in (1,) + REPS:
        got, ref = edge_scan_loop(h, R), edge_scan_loop_plain(h, R)
        abs_e, rel_e = _errors(got, ref)
        scan.append({"R": R, "max_abs_err": abs_e, "max_rel_err": rel_e,
                     "ok": rel_e <= GATE})
        if rel_e > GATE:
            fail(f"edge_scan_loop at R={R}: rel err {rel_e:.3g}")
    scan[0]["plain_ms"] = call_ms(lambda: edge_scan_loop_plain(h, 1), h, repeats)
    per, times = _loop_time(h, f"cumsum ({T},{K}) axis=0", repeats=repeats)
    scan[0]["ms"] = call_ms(lambda: edge_scan_loop(h, 1), h, repeats)
    for c, t in zip(scan[1:], times):
        c["ms"] = 1e3 * t
    for c in scan:
        c["device_ms"] = device_ms(lambda R=c["R"]: edge_scan_loop(h, R), h)
    res["scan"] = scan
    res["scan_us_per_pass"] = per * 1e6
    res["scan_ns_per_edge"] = per / T * 1e9
    lo, hi = scan[1]["device_ms"], scan[2]["device_ms"]
    res["scan_device_us_per_pass"] = (
        None if lo is None or hi is None
        else (hi - lo) / (REPS[1] - REPS[0]) * 1e3)


def _tiled(dev, res, graphs, repeats, smem_rate) -> None:
    """K13c on each graph and on the all-staged small graph against its
    plain version and K1, timed beside K1 and cuSPARSE."""
    fail = res["failures"].append
    if graphs is None:
        graphs = probe_graphs(dev)
    Ms, Es, ns = SMALL
    small = community_graph(Ms, Es, n_comm=ns, seed=3, equal_sizes=True,
                            device=dev)
    tiled = []
    for gname, A in list(graphs.items()) + [(SMALL_NAME, small)]:
        rowptr, col, value = A.csr()
        x = torch.from_numpy(np.random.RandomState(2).randn(
            A.sparse_size(1), K).astype(np.float32)).to(dev)
        all_staged = A is small
        library = {}
        if not all_staged:  # cuSPARSE on the same matrix, with values
            csr_t = torch.sparse_csr_tensor(rowptr, col, value,
                                            A.sparse_sizes())
            library = {"library_ms": call_ms(lambda: csr_t @ x, x, repeats),
                       "library_device_ms": device_ms(lambda: csr_t @ x, x)}
            del csr_t
        # Each T with values and implicit ones; then, as a control, the
        # same kernel with no tile staged (every edge from device memory).
        cases = [(T_tile, v, None) for T_tile in TILES for v in (value, None)]
        cases.append((TILES[-1], value, col.shape[0] + 1))
        if all_staged:
            cases = [(64, v, 0) for v in (value, None)]
        for T_tile, v, stage_min in cases:
            r = tiled_vs_csr(rowptr, col, v, x, T_tile, stage_min=stage_min,
                             timed=not all_staged, repeats=repeats,
                             smem_rate=smem_rate)
            r["graph"] = gname
            r["no_staging"] = stage_min is not None and stage_min > r["E"]
            if v is not None:
                r.update(library)
            tiled.append(r)
            what = (f"tiled_spmm on {gname}, T={T_tile}, "
                    f"{'values' if v is not None else 'ones'}"
                    f"{', no tile staged' if r['no_staging'] else ''}")
            if all_staged and r["staged_pairs"] != r["pairs"]:
                fail(f"{what}: {r['staged_pairs']} of {r['pairs']} pairs "
                     "staged, want all")
            if not r["ok"]:
                fail(f"{what}: rel err {r['max_rel_err']:.3g} vs plain")
            if not r["equal_k1"]:
                fail(f"{what}: differs from csr_spmm")
            if "ms" in r:
                print(f"{what}: {r['ms']:.4f} ms ({_ms(r['device_ms'])} on "
                      f"the device), csr_spmm {r['k1_ms']:.4f} ms "
                      f"({_ms(r['k1_device_ms'])}); {r['staged_pairs']} of "
                      f"{r['pairs']} pairs staged "
                      f"({100 * r['staged_edge_share']:.1f}% of edges, "
                      f"{r['staged_bytes'] / 1e9:.3f} GB staged, shared "
                      f"memory floor {_ms(r['smem_floor_ms'])})", flush=True)
        del x
    res["tiled"] = tiled


def compare(a, b) -> Optional[str]:
    """``"beats"``, ``"ties with"`` or ``"loses to"``: time ``a`` against
    ``b``, a gap within :data:`TIE` of the larger being a tie; None where
    either is not measured."""
    if a is None or b is None:
        return None
    if abs(a - b) <= TIE * max(a, b):
        return "ties with"
    return "beats" if a < b else "loses to"


def compare_pairs(a, b) -> str:
    """:func:`compare` for times taken in alternating pairs, ``a[i]``
    beside ``b[i]``: ``"beats"`` where ``a`` is the faster in at least
    nine pairs of ten and its median is below ``b``'s by more than the
    distance between ``b``'s quartiles, ``"loses to"`` the other way
    round, else ``"ties with"``."""
    a, b = np.asarray(a), np.asarray(b)
    spread = np.subtract(*np.percentile(b, [75, 25]))
    gap = float(np.median(b) - np.median(a))
    if (a < b).sum() >= 0.9 * a.size and gap > spread:
        return "beats"
    if (a > b).sum() >= 0.9 * a.size and -gap > spread:
        return "loses to"
    return "ties with"


def _against(r: dict) -> dict:
    """A K13c case's times and their comparisons with K1 and cuSPARSE."""
    return {
        "T": r["T"], "slab": r["slab"], "ms": r["ms"],
        "device_ms": r["device_ms"],
        "staged_edge_share": r["staged_edge_share"],
        "smem_floor_ms": r["smem_floor_ms"],
        "k1": compare(r["ms"], r["k1_ms"]),
        "k1_device": compare(r["device_ms"], r["k1_device_ms"]),
        "library": compare(r["ms"], r.get("library_ms")),
        "library_device": compare(r["device_ms"],
                                  r.get("library_device_ms"))}


def verdict(res: dict, graph_names) -> dict:
    """Whether the big-table gather works, and how its call (over the
    alternating pairs, :func:`compare_pairs`) and its device time compare
    with ``index_select``'s; and for each graph how the staged SpMM at its
    best T (by device ms where measured, else call ms, among the cases
    that stage some edges; None where none does) and, apart, the walk
    with nothing staged compare with K1 and cuSPARSE, in call and in
    device ms."""
    big = next(c for c in res["gather"] if c["T"] == T)
    out = {"big_table_gather": all(c["exact"] for c in res["gather"]),
           "gather": {"T": T, "ms": big["ms"], "device_ms": big["device_ms"],
                      "library_ms": big["library_ms"],
                      "library_device_ms": big["library_device_ms"],
                      "pairs_won": big["pairs_won"],
                      "pairs": len(big["rounds_ms"]),
                      "library": compare_pairs(big["rounds_ms"],
                                               big["library_rounds_ms"]),
                      "library_device": compare(
                          big["device_ms"], big["library_device_ms"])},
           "graphs": {}}
    for gname in graph_names:
        rows = [r for r in res["tiled"] if r["graph"] == gname]
        staged = [r for r in rows if r["values"] and not r["no_staging"]
                  and r["staged_edge_share"] > 0]
        best = min(staged, default=None, key=lambda r: (
            r["ms"] if r["device_ms"] is None else r["device_ms"]))
        control = next(r for r in rows if r["no_staging"])
        out["graphs"][gname] = {
            "k1_ms": control["k1_ms"],
            "k1_device_ms": control["k1_device_ms"],
            "library_ms": control.get("library_ms"),
            "library_device_ms": control.get("library_device_ms"),
            "staged": None if best is None else _against(best),
            "no_staging": _against(control)}
    return out


def verdict_line(name: str, v: dict) -> str:
    def word(w):
        return w or "is not timed against"

    def walk(what, r):
        if r is None:
            return f"{what} stages no edge at any T"
        return (f"{what} (T={r['T']}, slab {r['slab']}, "
                f"{100 * r['staged_edge_share']:.1f}% of edges staged, "
                f"shared memory floor {_ms(r['smem_floor_ms'])}) takes "
                f"{r['ms']:.4f} ms a call and {_ms(r['device_ms'])} on the "
                f"device: it {word(r['k1'])} K1 a call and "
                f"{word(r['k1_device'])} it on the device, "
                f"{word(r['library'])} cuSPARSE a call and "
                f"{word(r['library_device'])} it on the device")

    g = v["gather"]
    head = (f"VERDICT ({name}; a gap within {100 * TIE:.0f}% is a tie): the "
            f"gather from a {T}-row table in shared memory "
            f"{'works and is exact' if v['big_table_gather'] else 'FAILS'}"
            f", {g['ms'] * 1e3:.2f} us a call ({_us(g['device_ms'])} on the "
            f"device) against index_select's {g['library_ms'] * 1e3:.2f} us "
            f"({_us(g['library_device_ms'])}), medians of {g['pairs']} "
            f"alternating pairs, of which it won {g['pairs_won']}: it "
            f"{word(g['library'])} it a call and "
            f"{word(g['library_device'])} it on the device")
    words = [
        f"on {gn} (K1 {r['k1_ms']:.4f} ms a call / {_ms(r['k1_device_ms'])} "
        f"on the device, cuSPARSE {_ms(r['library_ms'])} / "
        f"{_ms(r['library_device_ms'])}) "
        + walk("the staged SpMM", r["staged"]) + "; "
        + walk("the same walk with nothing staged", r["no_staging"])
        for gn, r in v["graphs"].items()]
    return head + "; " + "; ".join(words) + "."


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=PARTS, action="append",
                    help="run only this part (repeatable; default all)")
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_vmem_gather: no CUDA device is available",
              file=sys.stderr)
        return 1
    res = run("cuda", parts=tuple(args.only or PARTS))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    for f_ in res["failures"]:
        print("FAILED:", f_, file=sys.stderr)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
