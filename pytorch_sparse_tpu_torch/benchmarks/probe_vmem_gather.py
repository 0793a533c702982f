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
   T = 8, K = 128, against ``index_select``; the inputs are the JAX
   probe's (``RandomState(0)``).
2. :func:`_loop_time`: the edge-axis scan ``sum_{i<R} cumsum(h + i)``
   (K13b, ``edge_scan_loop``) at R = 8 and 40 inside one launch, and the
   time a pass as the slope between them (``h`` from ``RandomState(1)``).
3. :func:`tiled_vs_csr`: the design itself, K13c (``tiled_spmm``), X's
   row tiles staged in shared memory where a (row block, tile) pair holds
   enough edges, against the CSR kernel K1 (``csr_spmm``) on the same
   graph, bit for bit, and timed beside it.

Run it on one card (it fails without one)::

    python -m pytorch_sparse_tpu_torch.benchmarks.probe_vmem_gather [--out FILE]

It builds the ogbn-arxiv-scale uniform graph and the community hybrid
graph of ``chip_smoke.py``, prints each measurement, and ends with the
verdict: whether the big-table gather works on this card, and whether
the staged SpMM beats K1 on each graph.  :func:`run` returns the same
results as a dict (``chip_smoke.py`` phase 17 calls it with its own
graphs); every check it makes is listed under ``"failures"``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.kernels import csr_spmm
from ..ops.kernels.smem_gather import (
    edge_scan_loop, edge_scan_loop_plain, smem_gather, smem_gather_plain,
    tiled_spmm, tiled_spmm_plain, tiled_spmm_plan)
from ..tensor import SparseTensor
from ..testing import community_graph
from .timing import device_time

T = 2048    # edges per chunk
K = 128
REPS = (8, 40)
GATE = 1e-5                 # kernel vs plain version, relative to max |ref|
UNIFORM = (169_343, 1_166_243)             # ogbn-arxiv nodes and edges
HYBRID = (232_965, 16_000_000, 200)        # nodes, draws, communities
SMALL = (1_024, 50_000, 4)                 # the all-staged case, at T=64
TILES = (1024, 512, 256)    # K13c's tile heights (rows of X)


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


def probe_gather_restriction(device, repeats: int = 3) -> list:
    """The row gather from a table in shared memory at T = 2048 (the
    table the JAX probe could not gather from) and T = 8 (the one vreg
    it could), each against ``index_select``."""
    cases = []
    for idx, table in gather_inputs(device):
        got = smem_gather(idx, table)
        ref = smem_gather_plain(idx, table)
        abs_e, rel_e = _errors(got, ref)
        exact = bool(torch.equal(got, ref))
        n = table.shape[0]
        cases.append({
            "T": n, "K": K, "max_abs_err": abs_e, "max_rel_err": rel_e,
            "exact": exact,
            "ms": call_ms(lambda: smem_gather(idx, table), table, repeats),
            "plain_ms": call_ms(lambda: smem_gather_plain(idx, table),
                                table, repeats)})
        name = "big-table gather" if n == T else f"{n}-row window gather"
        print(f"{name} (T={n}, K={K}): {'works, exact' if exact else 'WRONG'}"
              f" (max err {abs_e}), {cases[-1]['ms'] * 1e3:.2f} us, "
              f"index_select {cases[-1]['plain_ms'] * 1e3:.2f} us",
              flush=True)
    return cases


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
                 repeats: int = 3) -> dict:
    """K13c on one CSR matrix against its plain version (within
    :data:`GATE`) and K1 (bit for bit), and both timed."""
    plan = tiled_spmm_plan(rowptr, col, x.shape[0], T=T_tile,
                           stage_min=stage_min)
    got = tiled_spmm(rowptr, col, value, x, plan)
    k1 = csr_spmm(rowptr, col, value, x)
    ref = tiled_spmm_plain(rowptr, col, value, x, plan)
    abs_e, rel_e = _errors(got, ref)
    E, Kx = col.shape[0], x.shape[1]
    res = {
        "T": T_tile, "stage_min": plan.stage_min, "K": Kx,
        "values": value is not None, "M": rowptr.shape[0] - 1, "E": E,
        "pairs": plan.n_pairs, "staged_pairs": plan.n_staged,
        "staged_edge_share": plan.staged_edges / max(E, 1),
        "staged_bytes": plan.staged_bytes(Kx),
        "direct_gather_bytes": (E - plan.staged_edges) * 4 * Kx,
        "k1_gather_bytes": E * (4 * Kx + (8 if value is not None else 4)),
        "smem_bytes": plan.smem_bytes(),
        "max_abs_err": abs_e, "max_rel_err": rel_e, "ok": rel_e <= GATE,
        "equal_k1": bool(torch.equal(got, k1))}
    if timed:
        res["ms"] = call_ms(lambda: tiled_spmm(rowptr, col, value, x, plan), x,
                        repeats)
        res["k1_ms"] = call_ms(lambda: csr_spmm(rowptr, col, value, x), x,
                           repeats)
        # The plain version takes a few launches a tile: a short chain.
        res["plain_ms"] = call_ms(
            lambda: tiled_spmm_plain(rowptr, col, value, x, plan), x, 1,
            n_lo=1, n_hi=3)
    return res


def run(device, graphs: Optional[Dict[str, SparseTensor]] = None,
        repeats: int = 3) -> dict:
    """Every measurement of the probe on ``device`` ("cuda", or "cpu"
    for the plain versions); ``graphs`` (default :func:`probe_graphs`)
    maps a name to a graph with values, whose structure also runs with
    implicit ones.  Failed checks are listed under ``"failures"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", flush=True)
    res = {"device": name, "failures": []}
    fail = res["failures"].append

    res["gather"] = probe_gather_restriction(dev, repeats)
    for c in res["gather"]:
        if not c["exact"]:
            fail(f"smem_gather at T={c['T']} differs from index_select")

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
    res["scan"] = scan
    res["scan_us_per_pass"] = per * 1e6
    res["scan_ns_per_edge"] = per / T * 1e9

    if graphs is None:
        graphs = probe_graphs(dev)
    Ms, Es, ns = SMALL
    small = community_graph(Ms, Es, n_comm=ns, seed=3, equal_sizes=True,
                            device=dev)
    tiled = []
    for gname, A in list(graphs.items()) + [("small, every pair staged",
                                             small)]:
        rowptr, col, value = A.csr()
        x = torch.from_numpy(np.random.RandomState(2).randn(
            A.sparse_size(1), K).astype(np.float32)).to(dev)
        all_staged = A is small
        # Each T with values and implicit ones; then, as a control, the
        # same kernel with no tile staged (every edge from device memory).
        cases = [(T_tile, v, None) for T_tile in TILES for v in (value, None)]
        cases.append((TILES[-1], value, col.shape[0] + 1))
        if all_staged:
            cases = [(64, v, 0) for v in (value, None)]
        for T_tile, v, stage_min in cases:
            r = tiled_vs_csr(rowptr, col, v, x, T_tile, stage_min=stage_min,
                             timed=not all_staged, repeats=repeats)
            r["graph"] = gname
            r["no_staging"] = stage_min is not None and stage_min > r["E"]
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
                print(f"{what}: {r['ms']:.4f} ms, csr_spmm "
                      f"{r['k1_ms']:.4f} ms; {r['staged_pairs']} of "
                      f"{r['pairs']} pairs staged "
                      f"({100 * r['staged_edge_share']:.1f}% of edges, "
                      f"{r['staged_bytes'] / 1e9:.3f} GB staged)", flush=True)
        del x
    res["tiled"] = tiled

    verdict = {"big_table_gather": all(c["exact"] for c in res["gather"]),
               "graphs": {}}
    for gname in graphs:
        best = min((r for r in tiled if r["graph"] == gname
                    and r["values"] and not r["no_staging"]),
                   key=lambda r: r["ms"])
        control = next(r for r in tiled if r["graph"] == gname
                       and r["no_staging"])
        verdict["graphs"][gname] = {
            "T": best["T"], "ms": best["ms"], "k1_ms": best["k1_ms"],
            "k1_over_tiled": best["k1_ms"] / best["ms"],
            "beats_k1": best["ms"] < best["k1_ms"],
            "no_staging_ms": control["ms"]}
    res["verdict"] = verdict
    words = "; ".join(
        f"on {g} the staged SpMM (T={v['T']}) takes {v['ms']:.4f} ms "
        f"against K1's {v['k1_ms']:.4f} ms, "
        + (f"{v['k1_over_tiled']:.2f}x faster" if v["beats_k1"]
           else f"{1 / v['k1_over_tiled']:.2f}x slower")
        + f" ({v['no_staging_ms']:.4f} ms with no tile staged)"
        for g, v in verdict["graphs"].items())
    print(f"VERDICT ({name}): the gather from a {T}-row table in shared "
          f"memory {'works and is exact' if verdict['big_table_gather'] else 'FAILS'}"
          f"; {words}.", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_vmem_gather: no CUDA device is available",
              file=sys.stderr)
        return 1
    res = run("cuda")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    for f_ in res["failures"]:
        print("FAILED:", f_, file=sys.stderr)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
