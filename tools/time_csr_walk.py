"""Time the CSR walks on a CUDA card: ``csr_spmm`` (K1), ``shard_spmm``
(K11a), ``shard_spmm_minmax`` (K11b), ``minmax_spmm_t`` (K7b) and
``csr_spmm_minmax`` (K6), with two controls that bracket each, the
per-edge walks ``edge_dot`` (K4) and ``minmax_edge_dot`` (K7a) beside K1
on the same graphs, and the row sweep of ``edge_softmax`` (K8).

Usage (from the repo root; one card)::

    python tools/time_csr_walk.py [--root DIR] [--reps N] [--out FILE]
                                  [--edge-only | --minmax-softmax-only |
                                   --walk-scan-only]

``--root`` is the checkout whose ``pytorch_sparse_tpu_torch`` is
timed (default: this one), so that two commits can be compared in one
call on one card: unpack the other commit into a directory that
``.gitignore`` lists and run the script with each root in turns (parent,
change, change, parent).  Graphs, widths and seeds are
``chip_smoke.py``'s, taken from this checkout; only the public wrappers
are called, so an older tree runs as it is.  Each run prints the card's
``nvidia-smi`` name and power limit, then one JSON object (also written
to ``--out``) with a case per line of ``cases``:

* K1 on the uniform graph (ogbn-arxiv scale) at K = 1, 8, 40, 128 and
  256, on the community hybrid graph at K=128, and ``segment_sum_csr``
  (K1 over identity columns, K=1: ``gcn_norm``'s degree);
* K11a on shard 0 of the community hybrid graph over 4 ranks: the
  interior written and the halo frontier accumulated, at K = 20, 128 and
  256;
* K11b on the same shard: the interior's max written and the halo
  frontier's max combined into it, at K = 20, 128 and 256, and the
  cross-slice union's max combined into the interior's on shard 0 of the
  (2, 2) hierarchical layout at K = 256 and 20;
* K7b on the max argout of K6 (``csr_spmm_minmax``): the uniform graph
  at K = 40, 128 and 256, the community hybrid and Reddit-10% graphs at
  K=128;
* the controls at K=128 on the same pointers: ``resident`` (every
  gathered row index taken modulo 256, so the rows stay in L1: the
  walk's instruction floor) and ``scattered`` (one operand row per edge
  through a seeded permutation: no reuse, the L2/HBM ceiling), for K1 on
  the uniform graph and the community hybrid, K11a's and K11b's
  interior, and K7b on the uniform graph (its ``arg`` and ``g`` rows;
  the scattered rows are copies of each edge's own rows, so every edge
  wins what it won);
* K4 on the uniform graph at K = 8 (GAT's heads), 40, 128 and 256, on
  the community hybrid and Reddit-10% graphs at K=128, with the
  resident and scattered controls at K=128 on the uniform graph, and K1
  on Reddit-10% at K=128 (K1's uniform and community hybrid cases are
  above);
* K7a on the max argout of K6 on the uniform graph at K = 40, 128 and
  256 and on the community hybrid and Reddit-10% graphs at K=128;
* K6, max and min: the uniform graph at K = 40, 128 and 256, with
  implicit ones at K=128, with a bfloat16 operand at K=128, and the
  community hybrid and Reddit-10% graphs at K=128, with the resident and
  scattered controls of the max at K=128 on the uniform graph;
* K8 on GAT's graph (the uniform graph with self-loops, after
  ``gcn_norm``) and on the community hybrid graph, each at H = 8 and 1,
  and a control of the first rows of GAT's graph whose slab and output
  (16 MB) stay in L2, timed twice back to back: the sweep's instruction
  and latency floor.  Each K8 case counts ``rows_past_cap``, the rows
  beyond the instance's register cap, which sweep their slab three
  times.

``--edge-only`` stops after K4 and K7a (K1 and its controls come
first, K11a, K11b, K7b, K6 and K8 are left out): a quicker run for
comparing variants of the per-edge walk.  ``--minmax-softmax-only``
times K6 and K8 alone, for comparing their variants.
``--walk-scan-only`` times ``random_walk`` (K12) and ``edge_scan_loop``
(K13b) alone: K12 at PyG's Node2Vec configuration (the uniform graph,
L=20, 10 walks a node), on the uniform graph with every third row
emptied, and at GraphSAINT's length (L=3 from 20,000 roots), each beside
its byte bound and the count of its gathered sectors; K13b on the
probe's (2048, 128) ``h`` at R = 1, 8 and 40, with the slope a pass in
call and device ms, and, where the tree has ``launch_scan_instance``,
the streaming kernel on the same ``h`` at R = 8 and 40 as a variant.  It
records the SASS of every library of the tree.

Each case's ``ms`` is CUDA events around ``--reps`` launches after one
warm-up (the host's launch path where it is slower than the kernel);
``device_ms`` is the walk kernel's own time per launch from a
``torch.profiler`` trace of ``TRACE_CALLS`` calls, the mean over the
``device_events`` the trace holds (it sometimes drops some);
``bound_ms`` is the
operand-once bound (each input read once, the output written once, at
3.35 TB/s) and ``row_per_edge_ms`` the bound that reads one operand row
(K7b: one ``arg`` and one ``g`` row; K4, K7a and K6: one ``x`` row) per
edge.  ``digest`` is a SHA-1 of
the output's bytes (K11b: ``out`` then ``arg``) from one call on fresh
inputs, so that two trees' outputs can be compared bit for bit; ``sass``
a SHA-1 of each kernel's machine code (``cuobjdump -sass``), so that two
trees' builds of a kernel can be compared instruction for instruction.  Where
the tree has ``ops.kernels.csr_spmm.walk_instance``, each K1 and K11a
case names the instance that ran (vector width, lanes a row, rows a
warp, chunks a lane, column tiles); K11b, K7b, K4 and K7a name the
wrapper's own ``last_instance`` where it has one (K6, K8 too).
"""

import argparse
import hashlib
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESIDENT_ROWS = 256
TRACE_CALLS = 10
# The walk kernels' names in this tree and in older ones.
WALK_KERNEL = re.compile(r"walk_kernel|csr_spmm_kernel|shard_spmm_kernel|"
                         r"shard_minmax_kernel|minmax_spmm_t_kernel|"
                         r"edge_dot_kernel|csr_minmax|softmax_chunks_kernel|"
                         r"softmax_edges_kernel|edge_softmax_kernel|"
                         r"edge_softmax_generic_kernel")
L2_CONTROL_BYTES = 16 << 20   # K8's L2 control: slab and output
WALK_SCAN_KERNEL = re.compile(r"random_walk|edge_scan")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def digest(*tensors) -> str:
    """SHA-1 of the tensors' bytes, in order (16-bit floats as their
    bits)."""
    import torch

    h = hashlib.sha1()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        if t.is_floating_point() and t.element_size() == 2:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def ptxas_summary(log: str):
    """``[kernel, registers, spill line]`` for each kernel of a
    ``-Xptxas -v`` log (the kernel's mangled name)."""
    rows, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            rows.append([name, int(m.group(1)), ""])
        elif "spill" in ln and rows:
            rows[-1][2] = ln.split(":", 1)[-1].strip()
    return rows


def cuobjdump_path():
    """``cuobjdump`` of the CUDA toolkit, or None."""
    import shutil

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "cuobjdump")
    return cand if os.path.exists(cand) else shutil.which("cuobjdump")


def sass_digests(lib_path):
    """``{kernel: SHA-1 of its SASS}`` of a built library (``cuobjdump
    -sass``), the kernel's name with the anonymous namespace's per-file
    tag removed, so that two trees' builds of the same kernel compare
    equal where their machine code is the same; {} without cuobjdump."""
    import subprocess

    tool = cuobjdump_path()
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    out, name, body = {}, None, []
    for ln in text.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", ln)
        if m:
            if name is not None:
                out[name] = hashlib.sha1(
                    "\n".join(body).encode()).hexdigest()[:16]
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "",
                          m.group(1))
            body = []
        elif name is not None and "/*" in ln:
            body.append(" ".join(ln.split()))  # column widths vary
    return out


def kernel_instance(fn):
    """The instance the wrapper ``fn`` last launched, where it keeps
    one."""
    inst = getattr(fn, "last_instance", None)
    return None if inst is None else inst._asdict()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--edge-only", action="store_true",
                      help="time K1's uniform and community cases and the "
                           "per-edge walks (K4, K7a) only")
    only.add_argument("--minmax-softmax-only", action="store_true",
                      help="time K6 and K8 only")
    only.add_argument("--walk-scan-only", action="store_true",
                      help="time K12 and K13b only")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_csr_walk: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import pytorch_sparse_tpu_torch as ts
    from pytorch_sparse_tpu_torch import _build
    from pytorch_sparse_tpu_torch.models import gcn_norm
    from pytorch_sparse_tpu_torch.ops.kernels import (
        csr_spmm, csr_spmm_minmax, edge_dot, edge_softmax, minmax_edge_dot,
        minmax_spmm_t, shard_spmm, shard_spmm_minmax)
    from pytorch_sparse_tpu_torch.parallel import (
        HierShardedSparseMatrix, ShardedSparseMatrix, data_axis, dcn_axis)
    from pytorch_sparse_tpu_torch.segment import segment_sum_csr
    from pytorch_sparse_tpu_torch.testing import community_graph

    if os.path.dirname(ts.__file__) != os.path.join(root,
                                                    "pytorch_sparse_tpu_torch"):
        raise RuntimeError(f"imported {ts.__file__}, not from {root}")
    k1_module = sys.modules[csr_spmm.__module__]
    walk_instance = getattr(k1_module, "walk_instance", None)
    sweep_instance = getattr(sys.modules[edge_softmax.__module__],
                             "sweep_instance", None)

    device = torch.device("cuda")
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    res = {"root": root, "card": card, "torch": torch.__version__,
           "reps": args.reps, "cases": []}
    t0 = time.time()
    libs = ("csr_spmm", "shard_spmm", "spmm_minmax", "edge_dot",
            "edge_softmax")
    if args.walk_scan_only:
        libs = tuple(_build.SOURCES)
    _build.build(libs)
    res["build_s"] = time.time() - t0
    res["ptxas"] = {n: ptxas_summary(_build.build_log(n)) for n in libs}
    res["sass"] = {n: sass_digests(_build.library_path(n)) for n in libs}

    def timed(fn, kernel_name=WALK_KERNEL):
        """(CUDA-event ms a call, the kernel's device ms a launch, the
        launches the trace holds); the kernel's events are those whose
        name ``kernel_name`` matches.  The trace sometimes drops kernel
        events, so the device ms is the mean over the events it holds,
        not the sum over ``TRACE_CALLS``."""
        from torch.profiler import ProfilerActivity, profile

        ms = cs.time_ms(torch, fn, reps=args.reps)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_CALLS):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA" and kernel_name.search(e.key)]
        n = sum(e.count for e in evts)
        us = sum(_device_us(e) for e in evts)
        return ms, (us / 1e3 / n if n else 0.0), n

    def instance(k, *tensors):
        if walk_instance is None:
            return None
        aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
        return walk_instance(k, aligned)._asdict()

    def record(kernel, graph, k, times, bound, row_per_edge, R, E, inst,
               dig, **kw):
        ms, device_ms, events = times
        entry = {"kernel": kernel, "graph": graph, "K": k, "ms": ms,
                 "device_ms": device_ms, "device_events": events,
                 "bound_ms": bound[0],
                 "bound_by": bound[1], "row_per_edge_ms": row_per_edge,
                 "rows": R, "edges": E, "instance": inst, "digest": dig,
                 **kw}
        res["cases"].append(entry)
        print(json.dumps(entry), flush=True)

    def case(kernel, graph, k, fn, R, E, n_read, out_rows, has_value,
             accumulate=False, has_map=False, inst=None, minmax=False,
             has_pos=False, fresh=None, **kw):
        """A K1, K11a or K11b case: ``fn()`` is timed; the digest is of
        ``fresh()`` (a call on fresh outputs where ``fn`` accumulates or
        combines in place), else of ``fn()``."""
        got = (fresh or fn)()
        dig = digest(*(got if minmax else (got,)))
        if minmax:
            inst = kernel_instance(shard_spmm_minmax)
        bound = cs.shard_bounds(R, E, k, n_read, out_rows, has_value,
                                accumulate, has_map, minmax=minmax,
                                has_pos=has_pos)
        per_out = 2 if minmax else 1
        row_per_edge = cs.shard_row_per_edge_ms(R, E, k, out_rows * per_out,
                                                accumulate)
        record(kernel, graph, k, timed(fn), bound, row_per_edge, R, E, inst,
               dig, **kw)

    def controls(kernel, graph, rowptr, col, val, call, R, out_rows,
                 accumulate=False, has_map=False, **kw):
        """The resident and scattered controls of one walk at K=128:
        ``call(col, x)`` launches it."""
        E = col.shape[0]
        col_r = torch.remainder(col, RESIDENT_ROWS)
        x_r = cs.operand(torch, RESIDENT_ROWS, cs.K, 41, device)
        case(kernel, f"{graph}, control resident", cs.K,
             lambda: call(col_r, x_r), R, E, RESIDENT_ROWS, out_rows,
             val is not None, accumulate, has_map,
             instance(cs.K, x_r), **kw)
        del col_r, x_r
        gen = torch.Generator(device=device).manual_seed(42)
        col_s = torch.randperm(E, generator=gen, device=device).to(
            torch.int32)
        x_s = torch.randn((E, cs.K), generator=gen, device=device)
        case(kernel, f"{graph}, control scattered", cs.K,
             lambda: call(col_s, x_s), R, E, E, out_rows,
             val is not None, accumulate, has_map, instance(cs.K, x_s),
             **kw)
        del col_s, x_s
        torch.cuda.empty_cache()

    # ---- K6 and K8 ------------------------------------------------------
    def k6_case(graph, A, k, is_min, values=True, dtype=torch.float32,
                col_of=None, x_rows=None, seed=2):
        """K6 on ``A``'s structure at width ``k``; ``col_of(col)`` maps
        the gathered rows (the controls) into an operand of ``x_rows``
        rows."""
        rowptr, col, val = A.csr()
        val = val if values else None
        M = A.sparse_size(0)
        c = col if col_of is None else col_of(col)
        x = cs.operand(torch, x_rows or A.sparse_size(1), k, seed,
                       device).to(dtype)

        def fn():
            return csr_spmm_minmax(rowptr, c, val, x, is_min)
        dig = digest(*fn())
        E, elem = c.shape[0], x.element_size()
        bound = cs.minmax_bounds(M, E, k, int(torch.unique(c).numel()),
                                 val is not None, elem)
        row_per_edge = (4 * (M + 1) + 4 * E + (elem * E if values else 0)
                        + elem * k * E + (elem + 4) * M * k) \
            / cs.HBM_BYTES_PER_S * 1e3
        name = graph + (", min" if is_min else ", max") + \
            ("" if values else ", ones") + \
            ("" if dtype == torch.float32 else f", {dtype}".replace(
                "torch.", ""))
        record("csr_spmm_minmax", name, k, timed(fn), bound, row_per_edge,
               M, E, kernel_instance(csr_spmm_minmax), dig)

    def k8_case(graph, rowptr, H, repeat=1):
        """K8 over ``rowptr``'s rows at H heads, ``repeat`` times in a
        row (the L2 control)."""
        M = rowptr.shape[0] - 1
        E = int(rowptr[-1])
        logits = cs.operand(torch, E, H, 15, device) * 2.0

        def fn():
            return edge_softmax(rowptr, logits)
        dig = digest(fn())
        inst = kernel_instance(edge_softmax)
        past = None
        if sweep_instance is not None:
            si = sweep_instance(M, E, H, True)
            r64 = rowptr.long()
            units = ((r64[1:] * H + 3) // 4 - (r64[:-1] * H) // 4
                     if si.vec == 4 else r64[1:] - r64[:-1])
            past = int((units > si.lanes * si.chunks).sum())
        bound = ((4 * (M + 1) + 8 * E * H) / cs.HBM_BYTES_PER_S * 1e3,
                 "bytes")
        for i in range(repeat):
            label = graph if repeat == 1 else f"{graph}, run {i + 1}"
            record("edge_softmax", label, H, timed(fn), bound, None, M, E,
                   inst, dig, rows_past_cap=past)

    def k6_k8(A_u, A_h, A_r):
        for k in (40, 128, 256):
            for is_min in (False, True):
                k6_case("uniform", A_u, k, is_min)
        for is_min in (False, True):
            k6_case("uniform", A_u, cs.K, is_min, values=False)
            k6_case("uniform", A_u, cs.K, is_min, dtype=torch.bfloat16)
        k6_case("uniform, control resident", A_u, cs.K, False,
                col_of=lambda c: torch.remainder(c, RESIDENT_ROWS),
                x_rows=RESIDENT_ROWS, seed=41)
        gen = torch.Generator(device=device).manual_seed(42)
        k6_case("uniform, control scattered", A_u, cs.K, False,
                col_of=lambda c: torch.randperm(
                    c.shape[0], generator=gen, device=device).to(torch.int32),
                x_rows=A_u.nnz())
        torch.cuda.empty_cache()
        for graph, A_ in (("community hybrid", A_h),
                          ("community Reddit-10%", A_r)):
            for is_min in (False, True):
                k6_case(graph, A_, cs.K, is_min)
            torch.cuda.empty_cache()
        A_g = gcn_norm(cs.uniform_graph(ts, cs.UNIFORM[0], cs.UNIFORM[1],
                                        device, values=False))
        for graph, A_ in (("uniform + self-loops", A_g),
                          ("community hybrid", A_h)):
            for H in (8, 1):
                k8_case(graph, A_.storage.rowptr(), H)
        rowptr = A_g.storage.rowptr()
        H = 8
        R = min(int(torch.searchsorted(rowptr, L2_CONTROL_BYTES // (8 * H))),
                rowptr.shape[0] - 1)
        k8_case(f"uniform + self-loops, first {R} rows (in L2)",
                rowptr[:R + 1].contiguous(), H, repeat=2)
        del A_g
        torch.cuda.empty_cache()

    # ---- K12 and K13b ----------------------------------------------------
    def walk_scan(A_u):
        import numpy as np

        from pytorch_sparse_tpu_torch.benchmarks import probe_vmem_gather
        from pytorch_sparse_tpu_torch.ops.kernels import (
            edge_scan_loop, edge_scan_loop_plain, random_walk,
            random_walk_plain)

        def k12_case(graph, A, start, L, seed):
            rowptr, col = A.csr()[:2]
            rand = torch.rand((start.shape[0], L), device=device,
                              generator=torch.Generator(
                                  device=device).manual_seed(seed))

            def fn():
                return random_walk(rowptr, col, start, rand)
            got = fn()
            exact = bool(torch.equal(got, random_walk_plain(
                rowptr, col, start, rand)))
            sectors = cs.random_walk_gathered_sectors(rowptr, got)
            record("random_walk", graph, L, timed(fn, WALK_SCAN_KERNEL),
                   cs.random_walk_bounds(rowptr, got, rand), None,
                   start.shape[0], None, None, digest(got),
                   equal_plain=exact, gathered_sectors=sectors)

        Mu = A_u.sparse_size(0)
        L_w, per_node = cs.NODE2VEC
        n_roots, L_saint, _ = cs.SAINT
        every = torch.arange(Mu, dtype=torch.int32, device=device)
        k12_case("uniform, node2vec", A_u, every.repeat(per_node), L_w, 21)
        keep = np.flatnonzero(A_u.storage.numpy_view("row") % 3 != 0)
        A_sink = ts.SparseTensor(
            row=A_u.storage.numpy_view("row")[keep],
            col=A_u.storage.numpy_view("col")[keep], sparse_sizes=(Mu, Mu),
            is_sorted=True, trust_data=True, device=device)
        k12_case("uniform, every third row empty", A_sink, every, L_w, 22)
        del A_sink
        roots = torch.from_numpy(np.random.RandomState(23).randint(
            0, Mu, n_roots).astype(np.int32)).to(device)
        k12_case(f"uniform, {n_roots} roots", A_u, roots, L_saint, 24)
        torch.cuda.empty_cache()

        h = probe_vmem_gather.scan_input(device)
        T, K = h.shape
        module = sys.modules[edge_scan_loop.__module__]
        launch = getattr(module, "launch_scan_instance", None)

        def k13b_case(label, R, fn, inst=None):
            got = fn()
            inst = inst or kernel_instance(edge_scan_loop)
            err = cs.errors(got, edge_scan_loop_plain(h, R))
            times = timed(fn, WALK_SCAN_KERNEL)
            b = cs.edge_scan_bounds(T, K, R)
            record("edge_scan_loop", label, K, times,
                   (b["bound_ms"], b["bound_by"]), None, T, None, inst,
                   digest(got), passes=R, max_abs_err=err[0],
                   max_rel_err=err[1], bound_sum_ms=b["bound_sum_ms"],
                   pass_bound_us=b["pass_bound_us"])
            return times

        def slope(times, label, inst=None):
            (ms8, dev8, _), (ms40, dev40, _) = times
            entry = {"kernel": "edge_scan_loop", "graph": label,
                     "instance": inst, "us_per_pass": (ms40 - ms8) / 32 * 1e3,
                     "device_us_per_pass": (dev40 - dev8) / 32 * 1e3,
                     "pass_bound_us": cs.edge_scan_bounds(T, K, 1)[
                         "pass_bound_us"]}
            res["cases"].append(entry)
            print(json.dumps(entry), flush=True)

        times = {}
        for R in (1, 8, 40):
            times[R] = k13b_case(f"probe h, R={R}", R,
                                 lambda R=R: edge_scan_loop(h, R))
        slope((times[8], times[40]), "probe h, R=8 to R=40",
              kernel_instance(edge_scan_loop))
        if launch is None:
            return
        inst = module.ScanInstance(True, 1)
        pair = [k13b_case(f"probe h, R={R}, variant", R,
                          lambda R=R: launch(h, R, inst), inst._asdict())
                for R in (8, 40)]
        slope(pair, "probe h, R=8 to R=40, variant", inst._asdict())

    # ---- K1: the uniform graph ------------------------------------------
    Mu, Eu = cs.UNIFORM
    A_u = cs.uniform_graph(ts, Mu, Eu, device)
    if args.walk_scan_only:
        walk_scan(A_u)
        return finish(res, args.out)
    if args.minmax_softmax_only:
        Mh, Eh, nh = cs.HYBRID
        Mr, Er, nr = cs.REDDIT10
        k6_k8(A_u,
              community_graph(Mh, Eh, n_comm=nh, seed=1, equal_sizes=True,
                              device=device),
              community_graph(Mr, Er, n_comm=nr, seed=1, equal_sizes=True,
                              device=device))
        return finish(res, args.out)
    rowptr, col, val = A_u.csr()
    n_u = int(torch.unique(col).numel())
    for k in (1, 8, 40, 128, 256):
        x = cs.operand(torch, Mu, k, 2, device)
        case("csr_spmm", "uniform", k,
             lambda: csr_spmm(rowptr, col, val, x), Mu, Eu, n_u, Mu,
             True, inst=instance(k, x))
        del x
    w = cs.operand(torch, Eu, 1, 3, device).reshape(Eu)
    case("csr_spmm", "uniform, segment_sum_csr (identity columns)", 1,
         lambda: segment_sum_csr(w, rowptr), Mu, Eu, Eu, Mu, False,
         inst=instance(1, w))
    del w
    controls("csr_spmm", "uniform", rowptr, col, val,
             lambda c, x: csr_spmm(rowptr, c, val, x), Mu, Mu)
    del rowptr, col, val

    # ---- K1: the community hybrid graph ---------------------------------
    Mh, Eh, nh = cs.HYBRID
    A_h = community_graph(Mh, Eh, n_comm=nh, seed=1, equal_sizes=True,
                          device=device)
    rowptr, col, val = A_h.csr()
    x = cs.operand(torch, Mh, cs.K, 2, device)
    case("csr_spmm", "community hybrid", cs.K,
         lambda: csr_spmm(rowptr, col, val, x), Mh, A_h.nnz(),
         int(torch.unique(col).numel()), Mh, True, inst=instance(cs.K, x))
    del x
    controls("csr_spmm", "community hybrid", rowptr, col, val,
             lambda c, x: csr_spmm(rowptr, c, val, x), Mh, Mh)
    del rowptr, col, val

    Mr, Er, nr = cs.REDDIT10
    A_r = community_graph(Mr, Er, n_comm=nr, seed=1, equal_sizes=True,
                          device=device)

    # ---- K4 and K7a: the per-edge walks, beside K1 -----------------------
    def edge_row_per_edge_ms(M, E, k):
        """One x row per edge, g (K7a: and arg) once, the structure and
        the (E,) output once."""
        nbytes = 4 * (M + 1) + 8 * E + 4 * k * E + 4 * M * k
        return nbytes / cs.HBM_BYTES_PER_S * 1e3

    def k4_case(graph, A, k, col_of=None, x_rows=None, seed=2):
        """K4 on ``A``'s structure at width ``k``; ``col_of(col)`` maps the
        gathered rows (the controls) into an operand of ``x_rows`` rows."""
        rowptr, col = A.csr()[:2]
        M = A.sparse_size(0)
        n_x = x_rows or A.sparse_size(1)
        c = col if col_of is None else col_of(col)
        x = cs.operand(torch, n_x, k, seed, device)
        g = cs.operand(torch, M, k, 4, device)

        def fn():
            return edge_dot(rowptr, c, x, g)
        dig = digest(fn())
        bound = cs.csr_bounds(M, c.shape[0], k, int(torch.unique(c).numel()),
                              True)
        record("edge_dot", graph, k, timed(fn), bound,
               edge_row_per_edge_ms(M, c.shape[0], k), M, c.shape[0],
               kernel_instance(edge_dot), dig)

    def k7a_case(graph, A, k):
        rowptr, col, val = A.csr()
        M, N = A.sparse_sizes()
        x = cs.operand(torch, N, k, 2, device)
        _, arg = csr_spmm_minmax(rowptr, col, val, x, False)
        g = cs.operand(torch, M, k, 4, device)

        def fn():
            return minmax_edge_dot(rowptr, col, x, g, arg)
        dig = digest(fn())
        bound = cs.minmax_bwd_bounds(torch, col, arg, N, val is not None)[0]
        record("minmax_edge_dot", graph, k, timed(fn), bound,
               edge_row_per_edge_ms(M, col.shape[0], k), M, col.shape[0],
               kernel_instance(minmax_edge_dot), dig)

    for k in (8, 40, 128, 256):
        k4_case("uniform", A_u, k)
    k4_case("uniform, control resident", A_u, cs.K,
            col_of=lambda c: torch.remainder(c, RESIDENT_ROWS),
            x_rows=RESIDENT_ROWS, seed=41)
    gen = torch.Generator(device=device).manual_seed(42)
    k4_case("uniform, control scattered", A_u, cs.K,
            col_of=lambda c: torch.randperm(
                c.shape[0], generator=gen, device=device).to(torch.int32),
            x_rows=Eu)
    torch.cuda.empty_cache()
    for k in (40, 128, 256):
        k7a_case("uniform", A_u, k)
    torch.cuda.empty_cache()
    rowptr, col, val = A_r.csr()
    x = cs.operand(torch, Mr, cs.K, 2, device)
    case("csr_spmm", "community Reddit-10%", cs.K,
         lambda: csr_spmm(rowptr, col, val, x), Mr, A_r.nnz(),
         int(torch.unique(col).numel()), Mr, True, inst=instance(cs.K, x))
    del x, rowptr, col, val
    for graph, A_ in (("community hybrid", A_h),
                      ("community Reddit-10%", A_r)):
        k4_case(graph, A_, cs.K)
        k7a_case(graph, A_, cs.K)
        torch.cuda.empty_cache()
    if args.edge_only:
        return finish(res, args.out)

    # ---- K11a: shard 0 of the community hybrid graph over 4 ranks -------
    shard0 = ShardedSparseMatrix.from_sparse_tensor(
        A_h, cs.HostMesh(cs.DIST_WORLD, 0, device))
    hl0 = shard0._halo
    it0, fr0 = hl0.interior, hl0.frontier
    Mb0, Nb0, PH0 = shard0.Mb, shard0.Nb, cs.DIST_WORLD * hl0.H
    for k in (20, 128, 256):
        xb0 = cs.operand(torch, Nb0, k, 31, device)
        halo0 = cs.operand(torch, PH0, k, 32, device)
        base = cs.operand(torch, Mb0, k, 33, device)
        for label, grp, buf, acc in (("interior, write", it0, xb0, None),
                                     ("halo frontier, accumulate", fr0,
                                      halo0, base)):
            R_ = grp.rowptr.shape[0] - 1
            out_t = None if acc is None else acc.clone()
            if out_t is None:
                fn = (lambda grp=grp, buf=buf: shard_spmm(
                    grp.rowptr, grp.col, grp.value, buf,
                    row_map=grp.row_map, n_rows=Mb0))
            else:
                fn = (lambda grp=grp, buf=buf, out_t=out_t: shard_spmm(
                    grp.rowptr, grp.col, grp.value, buf, out=out_t,
                    row_map=grp.row_map))
            fresh = (None if acc is None else
                     lambda grp=grp, buf=buf, acc=acc: shard_spmm(
                         grp.rowptr, grp.col, grp.value, buf,
                         out=acc.clone(), row_map=grp.row_map))
            case("shard_spmm", f"shard 0 {label}", k, fn, R_,
                 grp.nnz, int(torch.unique(grp.col).numel()), R_,
                 grp.value is not None, acc is not None,
                 grp.row_map is not None,
                 inst=instance(k, buf, *(() if out_t is None else (out_t,))),
                 fresh=fresh)
            del out_t
        del xb0, halo0, base
    grp = it0
    controls("shard_spmm", "shard 0 interior, write", grp.rowptr, grp.col,
             grp.value,
             lambda c, x: shard_spmm(grp.rowptr, c, grp.value, x,
                                     row_map=grp.row_map, n_rows=Mb0),
             grp.rowptr.shape[0] - 1, grp.rowptr.shape[0] - 1,
             has_map=grp.row_map is not None)

    # ---- K11b: the same shard's max, and the hierarchical union ---------
    e0 = shard0.e0

    def minmax_case(label, grp, buf, k, into=None, **kw):
        """K11b on ``grp`` against ``buf``: written (``into`` None) or
        combined into a copy of the running pair ``into``."""
        R_ = grp.rowptr.shape[0] - 1
        sargs = (grp.rowptr, grp.col, grp.value, buf, False)
        if into is None:
            def fn():
                return shard_spmm_minmax(*sargs, e0, pos=grp.pos,
                                         row_map=grp.row_map, n_rows=Mb0)
            fresh = None
        else:
            o_t, a_t = into[0].clone(), into[1].clone()

            def fn():
                return shard_spmm_minmax(*sargs, e0, pos=grp.pos, out=o_t,
                                         arg=a_t, row_map=grp.row_map)

            def fresh():
                return shard_spmm_minmax(*sargs, e0, pos=grp.pos,
                                         out=into[0].clone(),
                                         arg=into[1].clone(),
                                         row_map=grp.row_map)
        case("shard_spmm_minmax", label, k, fn, R_, grp.nnz,
             int(torch.unique(grp.col).numel()), R_, grp.value is not None,
             into is not None, grp.row_map is not None, minmax=True,
             has_pos=grp.pos is not None, fresh=fresh, **kw)

    for k in (20, 128, 256):
        xb0 = cs.operand(torch, Nb0, k, 31, device)
        halo0 = cs.operand(torch, PH0, k, 32, device)
        running = shard_spmm_minmax(it0.rowptr, it0.col, it0.value, xb0,
                                    False, e0, pos=it0.pos,
                                    row_map=it0.row_map, n_rows=Mb0)
        minmax_case("shard 0 interior max, write", it0, xb0, k)
        minmax_case("shard 0 halo frontier max, combine", fr0, halo0, k,
                    into=running)
        del xb0, halo0, running
    grp = it0
    controls("shard_spmm_minmax", "shard 0 interior max, write", grp.rowptr,
             grp.col, grp.value,
             lambda c, x: shard_spmm_minmax(
                 grp.rowptr, c, grp.value, x, False, e0, pos=grp.pos,
                 row_map=grp.row_map, n_rows=Mb0),
             grp.rowptr.shape[0] - 1, grp.rowptr.shape[0] - 1,
             has_map=grp.row_map is not None, minmax=True,
             has_pos=grp.pos is not None)
    del shard0, hl0, it0, fr0
    hs0 = HierShardedSparseMatrix.from_sparse_tensor(
        A_h, cs.HostGrid((dcn_axis, data_axis), cs.HIER_GRID, 0, device))
    ht0 = hs0._tables
    hint, union = ht0.group(0), ht0.group(2)
    e0, Mb0 = hs0.e0, hs0.Mb
    for k in (256, cs.K2D_SLICE):
        xb0 = cs.operand(torch, hs0.Nb, k, 31, device)
        buf = cs.operand(torch, ht0.sizes[2], k, 36, device)
        running = shard_spmm_minmax(hint.rowptr, hint.col, hint.value, xb0,
                                    False, e0, pos=hint.pos)
        minmax_case("hier (2, 2) shard 0 cross-slice union max, combine",
                    union, buf, k, into=running,
                    buffer_rows=ht0.sizes[2])
        del xb0, buf, running
    del hs0, ht0, hint, union
    torch.cuda.empty_cache()

    # ---- K7b: the backward of K6's max argout over the CSC view ---------
    def k7b_bounds(N, E, k, has_value):
        """K7b's row-per-edge yardstick: one arg row and one g row per
        edge, the CSC indices, the values and the output once."""
        nbytes = 4 * (N + 1) + 8 * E + (4 * E if has_value else 0) \
            + 8 * k * E + 4 * N * k
        return nbytes / cs.HBM_BYTES_PER_S * 1e3

    def k7b_case(graph, t_args, N, k, col, **kw):
        colptr, csc_row, csr2csc, val, g, arg = t_args
        E = csc_row.shape[0]

        def fn():
            return minmax_spmm_t(*t_args)
        dig = digest(fn())
        bound = cs.minmax_bwd_bounds(torch, col, arg, N, val is not None)[1]
        record("minmax_spmm_t", graph, k, timed(fn), bound,
               k7b_bounds(N, E, k, val is not None), N, E,
               kernel_instance(minmax_spmm_t), dig, **kw)

    def k7b_inputs(A, k):
        rowptr, col, val = A.csr()
        st = A.storage
        m_, n_ = A.sparse_sizes()
        x = cs.operand(torch, n_, k, 2, device)
        _, arg = csr_spmm_minmax(rowptr, col, val, x, False)
        g = cs.operand(torch, m_, k, 4, device)
        return (st.colptr(), st.csc_row(), st.csr2csc(), val, g, arg), n_, col

    for k in (40, 128, 256):
        t_args, n_, col = k7b_inputs(A_u, k)
        k7b_case("uniform", t_args, n_, k, col)
        if k == cs.K:
            colptr, csc_row, csr2csc, val, g, arg = t_args
            rows_r = torch.remainder(csc_row, RESIDENT_ROWS)
            k7b_case("uniform, control resident", (colptr, rows_r, csr2csc,
                                                    val, g, arg), n_, k, col)
            del rows_r
            # Each CSC position p reads its own copy of its row's arg and
            # g: the same wins and sums, every row read once.
            E = csc_row.shape[0]
            gen = torch.Generator(device=device).manual_seed(42)
            perm = torch.randperm(E, generator=gen, device=device)
            arg_s = torch.empty((E, k), dtype=arg.dtype, device=device)
            g_s = torch.empty((E, k), dtype=g.dtype, device=device)
            arg_s[perm] = arg[csc_row.long()]
            g_s[perm] = g[csc_row.long()]
            k7b_case("uniform, control scattered",
                     (colptr, perm.to(torch.int32), csr2csc, val, g_s,
                      arg_s), n_, k, col)
            del perm, arg_s, g_s
        del t_args
        torch.cuda.empty_cache()
    t_args, n_, col = k7b_inputs(A_h, cs.K)
    k7b_case("community hybrid", t_args, n_, cs.K, col)
    del t_args
    torch.cuda.empty_cache()
    t_args, n_, col = k7b_inputs(A_r, cs.K)
    k7b_case("community Reddit-10%", t_args, n_, cs.K, col)
    del t_args
    torch.cuda.empty_cache()

    k6_k8(A_u, A_h, A_r)
    del A_u, A_r, A_h
    return finish(res, args.out)


def finish(res, out) -> int:
    """Print the result as one JSON line, and write it to ``out``."""
    line = json.dumps(res)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
