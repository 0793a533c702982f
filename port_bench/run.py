"""Run one cell of the benchmark once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

The run builds, from the seed and on the card, the cell's graph, node
features, labels, split masks and initial parameters; hands the port
the edge list as a user would (``SparseTensor(row=, col=)``,
``coalesce``, the model's ``prepare``); asks the router for each SpMM
width; then drives the cell's loop, one full-batch OGB epoch a step
(the masked loss, its backward, an Adam step, an eval forward, argmax
and the three accuracies read back once).  The first epochs are the
warm-up and the epochs the check reads; then epochs run for
``--seconds``.  With ``--trace 1`` a few epochs of the window run under
``torch.profiler`` with CUDA events around the forward and backward,
and after the window the public SpMM is timed at each of the model's
widths.  After the window the peak memory is read, the port's state is
freed, and the plain reference repeats the checked epochs from the
same inputs (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``, each number compared beside its
limit, which also end standard error.  Without a CUDA card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits with 2, 2
or 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from functools import partial  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
# Kernel caches at fixed places inside the checkout (the port's own nvcc
# builds land in its package's ``build/``, also inside the checkout).
CACHE = HERE / ".cache"
CACHE_VARS = (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
              ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"))


def log(*parts) -> None:
    print("[port_bench]", *parts, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def make_optimizer(model, cfg: Dict):
    import torch

    if cfg["optimizer"] != "adam":
        raise ValueError(f"unknown optimizer {cfg['optimizer']!r}")
    return torch.optim.Adam(model.parameters(), lr=float(cfg["lr"]))


def port_launches() -> Dict[str, int]:
    """Every ``<kernel>.launches`` counter of the port's kernel wrappers."""
    import importlib
    import pkgutil

    import pytorch_sparse_tpu_torch.ops.kernels as kpkg

    out = {}
    for info in pkgutil.iter_modules(kpkg.__path__):
        mod = importlib.import_module(f"{kpkg.__name__}.{info.name}")
        for name, obj in vars(mod).items():
            n = getattr(obj, "launches", None)
            if callable(obj) and isinstance(n, int):
                out[name] = n
    return out


def describe_route(adj) -> Dict:
    """The router's cached view: its kind, blocks and dense edges."""
    st = adj.storage
    h = st.hybrid(auto=False) if st.has_hybrid() else None
    nnz = int(adj.nnz())
    if h is None:
        return {"view": "csr", "blocks": 0, "dense_nnz": 0, "nnz": nnz}
    blocks = getattr(h, "blocks", None)
    return {"view": type(h).__name__, "blocks": int(getattr(h, "nb", 0)),
            "dense_nnz": int(getattr(h, "dense_nnz", nnz)), "nnz": nnz,
            "store_dtype": str(blocks.dtype if blocks is not None
                               else h.dense.dtype)}


def time_spmm(pt, adj, calls: List[Dict], device, seed: int,
              reps: int = 5) -> List[Dict]:
    """CUDA-event seconds of the public SpMM on ``adj`` at each call's
    width and reduction, forward, and backward (``A^T g``, through
    autograd) where the epoch needs it."""
    import torch

    from . import inputs

    M, N = adj.sparse_size(0), adj.sparse_size(1)
    valued = adj.storage.value() is not None
    g = inputs.generator(seed, "spmm_timing", device)
    out = []
    for c in calls:
        K = int(c["K"])
        x = torch.randn((N, K), generator=g, device=device)
        gout = torch.randn((M, K), generator=g, device=device)
        fn = partial(pt.matmul, adj, reduce=c["reduce"])
        fn(x)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            fn(x)
        ev[1].record()
        ev[1].synchronize()
        rec = {"K": K, "reduce": c["reduce"], "nnz": int(adj.nnz()),
               "M": M, "N": N, "valued": valued,
               "fwd_s": ev[0].elapsed_time(ev[1]) * 1e-3 / reps,
               "bwd_s": None}
        if c["backward"]:
            xr = x.clone().requires_grad_(True)
            y = fn(xr)
            torch.autograd.grad(y, xr, gout, retain_graph=True)
            ev[0].record()
            for _ in range(reps):
                torch.autograd.grad(y, xr, gout, retain_graph=True)
            ev[1].record()
            ev[1].synchronize()
            rec["bwd_s"] = ev[0].elapsed_time(ev[1]) * 1e-3 / reps
            del xr, y
        out.append(rec)
        del x, gout
    return out


class Run:
    """One run of one cell: set-up, the checked epochs, the window, and
    the check against the reference."""

    def __init__(self, c: Dict, seed: int, seconds: float, traced: bool,
                 device, t_start: float):
        import torch

        from . import spec

        self.torch = torch
        self.c, self.seed, self.seconds = c, int(seed), float(seconds)
        self.traced, self.device, self.t_start = traced, device, t_start
        self.cfg, self.traffic = c["config"], c["traffic"]
        self.ref = spec.load_module("reference", self.cfg["model"], c["root"])
        self.spans: Dict[str, float] = {}

    def sync(self) -> None:
        # Waiting before CUDA has started would start it outside the span.
        if self.device.type == "cuda" and self.torch.cuda.is_initialized():
            self.torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        self.sync()
        t = time.perf_counter()
        yield
        self.sync()
        self.spans[name] = time.perf_counter() - t

    # -- set-up --------------------------------------------------------
    def setup(self) -> None:
        torch = self.torch
        from . import inputs, spec
        from .reference import common as refc

        cfg, dev = self.cfg, self.device
        # The configuration computes in float32 with TF32 off, the port's
        # dense products too.
        refc.no_tf32()
        self.tf32 = {
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
        }
        with self.span("cuda_init"):
            torch.zeros(1, device=dev)
        with self.span("import_port"):
            import pytorch_sparse_tpu_torch as pt

            self.pt = pt
            self.mod = spec.load_module("models", cfg["model"], self.c["root"])
        with self.span("kernel_loads"):
            # The CSR kernel's library, through the public API on a tiny
            # matrix, forward and backward.
            idx = torch.arange(4, device=dev)
            tiny = pt.SparseTensor(row=idx, col=(idx + 1) % 4,
                                   sparse_sizes=(4, 4), device=dev)
            xt = torch.ones((4, 4), device=dev, requires_grad=True)
            pt.spmm_sum(tiny, xt).sum().backward()
        with self.span("graph_draw"):
            row, col = inputs.edges(cfg, self.traffic, self.seed, dev,
                                    self.c["root"])
            self.draw_nodes()
        self.draws = int(row.shape[0])
        with self.span("build"):
            A = pt.SparseTensor(row=row, col=col, sparse_sizes=(self.M, self.M),
                                device=dev)
            del row, col
            A = A.coalesce()
            self.adj = self.mod.prepare(A)
            del A
        self.calls = self.mod.spmm_calls(cfg)
        self.route_by_width = []
        with self.span("route_build"):
            for call in self.calls:
                h = self.adj.storage.hybrid(K_hint=int(call["K"]))
                self.route_by_width.append(
                    [int(call["K"]), "csr" if h is None else type(h).__name__,
                     int(getattr(h, "nb", 0))])
        self.route = describe_route(self.adj)
        with self.span("model"):
            self.model = self.mod.make(cfg, self.params0, dev)
        with self.span("optimizer"):
            self.opt = make_optimizer(self.model, cfg)
            self.gen = None
            if float(cfg.get("dropout", 0.0)) > 0.0:
                self.gen = torch.Generator(device=dev).manual_seed(
                    inputs.dropout_seed(self.seed))
            self.train_f = self.nodes["train_mask"].to(torch.float32)
            self.split_masks = [self.nodes[f"{s}_mask"]
                                for s in ("train", "valid", "test")]

    def draw_nodes(self) -> None:
        """Features, labels, masks and initial parameters from the seed."""
        from . import inputs

        self.M = int(self.cfg["dataset"]["nodes"])
        self.nodes = inputs.nodes(self.cfg, self.seed, self.device)
        self.params0 = inputs.glorot_params(
            self.ref.leaf_shapes(self.cfg), self.seed, self.device)

    # -- the timed path --------------------------------------------------
    def epoch(self, events=None):
        """One full-batch epoch; returns ``([loss, train, valid, test
        correct], pred)``, read back once."""
        torch = self.torch
        from . import check

        n = self.nodes
        self.opt.zero_grad(set_to_none=True)
        if events:
            events[0].record()
        loss = self.mod.train_loss(self.model, self.adj, n["x"], n["y"],
                                   self.train_f, self.cfg, self.gen)
        if events:
            events[1].record()
        loss.backward()
        if events:
            events[2].record()
        self.opt.step()
        with torch.no_grad():
            pred = check.preds_of(self.mod.logits(self.model, self.adj,
                                                  n["x"]))
            hit = pred.to(n["y"].dtype) == n["y"]
            counts = torch.stack([(hit & m).sum() for m in self.split_masks])
            vals = torch.cat([loss.detach().view(1).float(),
                              counts.float()]).tolist()
        return vals, pred

    def check_epochs(self) -> None:
        """The first epochs, through :meth:`epoch` itself: the warm-up of
        every shape, and the readings the check compares."""
        n = int(self.traffic["check_epochs"])
        prog = {"losses": [], "preds": [], "params": [], "grad1": None}
        self.check_epoch_s = []
        with self.span("check_epochs"):
            for i in range(n):
                t = time.perf_counter()
                vals, pred = self.epoch()
                self.check_epoch_s.append(time.perf_counter() - t)
                prog["losses"].append(vals[0])
                prog["preds"].append(pred)
                prog["params"].append(
                    {k: p.detach().clone()
                     for k, p in self.model.named_parameters()})
                if i == 0:
                    prog["grad1"] = self.first_gradient()
        prog["change"] = {k: p - self.params0[k]
                          for k, p in prog["params"][-1].items()}
        self.prog = prog

    def first_gradient(self) -> Dict:
        """The gradient of the first step as Adam holds it after the step,
        ``exp_avg / (1 - beta1)``; zeros where the optimizer holds
        nothing (it took no step)."""
        b1 = self.opt.param_groups[0]["betas"][0]
        out = {}
        for name, p in self.model.named_parameters():
            m = self.opt.state.get(p, {}).get("exp_avg")
            out[name] = (self.torch.zeros_like(p) if m is None
                         else m.detach() / (1.0 - b1))
        return out

    def window(self) -> Dict:
        torch = self.torch
        from . import trace

        skip = int(self.traffic.get("trace_skip_epochs", 2))
        n_tr = int(self.traffic.get("trace_epochs", 6))
        traced = range(skip, skip + n_tr) if self.traced else range(0)
        times, fwd, bwd, bad = [], [], [], 0
        self.trace: Dict = {}
        self.launch_deltas: Dict[str, int] = {}
        stack = contextlib.ExitStack()
        self.sync()
        t0 = time.perf_counter()
        deadline = t0 + self.seconds
        i = 0
        while True:
            events = None
            if i in traced:
                if i == traced.start:
                    self.sync()
                    launches0 = port_launches()
                    stack.enter_context(trace.profiled(self.device,
                                                       self.trace))
                if self.device.type == "cuda":
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(3)]
            ta = time.perf_counter()
            with (trace.epoch_range() if i in traced
                  else contextlib.nullcontext()):
                vals, _ = self.epoch(events)
            tb = time.perf_counter()
            if events:
                fwd.append(events[0].elapsed_time(events[1]))
                bwd.append(events[1].elapsed_time(events[2]))
            if i in traced and i == traced.stop - 1:
                stack.close()
                self.launch_deltas = {
                    k: v - launches0.get(k, 0)
                    for k, v in port_launches().items()
                    if v != launches0.get(k, 0)}
            times.append((i in traced, tb - ta))
            bad += 0 if math.isfinite(vals[0]) else 1
            self.last_vals = vals
            i += 1
            if tb >= deadline and i >= traced.stop:
                break
        return {"window_s": tb - t0, "epochs": i, "failed": bad,
                "times": [t for _, t in times],
                "untraced": [t for tr, t in times if not tr],
                "fwd_ms": fwd, "bwd_ms": bwd}

    # -- after the window ----------------------------------------------
    def free_program(self) -> None:
        for name in ("model", "opt", "adj", "gen"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, fault: Optional[str] = None
                  ) -> Dict:
        """The reference's readings of the checked epochs, from the same
        inputs (the edge list drawn again from the seed, once a run)."""
        torch = self.torch
        from . import inputs
        from .reference import common as refc

        if getattr(self, "ref_adj", None) is None:
            row, col = inputs.edges(self.cfg, self.traffic, self.seed,
                                    self.device, self.c["root"])
            self.ref_adj = self.ref.adjacency(row, col, self.M)
            del row, col
        gen = None
        if float(self.cfg.get("dropout", 0.0)) > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(
                inputs.dropout_seed(self.seed))
        return refc.train(
            partial(self.ref.forward, cfg=self.cfg), self.ref_adj,
            self.nodes["x"], self.nodes["y"], self.nodes["train_mask"],
            self.params0, float(self.cfg["lr"]),
            int(self.traffic["check_epochs"]), tf32=tf32, dropout_gen=gen,
            fault=fault)

    def judge_numbers(self, prog: Dict, ref: Dict) -> Dict:
        """:func:`check.numbers` of ``prog`` against ``ref``, each eval
        forward judged by the reference's at ``prog``'s own parameters
        after that epoch."""
        from . import check
        from .reference import common as refc

        fwd = partial(self.ref.forward, cfg=self.cfg)
        return check.numbers(prog, ref, lambda i: refc.eval_logits(
            fwd, self.ref_adj, self.nodes["x"], prog["params"][i]))


def run_cell(c: Dict, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> Dict:
    """One run of cell ``c`` (:func:`port_bench.spec.cell`) on
    ``device``: the result object, without the card check."""
    import torch

    from . import check, spec

    r = Run(c, seed, seconds, traced, device, t_start)
    r.spans["start"] = time.perf_counter() - t_start
    r.setup()
    r.check_epochs()
    setup_s = time.perf_counter() - t_start
    w = r.window()
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = {"spans": r.spans, "route": r.route, "setup_s": setup_s,
           "window": w, "peak_bytes": peak, "fwd_ms": w["fwd_ms"],
           "bwd_ms": w["bwd_ms"], "epoch_s_untraced": w["untraced"],
           "trace": r.trace, "cfg": r.cfg,
           "epoch_flops": r.mod.epoch_flops(r.cfg, r.M, int(r.adj.nnz()))}
    if traced and cuda:
        ctx["spmm"] = time_spmm(r.pt, r.adj, r.calls, device, r.seed)
    log("setup", json.dumps({k: round(v, 4) for k, v in r.spans.items()}),
        f"setup_s={setup_s:.4f}", "check epochs",
        [round(t, 4) for t in r.check_epoch_s])
    log("route", json.dumps(r.route), "by width", r.route_by_width,
        "draws", r.draws)
    log("tf32", json.dumps(r.tf32))
    if traced:
        log("launch_check", json.dumps({
            "port_launches": r.launch_deltas,
            "trace_kernels": r.trace.get("kernel_counts", {}),
            "trace_launch_calls": r.trace.get("launches")}))
        log("spmm_timing", json.dumps(ctx.get("spmm", [])))
    log("window", json.dumps({"epochs": w["epochs"],
                              "window_s": w["window_s"],
                              "last_epoch": r.last_vals}))

    r.free_program()
    t = time.perf_counter()
    nums = r.judge_numbers(r.prog, r.reference())
    correct, shown = check.judge(nums, c["limits"])
    log("reference_s", round(time.perf_counter() - t, 4), "numbers",
        json.dumps({k: nums[k] for k in check.NUMBERS}), "loss gaps",
        nums["loss_gaps"], "worst leaves", nums["grad_worst_leaf"],
        nums["change_worst_leaf"], "excluded", nums["excluded_leaves"],
        "sign flips", nums["sign_flips"])

    which = c["per_layer"] if traced else c["end_to_end"]
    metrics = {}
    for m in which:
        v = spec.load_module("metrics", m["name"], c["root"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": (torch.cuda.get_device_name(device) if cuda
                         else "cpu"),
                "count": int(c["workload"]["chips"]),
                "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and w["failed"] == 0),
              "attempted": w["epochs"], "failed": w["failed"],
              "metrics": metrics, "device": dev_info}
    if traced and r.trace.get("epochs"):
        dev_info["busy_s"] = r.trace["busy_s"]
        dev_info["window_s"] = r.trace["stretch_s"]
        result["breakdown"] = {"device_ops": r.trace["device_ops"],
                               "idle_gaps": r.trace["idle_gaps"]}
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_VARS:
        os.environ.setdefault(var, str(CACHE / sub))
    # The bytecode of every module imported from here on (torch's, and
    # torch._dynamo's, which the optimizer's first construction imports)
    # is written on a checkout's first run and read on the later ones,
    # also where the environment says to write none.
    sys.pycache_prefix = str(CACHE / "pyc")
    sys.dont_write_bytecode = False

    from . import spec

    c = spec.cell(spec.load_benchmark(), args.workload)
    import torch

    chips = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(c, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    log("card", card_line(), "torch", torch.__version__, torch.version.cuda)
    found = spec.forbidden_modules()
    if found:
        log("loaded after the window:", ", ".join(found))
        return 3
    for name, v in result["checks"].items():
        log(f"check {name} = {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
