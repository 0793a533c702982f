"""Finding the benchmark's pieces by name.

``BENCHMARK.json`` names the cells and metrics; each configuration,
traffic mix, generator, model, reference, metric reader and cell's
limits is a file under ``port_bench/`` named after its entry, so that a
new cell or metric is a new file and no existing one changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")

# What the harness drives and computes in: a configuration or traffic
# file that states anything else is refused, not run as something else.
SUPPORTED = (("traffic", "loop", ("full_batch_epoch",)),
             ("config", "dtype", ("float32",)),
             ("config", "tf32", (False,)))

# Top-level module names that no process of the benchmark may hold.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pytorch_sparse_tpu")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.fullmatch(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.fullmatch(unit):
        raise ValueError(f"unit {unit!r} is not a valid unit")
    return unit


def load_benchmark(path: Optional[Path] = None) -> Dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str, root: Path = ROOT) -> Dict:
    """``<root>/<kind>/<name>.json``."""
    check_name(name, kind)
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``<root>/<kind>/<name>.py``, loaded by path (a name may
    hold ``-`` and ``.``) once per process.  Under the package's own
    root it is ``port_bench.<kind>.<name>`` (``-`` and ``.`` as ``_``),
    so that its relative imports resolve."""
    check_name(name, kind)
    path = root / kind / f"{name}.py"
    safe = re.sub(r"[^A-Za-z0-9_]", "_", name)
    key = (f"port_bench.{kind}.{safe}" if root == ROOT
           else f"port_bench_{abs(hash(str(root)))}_{kind}_{safe}")
    mod = sys.modules.get(key)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(bench: Dict, workload: str, root: Path = ROOT) -> Dict:
    """Everything one cell needs: its entry, configuration, traffic mix,
    limits, and the metrics it reports (``end_to_end`` and ``per_layer``
    entries that list it, or that list no cells)."""
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if len(entries) != 1:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    w = entries[0]

    def reports(metric: Dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    files = {"config": load_json("configs", w["config"], root),
             "traffic": load_json("traffic", w["traffic"], root)}
    for kind, key, values in SUPPORTED:
        got = files[kind].get(key)
        if got not in values or type(got) is not type(values[0]):
            raise ValueError(f"{kind} {files[kind].get('name')!r}: {key} "
                             f"{got!r} is not one of {list(values)}")
    return {
        "workload": w,
        **files,
        "limits": load_json("cells", workload, root),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
        "root": root,
    }


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` (or ``modules``) that equal a
    forbidden name, compared whole: ``pytorch_sparse_tpu_torch`` is not
    ``pytorch_sparse_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                        else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))
