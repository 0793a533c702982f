"""``BENCHMARK.json`` against the contract's form, the pieces found by
name (a new file is picked up with no existing file edited), what the
benchmark's modules import, and the trace's reduction."""

import ast
import json
import shutil

import pytest
import torch

from port_bench import inputs, spec, trace

BENCH = spec.load_benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units_keep_to_the_contract():
    names = [m["name"] for m in METRICS] + [
        w["name"] for w in BENCH["workloads"]] + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        spec.check_name(n, "name")
    for w in BENCH["workloads"]:
        spec.check_name(w["config"], "config")
        spec.check_name(w["traffic"], "traffic")
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for m in METRICS:
        spec.check_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
    for bad in ("a b", "a/b", "é", "x" * 65, "", ".a"):
        with pytest.raises(ValueError):
            spec.check_name(bad, "name")
    for bad in ("tokens per s", "x" * 17, "µs"):
        with pytest.raises(ValueError):
            spec.check_unit(bad)


def test_every_entry_has_its_files_and_each_cell_its_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in METRICS:
        assert (spec.ROOT / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        c = spec.cell(BENCH, w["name"])
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2 and c["per_layer"]
        for m in c["per_layer"]:
            assert m["moves"] in names
        spec.load_module("models", c["config"]["model"])
        spec.load_module("reference", c["config"]["model"])
        spec.load_module("graphs", c["traffic"]["graph"])
    for cfg in BENCH["configs"]:
        with open(spec.REPO / cfg["file"]) as f:
            assert json.load(f)["reduced"] == cfg["reduced"]


def test_a_new_config_traffic_metric_and_cell_are_found_by_name(tmp_path):
    for kind in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(spec.ROOT / kind, tmp_path / kind)
    cfg = spec.load_json("configs", "gcn-products")
    cfg.update(name="gcn-arxiv", in_channels=128, out_channels=40)
    (tmp_path / "configs" / "gcn-arxiv.json").write_text(json.dumps(cfg))
    tr = spec.load_json("traffic", "shuffled")
    tr["name"] = "sparse-uniform"
    (tmp_path / "traffic" / "sparse-uniform.json").write_text(
        json.dumps(tr))
    (tmp_path / "cells" / "gcn-arxiv.sparse-uniform.json").write_text(
        json.dumps(spec.load_json("cells", "gcn-products.clustered")))
    (tmp_path / "metrics" / "view_checks.ms.py").write_text(
        "def read(ctx):\n    return ctx['spans'].get('view', 7.0)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "gcn-arxiv.sparse-uniform",
                               "config": "gcn-arxiv",
                               "traffic": "sparse-uniform", "chips": 1,
                               "why": "a new cell"})
    bench["per_layer"].append({"name": "view_checks.ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "Router", "moves": "epoch_ms",
                               "workloads": ["gcn-arxiv.sparse-uniform"]})
    c = spec.cell(bench, "gcn-arxiv.sparse-uniform", root=tmp_path)
    assert c["config"]["in_channels"] == 128
    assert c["traffic"]["name"] == "sparse-uniform"
    assert "view_checks.ms" in {m["name"] for m in c["per_layer"]}
    mod = spec.load_module("metrics", "view_checks.ms", root=tmp_path)
    assert mod.read({"spans": {}}) == 7.0
    other = spec.cell(bench, "gcn-products.clustered", root=tmp_path)
    assert "view_checks.ms" not in {m["name"] for m in other["per_layer"]}


@pytest.mark.parametrize("kind, key, value", [
    ("traffic", "loop", "sampled"), ("config", "dtype", "bfloat16"),
    ("config", "tf32", True), ("config", "tf32", 0),
    ("config", "dtype", None)])
def test_a_file_stating_what_the_harness_does_not_drive_is_refused(
        tmp_path, kind, key, value):
    for d in ("configs", "traffic", "cells"):
        shutil.copytree(spec.ROOT / d, tmp_path / d)
    w = BENCH["workloads"][0]
    name = w["config"] if kind == "config" else w["traffic"]
    path = tmp_path / ("configs" if kind == "config" else "traffic") / (
        name + ".json")
    data = json.loads(path.read_text())
    if value is None:
        del data[key]
    else:
        data[key] = value
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match=key):
        spec.cell(BENCH, w["name"], root=tmp_path)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def test_no_module_imports_jax_or_the_jax_package():
    files = list(spec.ROOT.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for name, level in _imports(f):
            if level == 0:
                assert name.split(".")[0] not in spec.FORBIDDEN_MODULES, f


def test_the_reference_imports_nothing_of_the_port():
    for f in (spec.ROOT / "reference").rglob("*.py"):
        for name, level in _imports(f):
            top = name.split(".")[0]
            assert top != "pytorch_sparse_tpu_torch", f
            # Within the benchmark, only the reference's own modules.
            assert level <= 1 and (level == 0 or top in ("", "common")), f


def test_forbidden_modules_compare_whole_top_level_names():
    assert spec.forbidden_modules(["pytorch_sparse_tpu_torch.ops",
                                   "jaxtyping", "torch"]) == []
    assert spec.forbidden_modules(["jax.numpy", "pytorch_sparse_tpu.ops",
                                   "flax"]) == ["flax", "jax",
                                                "pytorch_sparse_tpu"]


def test_stream_seeds_take_large_and_negative_seeds():
    seeds = {inputs.stream_seed(s, "graph")
             for s in (0, 1, 2**31 + 5, 2**40, -3, 2**70)}
    assert len(seeds) == 6 and all(0 <= s < 2**63 for s in seeds)
    assert inputs.stream_seed(5, "graph") != inputs.stream_seed(5, "x")


def test_the_generator_repeats_its_seed_and_stores_both_directions():
    gen = spec.load_module("graphs", "planted_communities")
    params = dict(communities=10, intra_share=0.8, hub_source_share=0.2,
                  hub_node_share=0.01, order="community")

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return gen.generate(g, 1000, 5000, params)

    r1, c1 = draw(3)
    r2, c2 = draw(3)
    assert torch.equal(r1, r2) and torch.equal(c1, c2)
    assert r1.shape == (10000,) and torch.equal(r1[:5000], c1[5000:])
    assert int(r1.max()) < 1000 and int(r1.min()) >= 0
    # Contiguous communities: most edges stay near the diagonal.
    near = ((r1 - c1).abs() < 250).float().mean()
    assert near > 0.75
    r3, c3 = draw(4)
    assert not torch.equal(r1, r3)


def test_the_trace_reduction_on_a_hand_made_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.EPOCH_RANGE,
         "ts": 0, "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": trace.EPOCH_RANGE,
         "ts": 100, "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 150,
         "dur": 50, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 2, "pid": 1, "tid": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 110, "dur": 2, "pid": 1, "tid": 7,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "void a::k<1>(int)",
         "ts": 20, "dur": 60, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "void a::k<2>(int)",
         "ts": 120, "dur": 20, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 130, "dur": 20, "pid": 0, "tid": 7},
    ]
    r = trace.reduce_events(ev)
    assert r["epochs"] == 2
    assert r["stretch_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx(90e-6)   # 20-80, 120-150
    assert r["launches"] == 2
    assert r["kernel_counts"] == {"a::k": 2}
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(50e-6)   # 150-200
    assert sum(gaps.values()) == pytest.approx(110e-6)
    ops = dict(r["device_ops"])
    assert ops["void a::k<1>(int)"] == pytest.approx(60e-6)
