"""The readings that bound ``correct`` from above: the control and the
planted faults, each put in the program's place at the cell's own size
and held to the sound reference by the check's own numbers.

    python3 -m port_bench.control --workload <name> --seeds 11 12 13 \\
        [--out control.jsonl]

For every seed it draws the cell's inputs, runs the reference's checked
epochs (float32, TF32 off) and then, in the program's place:

- ``control``: the reference with every product's operands rounded to
  TF32, the nearest precision below the configuration's float32;
- ``half``: the loss taken over half of the training nodes;
- ``answer``: the sound reference's predictions with one node's class
  altered.

A step that leaves the state unchanged reads 1 in ``change_gap`` by the
check's measure and needs no run.  The benchmark's own runs never run
this.  It prints one JSON line a seed and variant.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

VARIANTS = ("control", "half", "answer")


def altered(prog: Dict, classes: int) -> Dict:
    """``prog`` with node 0's predicted class moved to the next one."""
    out = dict(prog)
    preds = [p.clone() for p in prog["preds"]]
    for p in preds:
        p[0] = (int(p[0]) + 1) % classes
    out["preds"] = preds
    return out


def readings(c: Dict, seed: int, device, variants=VARIANTS) -> List[Dict]:
    """One record a variant: the check's numbers and the seconds."""
    from . import check
    from .reference import common as refc
    from .run import Run

    refc.no_tf32()
    r = Run(c, seed, 0.0, False, device, time.perf_counter())
    r.draw_nodes()
    t = time.perf_counter()
    sound = r.reference()
    out = [{"seed": seed, "variant": "sound_reference",
            "seconds": time.perf_counter() - t}]
    classes = int(c["config"]["dataset"]["classes"])
    for v in variants:
        t = time.perf_counter()
        if v == "control":
            prog = r.reference(tf32=True)
        elif v == "half":
            prog = r.reference(fault="half")
        elif v == "answer":
            prog = altered(sound, classes)
        else:
            raise ValueError(f"unknown variant {v!r}")
        nums = r.judge_numbers(prog, sound)
        ok, _ = check.judge(nums, c["limits"])
        out.append({"seed": seed, "variant": v, "correct": ok,
                    "numbers": {k: nums[k] for k in check.NUMBERS},
                    "loss_gaps": nums["loss_gaps"],
                    "worst_leaves": [nums["grad_worst_leaf"],
                                     nums["change_worst_leaf"]],
                    "sign_flips": nums["sign_flips"],
                    "seconds": time.perf_counter() - t})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from . import spec

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    c = spec.cell(spec.load_benchmark(), args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            for rec in readings(c, seed, torch.device("cuda", 0),
                                args.variants):
                rec["workload"] = args.workload
                line = json.dumps(rec)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
