"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <name> [--workload ...] \\
        --seeds 11,12,... --control-seeds 21,22,23 [--seconds 3]

For each program seed: a run of the cell (its window ``--seconds`` long,
the check on the sampled steps as the benchmark makes it) and the worst
reading of each compared number. For each control seed: the plain
reference put in the program's place, in the precision below the cell's
(TF32 for f32 cells, fp8 e4m3 for bf16 cells), on the first
P-frames of the cell's GOP at the cell's own size, judged as a run's
sampled steps are. One JSON line per reading; all in one process, so the
program's kernels build once. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def control_readings(cell, seed, device="cuda", steps=2):
    """The control's records on the GOP's first ``steps`` P-frames (its own
    carry from the I-frame latent), judged by the cell's judge."""
    import torch

    from portbench import harness
    from portbench import reference as R

    st = harness.build(cell, seed, device)
    harness.drop_models(st)
    ref = harness.reference(cell, st)
    p = R.Precision(CONTROL[cell.traffic["dtype"]])
    judge = harness.find("judges", cell.traffic["judge"])
    out, y_cond = [], st.y_i
    with p.active():
        for k in range(1, steps + 1):
            rec, y_cond = judge.control(ref, st, k, y_cond, p)
            out.append(rec)
    readings = [judge.judge(ref, r) for r in out]
    if device == "cuda":
        torch.cuda.synchronize()
    return readings


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from portbench import harness
    from portbench import judge as J

    def ints(s):
        return [int(v) for v in s.split(",") if v]

    for name in args.workload:
        cell = harness.load_cell(name)
        for seed in ints(args.seeds):
            t = time.perf_counter()
            lines = []
            out = harness.run(cell, seed, args.seconds, False,
                              log=lambda *a: lines.append(" ".join(a)))
            print(json.dumps({
                "cell": name, "side": "program", "seed": seed,
                "correct": out["correct"],
                "readings": {k: v["value"] for k, v in out["checks"].items()},
                "log": [ln for ln in lines
                        if ln.startswith(("coded", "check"))],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "s": time.perf_counter() - t}), flush=True)
        for seed in ints(args.control_seeds):
            t = time.perf_counter()
            readings = control_readings(cell, seed)
            ok, worst = J.verdict(readings, cell.limits)
            print(json.dumps({
                "cell": name, "side": "control", "seed": seed,
                "correct": ok, "readings": worst,
                "s": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
