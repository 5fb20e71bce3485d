"""The readings each cell's limits are set from, in one process per cell:

    python3 perfbench/readings.py --workload <cell> --seeds 12 --seed0 <n> \
        [--controls int8,int8_full] [--faults half_batch] [--seconds 2]

Sound runs of the program on ``--seeds`` seeds, then each control (the
program's int8 paths) and each fault of ``faults.py`` on three seeds, all
at the cell's own size and load with a short window. One JSON line per
run: the cell, the seed, the mode and every compared number. The limits in
``limits/<cell>.json`` sit between the largest sound reading and the
smallest that a control or a fault gives (PERF.md says which and why).
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--seed0", type=int, required=True)
    p.add_argument("--controls", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    table = faults.TRAIN if cell.traffic["driver"] == "train_step" \
        else faults.EMBED
    runs = [("sound", args.seed0 + i) for i in range(args.seeds)]
    for mode in filter(None, args.controls.split(",")
                       + args.faults.split(",")):
        runs += [(mode, args.seed0 + 1000 + 10 * len(runs) + i)
                 for i in range(3)]
    for mode, seed in runs:
        t0 = time.perf_counter()
        control = None if mode == "sound" or mode in table else mode
        plant = table[mode]() if mode in table else contextlib.nullcontext()
        with plant:
            out = harness.run(args.workload, seed, args.seconds, False,
                              control=control, log=lambda msg: None)
        print(json.dumps({"cell": args.workload, "seed": seed, "mode": mode,
                          "correct": out["correct"],
                          "wall_s": time.perf_counter() - t0,
                          **{k: v["value"] for k, v in
                             out["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
