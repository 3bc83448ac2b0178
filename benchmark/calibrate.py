#!/usr/bin/env python3
"""Readings that the limits of a cell are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] [--faults NAME ...] [--seconds 2] \
        [--output FILE]

For each seed of ``--seeds``: set-up and a short window of the cell as a
run makes them, then the numbers compared (the lower reading is their
largest).  For each of ``--control-seeds``: the same set-up, then the plain
reference computed in fp8 put in the program's place (the upper reading).
For each of ``--fault-seeds``: each planted fault of the cell's driver (or
those named by ``--faults``), run through the same path.  ``--witness``: beside each control reading of a
training cell, the reference itself run in bf16 (what bf16 rounding alone
does to the numbers).  One JSON line per reading, on standard output and
appended to ``--output``.  Needs the card(s), as a run does."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--faults", nargs="*", help="the planted faults to run (default: all)")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--output")
    parser.add_argument("--witness", action="store_true",
                        help="with each control reading, the reference run in bf16 (training)")
    args = parser.parse_args()

    import torch

    from benchmark.harness.catalog import find_cell
    from benchmark.harness.cli import log

    cell = find_cell(args.workload)
    device = torch.device("cuda", 0)
    driver = cell.driver()

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        if args.output:
            with open(args.output, "a") as f:
                f.write(line + "\n")

    def reading(seed, kind, fault=None, control=False):
        t = time.perf_counter()
        session = driver.Session(cell, seed, device, log, fault=fault)
        session.setup()
        session.window(args.seconds, False)
        session.release()
        numbers = session.judge()
        emit({"cell": cell.name, "seed": seed, "kind": kind, "numbers": numbers,
              "seconds": time.perf_counter() - t})
        if control:
            emit({"cell": cell.name, "seed": seed, "kind": "control",
                  "numbers": session.judge(control=True)})
            if args.witness and hasattr(session, "reference_steps"):
                emit({"cell": cell.name, "seed": seed, "kind": "witness:bfloat16-reference",
                      "numbers": session.judge(control="bfloat16")})
        del session

    for seed in args.seeds:
        reading(seed, "program", control=seed in args.control_seeds)
    for seed in args.control_seeds:
        if seed not in args.seeds:
            reading(seed, "program", control=True)
    for seed in args.fault_seeds:
        for fault in args.faults or driver.FAULTS:
            reading(seed, f"fault:{fault}", fault=fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
