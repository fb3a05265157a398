"""Read the correctness numbers of a cell's control or of a planted fault,
on the card, at the cell's own size:

    python bench_port/control.py --workload <cell> --seeds 11,12,13 --variant control

`control` puts the plain reference in the program's place, computed in the
precision below the cell's (TF32 for float32 with TF32 off, fp8 for
bfloat16: bench_port/reference/quant.py); `half_batch` puts the float32
reference there with each step (or evaluated batch) cut to its first half.
Each seed prints one JSON line with the numbers and whether the cell's
limits pass them. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    from bench_port.lib.harness import Cell, judge_stand_in

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--variant", choices=("control", "half_batch"), default="control")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = Cell(args.workload)
        runner = cell.entry().Runner(cell, seed, "cuda", False, print)
        runner.setup()
        numbers = runner.control(args.variant)
        correct, _ = judge_stand_in(numbers, cell.spec["limits"])
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "correct": correct, "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
