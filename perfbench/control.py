"""Readings for the check's limits: runs a cell on several seeds in one
process and prints, for each, the program's `mismatch_share` (a sound
run's reading) beside the control's (the reference computed in bfloat16
in the program's place, at the same pixels, frames and launches).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

One JSON line per seed; the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from perfbench import harness

    torch.set_num_threads(1)

    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec["cell"]["chips"]):
        print("perfbench.control: not enough CUDA devices", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(spec, seed, args.seconds, False, time.perf_counter(),
                               control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "program": out["check"]["mismatch_share"]["value"],
                          "control": out["control"]["mismatch_share"],
                          "attempted": out["attempted"], "metrics": out["metrics"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
