"""Run one benchmark cell once and print its result as the last line of
standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without the CUDA cards the cell
asks for, when the program (tpurt_torch) is missing, or when JAX or the
JAX package is loaded once the window has closed. The numbers the check
compared are the last lines of standard error and the last key of the
result.
"""

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def process_start() -> float:
    """perf_counter() at the moment this process started (Linux), or at
    the import of this file elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    import torch

    # one process with few threads: the wave loop is one host thread, and
    # idle pool threads only compete with it for the host's cores
    torch.set_num_threads(1)

    from perfbench import harness

    spec = harness.cell_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    try:
        import tpurt_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program is missing: {e}", file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), t_start)
    except harness.ForbiddenImport as e:
        print(f"perfbench: loaded once the window closed: {', '.join(e.args[0])}",
              file=sys.stderr)
        return 3
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: loaded once the window closed: {', '.join(bad)}", file=sys.stderr)
        return 3
    harness.log(f"card: {harness.card_and_power()}")
    print(f"correct={out['correct']}", file=sys.stderr)
    for name, n in out["check"].items():
        print(f"check {name}={n['value']!r} limit={n['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
