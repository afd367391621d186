"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration and traffic mix are found by the names in
``BENCHMARK.json``. The run casts the cell's course on the card from the
seed, warms the cell's shapes up on an instance of their own, measures for
``--seconds``, then judges the outputs against the plain reference. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the profiled slice's device busy time
and a breakdown. The last lines on stderr and the line's last key give
each compared number beside its limit. Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits 2.
"""

import time

T0 = time.perf_counter()  # set-up runs from here to the start of the window

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


class Env:
    """What an entry is given: the cell, the run's arguments, the device."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, t0: float):
        self.cell, self.seed, self.seconds, self.trace, self.device, self.t0 = cell, seed, seconds, trace, device, t0
        self.setup_s = None

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t0
        self.note("setup_s", self.setup_s)

    def note(self, key: str, value) -> None:
        """A diagnostic line on stderr (the checks come last, after these)."""
        print(f"note {key} {value}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_cache_env()
    cell = harness.find_cell(args.workload)
    import torch

    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: {args.workload} needs {need} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    print(f"note cuda_checked_s {time.perf_counter() - T0}", file=sys.stderr, flush=True)
    torch.set_num_threads(4)
    torch.set_float32_matmul_precision("highest")  # float32 products, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    env = Env(cell, args.seed % (1 << 63), args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    run = harness.entry(cell.mix["entry"]).run(env)

    found = harness.forbidden_loaded()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    line = harness.result_line(cell, run, run.device_extra, bool(args.trace))
    harness.print_checks(run)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
