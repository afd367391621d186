"""The control of a cell's ``correct``: the plain reference put in the
program's place one precision below the configuration's, judged as a run
is. Each number it reads is an upper reading for that number's limit.

    python3 portbench/control.py --workload <name> --frames <n> --seeds <s> [<s> ...]

One JSON line a seed: the control's readings beside the cell's limits.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    cell = harness.find_cell(args.workload)
    import torch

    from portbench.run import Env

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        env = Env(cell, seed % (1 << 63), 0.0, False, torch.device("cuda", 0), t0)
        readings = harness.entry(cell.mix["entry"]).control(env, args.frames)
        print(json.dumps({"workload": args.workload, "seed": seed, "frames": args.frames,
                          "readings": readings, "limits": cell.mix["limits"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
