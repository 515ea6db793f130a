"""The control of a cell's comparison, and the program's readings beside
it, on several seeds in one process.

    python -m port_bench.control --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed it runs the cell as ``port_bench.run`` does (a short window
is enough) and prints one JSON line: the program's differing pixels over
the sampled frames (its reading) and the control's, the plain reference
computed in bfloat16, the nearest precision below the configuration's
float32, put in the program's place.  The comparison's limit is set
between the two readings: the control has to read above it on every
seed.  Needs a CUDA card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from port_bench import harness, spec  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        _, _, _, compared = harness.run(cell, seed, args.seconds, False,
                                        device, t0, control=CONTROL_DTYPE)
        print(json.dumps({"workload": cell.name, "seed": seed, **compared,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
