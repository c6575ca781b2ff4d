"""Run one cell of the port's benchmark once and print its result line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (movslam_tpu_torch) and
BENCHMARK.json. The cell names its configuration and traffic mix there
(slambench/harness/spec.py finds the files). --trace 0 prints the cell's
end-to-end metrics, --trace 1 its per-layer metrics from a profiled window.
The last line of standard output is one JSON object; the numbers the output
check compared, each with its limit, are the last lines of standard error
and the result's last key. Exits 2, printing no result, without a CUDA card
(or fewer than the cell asks for), and 3 when a module of JAX or of the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    from harness import cell as cellrun
    from harness import spec

    cell = spec.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {cell.chips} CUDA card(s); torch sees {n}", file=sys.stderr)
        return 2
    try:
        result, _ = cellrun.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    except cellrun.ImportGuardError as e:
        print(e, file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check: {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
