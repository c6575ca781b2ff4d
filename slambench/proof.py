"""Readings that the limits of a cell's output check are set from, in one
process on the card (the benchmark's own runs never run this):

    python3 slambench/proof.py --workload <cell> --seconds <s> --seeds 1,2,3 \\
        [--plants frozen,halved,altered,control --plant-seeds 4,5,6] [--tf32] [--out FILE]

Runs the cell once per seed as run.py does (the lower readings: the
program's numbers), then once per plant and plant seed with that fault or
the control planted after the warm-up (harness/faults.py: the upper
readings). Where the port still runs under a plant (the control, `halved`,
`altered`), the port's own answers are judged too, under `port_numbers`
(frames the tracker marked lost are not left out there). --tf32 lets the
card's matmuls round to TF32 in every run (the port turns TF32 off when
it is imported): the port's own lower-precision path. Prints one JSON line
per run and appends it to FILE.
"""
import argparse
import collections
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _recording(plant, store):
    """`plant`, with the port's own answers kept in store["answers"] and the
    ground truth in store["gt"]."""
    from harness import port

    def planted(system, gt):
        entry = port.batch_entry(system)
        batch = getattr(system, entry)
        handed = collections.deque()
        answers = store["answers"] = {}
        store["gt"] = gt

        def recorded(items, flush=True):
            handed.extend(it[1].frame_no for it in items)
            out = batch(items, flush=flush)
            for pose in out:
                answers[handed.popleft()] = pose
            return out

        setattr(system, entry, recorded)
        plant(system, gt)
    return planted


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--plants", default="")
    ap.add_argument("--plant-seeds", default="")
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    from harness import cell as cellrun
    from harness import faults, reference, spec

    if args.tf32:
        import movslam_tpu_torch  # noqa: F401  (it sets TF32 off)
        import torch

        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    cell = spec.load(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    runs = [(seed, None) for seed in ints(args.seeds)]
    runs += [(seed, p) for p in args.plants.split(",") if p for seed in ints(args.plant_seeds)]
    for seed, name in runs:
        store = {}
        plant = _recording(faults.plant(cell, name, args.seconds), store) if name else None
        t0 = time.perf_counter()
        result, numbers = cellrun.run(cell, seed, args.seconds, False, t0, plant=plant)
        line = {"workload": cell.name, "seed": seed, "plant": name, "tf32": args.tf32, "numbers": numbers,
                "correct": result["correct"], "attempted": result["attempted"],
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
        if store.get("answers"):
            line["port_numbers"] = reference.judge(store["gt"], store["answers"], list(store["answers"]))
        line = json.dumps(line)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
