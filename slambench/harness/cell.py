"""One run of one cell: set-up, the measured window, the output check.

Set-up renders the frames, builds the port's System, runs the drive's
warm-up, then collects the host's garbage and freezes what is left, so that
no collection in the window walks the set-up's frames. The window runs the
drive for `seconds`, from the first frame handed to the port to the last
pose returned, ending in a device synchronize. Once it has closed, the peak
memory is read, the port's state is freed, the import guard looks at
sys.modules, and the reference judges every answer due in the window.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import math
import sys
import time

from traffic import render

from . import guard, port, reference, spec


def frames_needed(cell, seconds):
    """Warm-up frames at most, plus the frames the window can use: the
    camera's over `seconds`, or fewer where the traffic mix caps the rate
    (`render_per_s`: about twice the best rate a drive of the mix reached;
    a drive that outruns it ends its window at the last frame)."""
    rule = cell.mix["warmup"]
    warm = rule.get("max_frames", rule.get("frames"))
    rate = min(float(cell.config["camera"]["fps"]), float(cell.mix.get("render_per_s", math.inf)))
    return int(warm) + math.ceil(seconds * rate)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def _nospan(name):
    yield


def _span(name):
    from torch.profiler import record_function

    return record_function("slambench." + name)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed, seconds, trace, t_start, device="cuda", plant=None):
    """Run `cell` once. plant(system, gt), when given, is called after the
    warm-up: tests and the limit readings use it to break the timed path
    or to put the reference in the program's place. Returns the result
    dict (the last line's keys) and the compared numbers."""
    import torch

    clock = time.perf_counter
    config, mix, drive = cell.config, cell.mix, cell.drive
    if trace:
        from .trace import TRACE_SECONDS

        seconds = min(seconds, TRACE_SECONDS)
    fps = float(config["camera"]["fps"])
    n = frames_needed(cell, seconds)
    t0 = clock()
    frames = render.frames(config, mix, seed, n)
    log(f"frames: {n} rendered in {clock() - t0:.3f} s")
    feed = port.inputs(frames, config)
    gt = {k: (f["gt_R"], f["gt_t"]) for k, f in enumerate(frames)}
    del frames

    span = _span if trace else _nospan
    system = port.system(config, device)
    _, start = drive.warm_up(system, feed, mix, span)
    _sync(device)
    if plant is not None:
        plant(system, gt)
    gc.collect()
    gc.freeze()
    setup_s = clock() - t_start
    log(f"setup: {start} warm-up frames; {setup_s:.3f} s from process start")

    counts0 = collections.Counter(system.counts)
    lba0 = len(system.mapper.lba_ms)
    if trace:
        from .trace import traced

        window_ctx = traced()
    else:
        window_ctx = contextlib.nullcontext({})
    with window_ctx as tr:
        t0 = clock()
        answers = drive.measure(system, feed, start, mix, t0 + seconds, clock, span)
        _sync(device)
        t1 = clock()
    gc.unfreeze()
    window_s = t1 - t0
    last = start + len(answers)
    if last == len(feed):
        log(f"window: the drive answered all {len(answers)} frames rendered before {seconds} s had passed; "
            f"the window ends at the last frame")
    log(f"window: {len(answers)} frames (frames {start}-{last - 1}) in {window_s:.3f} s")

    cuda = torch.device(device).type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    lost = port.lost_frames(system, fps)
    counts = collections.Counter(system.counts)
    counts.subtract(counts0)
    record = {
        "frames": len(answers), "window_s": window_s, "counts": dict(counts),
        "lba_ms": list(system.mapper.lba_ms[lba0:]),
    }
    breakdown = None
    if trace:
        from .trace import reduce

        t2 = clock()
        record["calls"] = tr["spy"].calls()
        record.update(reduce(tr["profile"]))
        breakdown = record.pop("breakdown")
        del tr["profile"]
        log(f"trace: reduced in {clock() - t2:.3f} s; {record['launches']} kernel launches, "
            f"device busy {record['busy_s']:.6f} s of {window_s:.6f} s")
        for name, row in sorted(record["spans"].items(), key=lambda kv: -kv[1].get("host_s", 0.0)):
            log(f"span: {name} " + " ".join(f"{k} {v!r}" for k, v in row.items()))
    del system, feed, tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    banned = guard.banned_modules()
    if banned:
        raise ImportGuardError(f"modules the benchmark refuses were loaded: {banned}")
    numbers = reference.judge(gt, answers, window=list(answers), lost=lost)
    correct, rows = reference.verdict(numbers, cell.limits)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, "frames_per_s": len(answers) / window_s}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if trace:
        dev.update(busy_s=record["busy_s"], window_s=window_s)
    result = {"correct": bool(correct), "attempted": len(answers), "failed": int(numbers["unanswered"]),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, numbers


class ImportGuardError(RuntimeError):
    pass
