"""What a traced run (--trace 1) records, and its reduction to numbers.

The profiler (torch.profiler, CPU and CUDA activity) runs over the whole
measured window, which a traced run cuts to TRACE_SECONDS. The drives put
a `slambench.<call>` span around every call into the port; the port puts
its own `movslam.<layer>` spans inside (movslam_tpu_torch/trace.py), which
the reduction turns into one row of host and device numbers per span name
for the per-layer metrics (reduce's `spans`). The spy wraps
the port's two kernel wrappers, ops/kernels.score_candidates and
ops/kernels.segment_sums, where every module of the port sees them, and
keeps each launching call's shapes; a segment sum's kept rows (its plan's
last offset, on the device) are copied to pinned host memory without a
sync and read once the window has closed. Nothing here is active in a
--trace 0 run.
"""
from __future__ import annotations

import collections
import contextlib
import sys

from . import roofline

SPAN = "slambench."
PORT_SPAN = "movslam."
# A traced run profiles at most this much of the window: the profiler's stop
# and the reduction take ~5 s per second traced on the card (PERF.md), and a
# traced run has to end within 360 s.
TRACE_SECONDS = 20.0
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Spy:
    """Wraps the two kernel wrappers of the port for the traced window."""

    def __init__(self):
        self.score_candidates = []  # (tracks, mv rows) per launch
        self.segment_sums = []  # per launch: [(columns, segments, row slot)] per job
        self._rows = []  # pinned int32 chunks holding each job's kept rows
        self._used = 0
        self._undo = []

    def _row_slot(self, offsets, n):
        import torch

        chunk = 1 << 14
        if self._used == len(self._rows) * chunk:
            self._rows.append(torch.empty(chunk, dtype=torch.int32, pin_memory=True))
        slot = self._used
        self._rows[-1][slot % chunk: slot % chunk + 1].copy_(offsets[n: n + 1], non_blocking=True)
        self._used += 1
        return slot

    def _wrap_score(self, fn):
        def score_candidates(img, prev_pt, cand, mv_delta, *args, **kwargs):
            if cand.is_cuda and cand.shape[0]:
                self.score_candidates.append((cand.shape[0], mv_delta.shape[0]))
            return fn(img, prev_pt, cand, mv_delta, *args, **kwargs)
        return score_candidates

    def _wrap_sums(self, fn):
        def segment_sums(jobs):
            group = []
            for x, plan in jobs:
                columns = 1
                for d in x.shape[1:]:
                    columns *= d
                if x.is_cuda and plan.n * columns:
                    group.append((columns, plan.n, self._row_slot(plan.offsets, plan.n)))
            if group:
                self.segment_sums.append(group)
            return fn(jobs)
        return segment_sums

    def install(self):
        from movslam_tpu_torch.ops import kernels

        for name, wrap in (("score_candidates", self._wrap_score), ("segment_sums", self._wrap_sums)):
            original = getattr(kernels, name)
            spy = wrap(original)
            spy.__dict__.update(original.__dict__)  # a wrapper counts its launches on itself
            for mod_name, mod in list(sys.modules.items()):
                if mod_name.split(".", 1)[0] == "movslam_tpu_torch" and getattr(mod, name, None) is original:
                    setattr(mod, name, spy)
                    self._undo.append((mod, name, original))

    def remove(self):
        for mod, name, original in reversed(self._undo):
            original.__dict__.update(getattr(mod, name).__dict__)
            setattr(mod, name, original)
        self._undo.clear()

    def calls(self):
        """(bytes, ops) per launch of each kernel wrapper. Call after a sync."""
        import torch

        rows = torch.cat(self._rows).tolist()[: self._used] if self._rows else []
        sums = []
        for group in self.segment_sums:
            work = [roofline.segment_sum_work(rows[slot], c, n) for c, n, slot in group]
            sums.append((sum(b for b, _ in work), sum(o for _, o in work)))
        return {
            "score_candidates": [roofline.score_candidates_work(n, m) for n, m in self.score_candidates],
            "segment_sums": sums,
        }


@contextlib.contextmanager
def traced():
    """Profile the block with the spy installed; yields a dict that holds,
    after the block, `profile` (the finished profiler) and `spy`."""
    from torch.profiler import ProfilerActivity, profile

    out = {"spy": Spy()}
    out["spy"].install()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield out
    finally:
        out["spy"].remove()
    out["profile"] = prof


def kernel_name(name):
    """A device op's name without its return type, anonymous namespace and
    argument list, at most 120 characters."""
    short = name.replace("(anonymous namespace)::", "")
    short = short[5:] if short.startswith("void ") else short
    return short.split("(", 1)[0].strip()[:120] or name[:120]


def _activity(e, cuda):
    """The event's kind: kernel, gpu_memcpy, gpu_memset, user_annotation,
    gpu_user_annotation, cuda_runtime or another host kind (torch < 2.12 has
    no activity_type: a span's rows, the benchmark's and the port's, are
    annotations by their name, and a host row named cu* is a runtime or
    driver call)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    annotation = name.startswith((SPAN, PORT_SPAN)) or (
        hasattr(e, "is_user_annotation") and e.is_user_annotation())
    if e.device_type() != cuda:
        return "user_annotation" if annotation else "cuda_runtime" if name.startswith("cu") else "cpu_op"
    if annotation:
        return "gpu_user_annotation"
    return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"


def _thread(e):
    return e.start_thread_id() if hasattr(e, "start_thread_id") else 0


LAUNCH_CALLS = ("cuda_runtime", "cuda_driver")


def _events(prof):
    """(device events, host events, benchmark spans, port spans, launches).
    Events are (start_ns, end_ns, name) tuples; device events also carry
    their activity and their correlation id. Host events are the main
    thread's operators and runtime calls, port spans the main thread's
    `movslam.` spans (the main thread: the one that holds the benchmark's
    spans). launches maps the correlation id of each of the main thread's
    runtime and driver calls to its start: a kernel carries the id of the
    call that launched it, a kernel replayed from a CUDA graph that of the
    cudaGraphLaunch."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, spans, port, calls = [], [], [], [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        kind = _activity(e, cuda)
        if e.device_type() == cuda:
            if kind in DEVICE_ACTIVITIES:
                device.append((start, end, e.name(), kind, e.correlation_id()))
        elif kind == "user_annotation":
            if e.name().startswith(SPAN):
                spans.append((start, end, e.name(), _thread(e)))
            elif e.name().startswith(PORT_SPAN):
                port.append((start, end, e.name(), _thread(e)))
        else:
            host.append((start, end, e.name(), _thread(e)))
            if kind in LAUNCH_CALLS:
                calls.append((e.correlation_id(), start, _thread(e)))
    main = collections.Counter(t for *_, t in spans).most_common(1)
    main = main[0][0] if main else None
    ours = lambda t: main is None or t == main  # noqa: E731
    host = [h[:3] for h in host if ours(h[3])]
    port = [p[:3] for p in port if ours(p[3])]
    launches = {c: start for c, start, t in calls if ours(t)}
    return device, host, [s[:3] for s in spans], port, launches


def _union(intervals):
    """Merged (start, end) intervals of sorted (start, end, ...) tuples."""
    merged = []
    for start, end, *_ in intervals:
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def _label_gaps(gaps, host, spans, port):
    """For each gap (start, end), what the host was doing at its midpoint:
    the innermost port span in full (`movslam.<layer>`), or else the
    innermost benchmark span without its prefix ("outside" where none was
    open), and the innermost host operator or runtime call ("python" where
    none was open). One sweep over nested intervals."""
    points = sorted(((g0 + g1) // 2, i) for i, (g0, g1) in enumerate(gaps))
    labels = [None] * len(gaps)
    stacks = {"span": [], "op": [], "port": []}
    streams = [(s, e, n, "span") for s, e, n in spans] + [(s, e, n, "op") for s, e, n in host]
    streams += [(s, e, n, "port") for s, e, n in port]
    streams.sort(key=lambda x: (x[0], -x[1]))  # a parent before a child that starts with it
    j = 0
    for t, i in points:
        while j < len(streams) and streams[j][0] <= t:
            s, e, n, which = streams[j]
            stack = stacks[which]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, n))
            j += 1
        for stack in stacks.values():
            while stack and stack[-1][0] < t:
                stack.pop()
        span = stacks["span"][-1][1][len(SPAN):] if stacks["span"] else "outside"
        span = stacks["port"][-1][1] if stacks["port"] else span
        op = stacks["op"][-1][1] if stacks["op"] else "python"
        labels[i] = f"{span}: {op}"
    return labels


def _span_rows(port, device, launches):
    """Per port span name: `n` (spans), `host_s` (their host seconds, a span
    inside one of its own name counted once), `self_s` (the seconds in which
    it was the innermost port span), `outer_s` (the seconds of those with no
    span of the same first word around them, so that a layer's spans add up
    without counting nested ones twice), `launches` and `device_s` (the
    kernels whose launch call started while a span of that name was open,
    each counted once a name); and a row `outside`: `launches` and
    `device_s` of the kernels launched with no port span open, or by a call
    not found on the main thread."""
    rows = collections.defaultdict(lambda: {"n": 0, "host_s": 0.0, "self_s": 0.0, "outer_s": 0.0,
                                            "launches": 0, "device_s": 0.0})
    port = sorted(port, key=lambda x: (x[0], -x[1]))  # a parent before a child that starts with it
    stack = []  # [end, start, name, first word, ns covered by children]

    def pop():
        end, start, name, _, children = stack.pop()
        rows[name]["self_s"] += (end - start - children) / 1e9

    for start, end, name in port:
        while stack and min(x[0] for x in stack) <= start:
            pop()
        word = name[len(PORT_SPAN):].split(".", 1)[0]
        row = rows[name]
        row["n"] += 1
        if all(x[2] != name for x in stack):
            row["host_s"] += (end - start) / 1e9
        if all(x[3] != word for x in stack):
            row["outer_s"] += (end - start) / 1e9
        if stack:
            stack[-1][4] += end - start
        stack.append([end, start, name, word, 0])
    while stack:
        pop()

    outside = {"launches": 0, "device_s": 0.0}
    timed = []
    for start, end, _, kind, corr in device:
        if kind != "kernel":
            continue
        at = launches.get(corr)
        if at is None:
            outside["launches"] += 1
            outside["device_s"] += (end - start) / 1e9
        else:
            timed.append((at, (end - start) / 1e9))
    timed.sort()
    opened, j, names = [], 0, ()  # opened: (end, name) of the spans open at the launch
    for at, seconds in timed:
        changed = False
        while j < len(port) and port[j][0] <= at:
            while opened and min(x[0] for x in opened) <= port[j][0]:
                opened.pop()
            opened.append(port[j][1:])
            j, changed = j + 1, True
        while opened and min(x[0] for x in opened) < at:
            opened.pop()
            changed = True
        if changed:
            names = tuple(dict.fromkeys(name for _, name in opened))
        if not names:
            outside["launches"] += 1
            outside["device_s"] += seconds
        for name in names:
            rows[name]["launches"] += 1
            rows[name]["device_s"] += seconds
    out = dict(rows)
    out["outside"] = outside
    return out


def reduce(prof):
    """The traced window's numbers: per kernel name (launches, device s),
    kernel launches, device busy seconds (the union of the device's
    operation intervals), the port's spans (_span_rows) and the breakdown's
    two lists."""
    device, host, spans, port, launches = _events(prof)
    device.sort()
    kernels = collections.defaultdict(lambda: [0, 0.0])
    ops = collections.defaultdict(float)
    for start, end, name, kind, _ in device:
        short = kernel_name(name)
        ops[short] += (end - start) / 1e9
        if kind == "kernel":
            kernels[short][0] += 1
            kernels[short][1] += (end - start) / 1e9
    merged = _union(device)
    busy = sum(e - s for s, e in merged) / 1e9
    edges = [x for s, e, *_ in spans + host for x in (s, e)]
    lo = min(edges + [m[0] for m in merged[:1]], default=None)
    hi = max(edges + [m[1] for m in merged[-1:]], default=None)
    bounds = [lo] + [x for m in merged for x in m] + [hi] if merged else []
    gaps = [(a, b) for a, b in zip(bounds[0::2], bounds[1::2]) if b > a]
    idle = collections.defaultdict(float)
    for (a, b), label in zip(gaps, _label_gaps(gaps, host, spans, port)):
        idle[label] += (b - a) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {
        "kernels": {k: tuple(v) for k, v in kernels.items()},
        "launches": sum(v[0] for v in kernels.values()),
        "busy_s": busy,
        "spans": _span_rows(port, device, launches),
        "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)},
    }
