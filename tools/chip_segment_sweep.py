"""Time variants of csrc/segment_sum.cu's tile constants on one card.

    python3 tools/chip_segment_sweep.py [NAME:kConst=value,kConst=value ...]

Builds the checkout's csrc/segment_sum.cu as it is ("as_is") and once per
variant with the named constants replaced (e.g. `direct0:kDirectRows=0`
turns the direct mode off, `sm50k:kSmFloats=50000`), one nvcc each, in
parallel, under movslam_tpu_torch/_build/sweep/, and prints each one's
registers (ptxas -v). For every variant it checks each of chip_smoke.py
phase 2's segment sums (local-BA shapes and global-BA caps, plans of
ops/ba.segment_plans) and each of ops/ba.py's groups bit-equal to CPU
index_add_, and times them as phase 2 does (device µs per launch, CUDA
graph of 200 launches, or 20 at the caps' pair scatter). Then the wrapper's host cost with the checkout's build: µs per
segment_sums call of 1 and 4 jobs on the host clock over 2,000 calls
without a sync, and its parts. Prints a table and one JSON line, with the
card's name and power limit. Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import struct
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(fn, n=2000):
    """Host µs per call of fn() over n calls, no sync inside the loop."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def build_variants(kernels, variants):
    """Compile csrc/segment_sum.cu once per variant; returns name -> the
    bound segment_sums_launch."""
    src = (kernels.CSRC / "segment_sum.cu").read_text()
    out_dir = kernels.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for const, value in subs.items():
            text, count = re.subn(rf"constexpr int {const} = [^;]+;", f"constexpr int {const} = {value};", text)
            if count != 1:
                raise SystemExit(f"chip_segment_sweep: no constant {const} in segment_sum.cu")
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                        str(cu.with_suffix(".so")), str(cu)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"chip_segment_sweep: nvcc {name} failed:\n{log}")
        print(f"{name}: {'; '.join(line.split(':', 1)[1].strip() for line in log.splitlines() if 'registers' in line)}",
              flush=True)
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).segment_sums_launch
        fn.argtypes = kernels._SOURCES["segment_sum.cu"]["segment_sums_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def phase2_inputs(cs, ba, torch, np, dev):
    """chip_smoke.py phase 2's inputs: (label, case) -> (x, plan, CPU
    index_add_ over every row)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    shapes = {"local_ba": (48, 1024, 4096, 11, 527, 2, 8),
              "gba_caps": (768, cs.GBA_TOP_MP, 65536, cs.GBA_TOP_KF, cs.GBA_TOP_MP, 4, 4)}
    cases = {}
    for label, (K, P, O, n_kf, n_mp, lo, hi) in shapes.items():
        obs_kf, obs_mp, valid, obp = cs.ba_index_case(rng, K, P, O, n_kf, n_mp, lo, hi)
        plans = ba.segment_plans(*(torch.as_tensor(a, device=dev) for a in (obs_kf, obs_mp, valid, obp)), K, P, O)
        pad = obp < O
        pair_keep = (pad[:, :, None] & pad[:, None, :]).reshape(-1)
        kfp = obs_kf[np.minimum(obp, O - 1)]
        ab = (kfp[:, :, None] * K + kfp[:, None, :]).reshape(-1)
        for name, (key, idx, n, trail, keep) in {
                "kf_C6": ("kf", obs_kf, K, (6,), valid), "kf_C36": ("kf", obs_kf, K, (6, 6), valid),
                "mp_C3": ("mp", obs_mp, P, (3,), valid), "mp_C9": ("mp", obs_mp, P, (3, 3), valid),
                "pair_C36": ("pair", ab, K * K, (6, 6), pair_keep)}.items():
            keep_d = torch.as_tensor(keep, device=dev).reshape((-1,) + (1,) * len(trail))
            x = cs.spread_values(gen, (len(idx),) + trail) * keep_d
            want = torch.zeros((n,) + trail).index_add_(0, torch.as_tensor(idx), x.cpu())
            cases[(label, name)] = (x, plans[key], want)
    return cases


def main(argv):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_segment_sweep: no CUDA card", flush=True)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from movslam_tpu_torch.ops import ba, kernels

    variants = {"as_is": {}}
    for arg in argv[1:]:
        name, _, subs = arg.partition(":")
        variants[name] = dict(kv.split("=", 1) for kv in subs.split(",") if kv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    kernels.build()
    own = kernels._fns["segment_sums_launch"]
    fns = build_variants(kernels, variants)
    dev = torch.device("cuda")
    cases = phase2_inputs(cs, ba, torch, np, dev)
    groups = {(label, f"group_{g}"): [cases[(label, n)] for n in names]
              for label in ("local_ba", "gba_caps") for g, names in cs.SEGMENT_GROUPS.items()}
    table = {}
    try:
        for vname, fn in fns.items():
            kernels._fns["segment_sums_launch"] = fn
            row = {}
            for key, jobs in [(k, [v]) for k, v in cases.items()] + list(groups.items()):
                pairs = [(x, plan) for x, plan, _ in jobs]
                for got, (_, _, want) in zip(kernels.segment_sums(pairs), jobs):
                    if not torch.equal(got.cpu(), want):
                        raise SystemExit(f"chip_segment_sweep: {vname} {key} is not bit-equal to CPU index_add_")
                big = any(x.numel() > 2**24 for x, _ in pairs)
                row[" ".join(key)] = 1e3 * cs.graph_ms(lambda: kernels.segment_sums(pairs),
                                                       n=20 if big else cs.GRAPH_LAUNCHES)
            table[vname] = row
    finally:
        kernels._fns["segment_sums_launch"] = own
    names = list(table)
    print("device us/launch".ljust(28) + "".join(n.rjust(12) for n in names), flush=True)
    for key in table["as_is"]:
        print(key.ljust(28) + "".join(f"{table[n][key]:12.3f}" for n in names), flush=True)

    one = [cases[("local_ba", "kf_C6")][:2]]
    four = [cases[("local_ba", n)][:2] for n in cs.SEGMENT_GROUPS["linearize"]]
    x, plan = one[0]
    buf = torch.empty(4096, device=dev)
    packed = struct.pack("7q", x.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(), 0, 6, 48, x.shape[0])
    host = {
        "segment_sums, 1 job": per_call_us(lambda: kernels.segment_sums(one)),
        "segment_sums, 4 jobs": per_call_us(lambda: kernels.segment_sums(four)),
        "torch.empty": per_call_us(lambda: torch.empty(4096, device=dev)),
        "4 as_strided views": per_call_us(lambda: [buf.as_strided((48, 6), (6, 1), o) for o in (0, 512, 1024, 2048)]),
        "struct.pack of 4 jobs": per_call_us(lambda: struct.pack("28q", *range(28))),
        "torch.cuda.current_stream().cuda_stream": per_call_us(lambda: torch.cuda.current_stream().cuda_stream),
        "the raw current stream": per_call_us(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "the ctypes launch, 1 job": per_call_us(
            lambda: own(1, packed, buf.data_ptr(), torch._C._cuda_getCurrentRawStream(0))),
    }
    for k, v in host.items():
        print(f"host us/call: {k}: {v:.2f}", flush=True)
    print(json.dumps({"segment_sweep": {"card": card, "variants": variants, "device_us": table, "host_us": host}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
