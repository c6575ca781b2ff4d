"""Peaks of the card and the work of each kernel call, counted from the
problem the call solves (its shapes), not from the kernel's internals, so
another implementation of the same work reads the same count.

A call's least time is the larger of its bytes over the card's memory
bandwidth and its operations over its scalar rate; a kernel's roofline
share is the sum of its calls' least times over the kernel's device time.
"""
from __future__ import annotations

# One NVIDIA H100 SXM, NVIDIA's data sheet: HBM3 bandwidth, and the f32
# rate outside the tensor cores, taken as the rate of 32-bit integer ops.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

N_CAND = 4  # MV candidates scored per track
BLOCK_PIXELS = 256  # 16x16 descriptor block
WORDS = 8  # 256-bit descriptor, 32-bit words


def least_seconds(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)


def score_candidates_work(n_tracks, n_mvs):
    """(bytes, ops) of one score_candidates call over n_tracks tracks and an
    MV table of n_mvs rows. Bytes: the tracks (position and block size, 2 f32
    each; 4 candidate indices; an 8-word descriptor), the MV table's
    displacements (2 f32 a row) and the outputs (chosen MV, distance, new
    position, descriptor, in-bounds flag). The image is left out: which of
    its pixels a call needs depends on the data, so it is not counted.
    Ops: per candidate block two compares a pixel and an xor, a popcount
    and an add per descriptor word."""
    tracks = n_tracks * (8 + 4 * N_CAND + 8 + 4 * WORDS)
    outputs = n_tracks * (4 + 4 + 8 + 4 * WORDS + 1)
    nbytes = tracks + 8 * n_mvs + outputs
    ops = n_tracks * N_CAND * (2 * BLOCK_PIXELS + 3 * WORDS)
    return nbytes, ops


def segment_sum_work(rows, columns, segments):
    """(bytes, ops) of one ordered segment sum: each kept row read once (its
    `columns` f32 and its int32 index), the segment offsets (segments + 1
    int32), every output written once (segments x columns f32); one add per
    kept element."""
    nbytes = rows * (4 * columns + 4) + 4 * (segments + 1) + 4 * segments * columns
    return nbytes, rows * columns


def share_pct(calls, device_seconds):
    """100 x the calls' summed least time over the kernel's device time;
    None when there is nothing to read."""
    if not calls or not device_seconds or device_seconds <= 0:
        return None
    return 100.0 * sum(least_seconds(b, o) for b, o in calls) / device_seconds
