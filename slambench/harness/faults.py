"""Faults planted under the timed path, and the control, for reading the
limits of the output check (proof.py) and for the tests that see the check
fail. Each is a plant(system, gt) for harness.cell.run: it replaces the
System's batch entry for its sensor (port.batch_entry: track_stereo_batch
or track_monocular_batch) on that one object after the warm-up.

  frozen    a step that returns its state unchanged: every call answers
            the last pose of the warm-up and runs nothing
  halved    half of each batch left out: every other frame is not handed
            to the port and gets no answer
  altered   an answer altered where it is produced: every 16th answer is
            the inverse transform (camera-to-world for world-to-camera)

The control is the reference put in the program's place, with one
guarantee of the configuration broken; the configuration's `control` names
which:

  reinit    "never lost, one map": the port runs underneath, so the window
            holds as many frames as a sound run, but the answers are the
            ground truth's. At the first frame answered once half of the
            window's seconds have passed, tracking is lost and begun again,
            as a monocular re-initialisation makes it: REINIT_FRAMES frames
            go unanswered (the two-view initialisation's), and the frames
            after are answered in the frame of a new map, with its origin at
            the camera of the frame where tracking was lost and one tenth of
            the first map's scale (VISUAL_SCALE)
  rescale   "metric scale" (a visual-inertial or stereo rig): the port runs
            underneath, and every frame is answered with the ground truth's
            pose at RESCALE times its scale, every camera centre moved
            away from the world's origin by that factor: a trajectory
            exact up to its scale (`ate_rms_pct` ~0, `scale_err_pct` ~30)
"""
from __future__ import annotations

import collections
import functools
import time

from . import port


def _plant(system, keep, answer):
    """Route the batch entry of `system` so that frame k (counted from the
    first frame after the warm-up) goes to the port only where keep(k), and
    is answered answer(k, the port's pose, or None where not handed)."""
    entry = port.batch_entry(system)
    batch = getattr(system, entry)
    counter = [system.image_count]
    queue = collections.deque()  # (frame, handed to the port) in stream order

    def planted(items, flush=True):
        handed = []
        for it in items:
            queue.append((counter[0], keep(counter[0])))
            if queue[-1][1]:
                handed.append(it)
            counter[0] += 1
        results = iter(batch(handed, flush=flush) if handed or flush else [])
        out = []
        while queue:
            k, to_port = queue[0]
            pose = next(results, queue) if to_port else None
            if pose is queue:  # the port has not answered this frame yet
                break
            out.append(answer(k, pose))
            queue.popleft()
        return out

    setattr(system, entry, planted)


def frozen(system, gt):
    last = system.tracking.current
    pose = (last.R, last.t) if last is not None and last.pose_set else None
    _plant(system, lambda k: False, lambda k, p: pose)


def halved(system, gt):
    _plant(system, lambda k: k % 2 == 0, lambda k, p: p)


def altered(system, gt):
    def answer(k, p):
        if p is None or k % 16:
            return p
        R, t = p
        return R.T, -R.T @ t
    _plant(system, lambda k: True, answer)


# The new map's scale against the first map's.
VISUAL_SCALE = 0.1
# The fewest frames the port's two-view initialisation left unanswered at
# the start of a sequence in any warm-up on the card (2-3).
REINIT_FRAMES = 2


def reinit(system, gt, seconds):
    due = time.perf_counter() + seconds / 2
    lost = []  # the first frame answered once `due` has passed

    def answer(k, p):
        if not lost and time.perf_counter() >= due:
            lost.append(k)
        R, t = gt[k]
        if not lost:
            return R, t
        if k < lost[0] + REINIT_FRAMES:
            return None
        Rm, tm = gt[lost[0]]
        R2 = R @ Rm.T
        return R2, (t - R2 @ tm) * VISUAL_SCALE
    _plant(system, lambda k: True, answer)


# The control's answers' scale against the truth's.
RESCALE = 1.3


def rescale(system, gt, seconds):
    def answer(k, p):
        R, t = gt[k]
        return R, t * RESCALE
    _plant(system, lambda k: True, answer)


FAULTS = {"frozen": frozen, "halved": halved, "altered": altered}
CONTROLS = {"reinit": reinit, "rescale": rescale}


def plant(cell, name, seconds):
    """The plant `name` for `cell` and a window of `seconds`: a fault, or
    "control" for the cell's own."""
    if name == "control":
        return functools.partial(CONTROLS[cell.config["control"]], seconds=seconds)
    return FAULTS[name]
