"""The plain reference that decides `correct`: numpy only, no import of the
port, nothing taken from the program but the answers it returned.

The reference trajectory is the ground truth the benchmark's own generator
(traffic/synthetic.py) rendered the frames from. The port's answers are the
poses (R_cw, t_cw) that track_monocular / track_monocular_batch returned.
A monocular map has a free scale and frame, so the answered camera centres
are brought onto the ground truth by one similarity (Umeyama's least
squares, in float64) fitted to the answers due in the window, and each of
those answers is judged:

  unanswered       window frames answered with no pose, or with the
                   tracker lost (exact: 0)
  ate_rms_pct      the root mean square of the camera-centre errors, as %
                   of the span of the ground-truth centres in the window
  scale_err_pct    100 |s - 1|, s the scale of the answered path against the
                   true one (the inverse of the fitted similarity's scale):
                   what a rig that promises metric scale (an IMU, a stereo
                   baseline) is judged by; a monocular cell's limits leave
                   it out, as its scale is free
"""
from __future__ import annotations

import numpy as np


def umeyama(gt, est):
    """s, R, t minimising |gt - (s R est + t)|^2 over rows (N, 3)."""
    gt, est = np.asarray(gt, np.float64), np.asarray(est, np.float64)
    mu_g, mu_e = gt.mean(0), est.mean(0)
    g, e = gt - mu_g, est - mu_e
    cov = g.T @ e / len(gt)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_e = (e ** 2).sum() / len(gt)
    s = float(np.trace(np.diag(D) @ S) / var_e) if var_e > 0 else 1.0
    return s, R, mu_g - s * R @ mu_e


def center(R_cw, t_cw):
    R_cw, t_cw = np.asarray(R_cw, np.float64), np.asarray(t_cw, np.float64)
    return -R_cw.T @ t_cw


def judge(gt, answers, window, lost=()):
    """The compared numbers. gt: {k: (R_cw, t_cw)} of every frame fed;
    answers: {k: (R_cw, t_cw) or None}; window: the frame indices due in the
    window; lost: frames the tracker marked lost."""
    lost = set(lost)
    ok = {k: answers[k] for k in window if answers.get(k) is not None and k not in lost}
    out = {"unanswered": len(window) - len(ok)}
    if len(ok) < 3:
        out["ate_rms_pct"] = out["scale_err_pct"] = float("inf")
        return out
    g = np.array([center(*gt[k]) for k in ok])
    e = np.array([center(*p) for p in ok.values()])
    s, R, t = umeyama(g, e)
    span = float(np.linalg.norm(np.ptp(g, axis=0)))
    aligned = s * e @ R.T + t
    errs = np.linalg.norm(g - aligned, axis=1)
    out["ate_rms_pct"] = 100.0 * float(np.sqrt(np.mean(errs ** 2))) / span
    out["scale_err_pct"] = 100.0 * abs(1.0 / s - 1.0) if s > 0 else float("inf")
    return out


def verdict(numbers, limits):
    """(correct, [(name, number, limit)]): correct when every number is at
    or under its limit; a number that is not finite fails."""
    rows = [(name, float(numbers[name]), float(limit)) for name, limit in limits.items()]
    return all(np.isfinite(v) and v <= lim for _, v, lim in rows), rows
