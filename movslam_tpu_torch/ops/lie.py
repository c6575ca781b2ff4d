"""SO(3)/SE(3) operations (f32, batched over leading dims).

Port of the parts of movslam_tpu/ops/lie.py the port uses. Everything here
is safe under torch.func.vmap/jacfwd (no data-dependent control flow, no
in-place writes).
Poses are camera-from-world (R, t): x_cam = R @ x_world + t; tangent
vectors are [rho (translation), phi (rotation)] like Sophus/g2o.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """Skew-symmetric matrices of (..., 3) vectors -> (..., 3, 3)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3(ref):
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(ref.shape[:-1] + (3, 3))


def so3_exp(phi):
    """Rodrigues: (..., 3) -> (..., 3, 3), Taylor-safe near 0."""
    theta2 = (phi * phi).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    a = torch.where(theta2 > 1e-8, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > 1e-8, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return _eye3(phi) + a * K + b * (K @ K)


def so3_log(R):
    """(..., 3, 3) -> (..., 3), stable for small angles (angle < pi).

    Both branches keep a finite forward-mode derivative, also at the identity
    where torch.func.jacfwd takes the inertial Jacobians: the arccos input is
    clipped strictly inside (-1, 1), and the small-angle scale 1/2 + theta^2/12
    is written in (1 - cos) so that its derivative is polynomial. (The angle
    keeps a trailing axis: torch.func.jacfwd promotes the tangent of a 0-d
    tensor times a Python float to float64.)"""
    trace = R[..., 0, 0:1] + R[..., 1, 1:2] + R[..., 2, 2:3]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    theta_l = torch.arccos(torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))
    scale = torch.where(cos_t > 1.0 - 1e-6, 0.5 + (1.0 - cos_t) / 6.0,
                        theta_l / (2.0 * torch.sin(theta_l)))
    return w * scale


def _so3_left_jacobian(phi):
    theta2 = (phi * phi).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    b = torch.where(theta2 > 1e-8, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(
        theta2 > 1e-8, (theta - torch.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0
    )
    return _eye3(phi) + b * K + c * (K @ K)


def se3_exp(xi):
    """(..., 6) [rho, phi] -> (R (..., 3, 3), t (..., 3))."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """Inverse of se3_exp: (R, t) -> (..., 6) [rho, phi].

    Safe under torch.func.jacfwd at the identity, where the pose graph takes
    its edge Jacobians: theta2 ~ 0 selects the series branch, and the other
    branch divides by 1 - cos + EPS, so its tangent stays finite too. As in
    the reference, the closed form starts at theta2 > 1e-8, where f32 cannot
    resolve 1 - cos: up to ~0.3 rad its rho is ill-conditioned (ROADMAP
    Queue 3)."""
    phi = so3_log(R)
    theta2 = (phi * phi).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    # V^-1 = I - K/2 + (1/theta^2)(1 - theta sin / (2 (1 - cos))) K^2
    coef = torch.where(
        theta2 > 1e-8,
        (1.0 - (theta * torch.sin(theta)) / (2.0 * (1.0 - torch.cos(theta) + _EPS))) / (theta2 + _EPS),
        1.0 / 12.0 + theta2 / 720.0,
    )
    Vinv = _eye3(phi) - 0.5 * K + coef * (K @ K)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(a o b): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def project_to_so3(M):
    """Nearest rotation matrix via SVD (det +1)."""
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vh)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * D[..., None, :]) @ Vh
