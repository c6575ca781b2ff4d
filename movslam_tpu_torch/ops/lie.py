"""SO(3)/SE(3) operations (f32, batched over leading dims).

Port of the parts of movslam_tpu/ops/lie.py the mono per-frame slice uses.
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


def se3_compose(Ra, ta, Rb, tb):
    """(a o b): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def project_to_so3(M):
    """Nearest rotation matrix via SVD (det +1)."""
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vh)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * D[..., None, :]) @ Vh
