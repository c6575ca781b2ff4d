"""Image sampling / pyramid primitives (batched).

Port of movslam_tpu/ops/image.py. `sample_patches` is a direct bilinear
gather here; the reference expressed it as dense hat-weight matmuls to dodge
TPU gathers. Weights are the same hat function, so results agree to f32
rounding.
"""
from __future__ import annotations

import torch


def bilinear_grid(img, ys, xs):
    """Bilinear samples on per-row grids: img (H, W) or per-point (N, H, W)
    f32, ys (N, K), xs (N, J) already clamped to [0, dim-1]. Returns
    (N, K, J) with out[n, k, j] = img[n](ys[n, k], xs[n, j]); rows are
    interpolated first, like the reference's (W_y @ img) @ W_x^T."""
    H, W = img.shape[-2:]
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    wy0 = 1.0 - (ys - y0f)
    wy1 = 1.0 - ((y0f + 1.0) - ys)
    wx0 = 1.0 - (xs - x0f)
    wx1 = 1.0 - ((x0f + 1.0) - xs)
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    # Hat weights of taps past the border are exactly 0 after the clamp.
    wy1 = torch.where(y0 + 1 <= H - 1, wy1, torch.zeros_like(wy1))
    wx1 = torch.where(x0 + 1 <= W - 1, wx1, torch.zeros_like(wx1))
    ya, yb = y0[:, :, None], y1[:, :, None]
    xa, xb = x0[:, None, :], x1[:, None, :]
    if img.dim() == 2:
        px = lambda y, x: img[y, x]  # noqa: E731
    else:
        n = torch.arange(img.shape[0], device=img.device)[:, None, None]
        px = lambda y, x: img[n, y, x]  # noqa: E731
    r_a = wy0[:, :, None] * px(ya, xa) + wy1[:, :, None] * px(yb, xa)
    r_b = wy0[:, :, None] * px(ya, xb) + wy1[:, :, None] * px(yb, xb)
    return wx0[:, None, :] * r_a + wx1[:, None, :] * r_b


def sample_patches(img, centers_xy, half):
    """(2*half+1)^2 bilinear patches around centers (N, 2) -> (N, K, K),
    coordinates clamped to the image (BORDER_REPLICATE-like)."""
    H, W = img.shape
    K = 2 * half + 1
    img = img.to(torch.float32)
    d = torch.arange(K, dtype=torch.float32, device=img.device) - half
    hy = torch.tensor(H - 1.000001, dtype=torch.float32)
    hx = torch.tensor(W - 1.000001, dtype=torch.float32)
    x = torch.minimum(centers_xy[:, 0].clamp(min=0.0), hx.to(img.device))
    y = torch.minimum(centers_xy[:, 1].clamp(min=0.0), hy.to(img.device))
    yi = torch.minimum((y[:, None] + d).clamp(min=0.0), hy.to(img.device))
    xi = torch.minimum((x[:, None] + d).clamp(min=0.0), hx.to(img.device))
    return bilinear_grid(img, yi, xi)


def gaussian_downsample(img):
    """5-tap binomial blur with edge padding, then decimate by 2 (pyrDown-like)."""
    k = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]
    x = img.to(torch.float32)
    H, W = x.shape
    xp = torch.cat([x[:1].expand(2, W), x, x[-1:].expand(2, W)], dim=0)
    x = sum(k[i] * xp[i : i + H, :] for i in range(5))
    xp = torch.cat([x[:, :1].expand(H, 2), x, x[:, -1:].expand(H, 2)], dim=1)
    x = sum(k[i] * xp[:, i : i + W] for i in range(5))
    return x[::2, ::2].contiguous()


def build_pyramid(img, levels):
    """List of (H/2^l, W/2^l) f32 images, level 0 = original."""
    pyr = [img.to(torch.float32)]
    for _ in range(levels - 1):
        pyr.append(gaussian_downsample(pyr[-1]))
    return pyr
