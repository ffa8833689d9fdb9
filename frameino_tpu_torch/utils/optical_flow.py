"""Optical-flow visualization and the Gaussian dilation kernel (numpy;
the port's own copy of ``frameino_tpu/utils/optical_flow.py``).

Counterpart of reference ``utils/optical_flow_utils.py``: the Middlebury
flow color wheel (Baker et al. ICCV'07 / Scharstein-Sun coloring), flow
magnitude filtering, and the bivariate Gaussian kernel used to dilate
trajectory dots (``data_loader/video_dataset_motion_FrameINO.py:30``:
kernel_size 45, sigma 3, isotropic).
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """[55, 3] RGB color wheel spanning six hue transitions."""
    transitions = [("RY", 15), ("YG", 6), ("GC", 4), ("CB", 11),
                   ("BM", 13), ("MR", 6)]
    wheel = np.zeros((sum(n for _, n in transitions), 3))
    col = 0
    for name, n in transitions:
        ramp = np.floor(255 * np.arange(n) / n)
        if name == "RY":
            wheel[col:col + n, 0] = 255
            wheel[col:col + n, 1] = ramp
        elif name == "YG":
            wheel[col:col + n, 0] = 255 - ramp
            wheel[col:col + n, 1] = 255
        elif name == "GC":
            wheel[col:col + n, 1] = 255
            wheel[col:col + n, 2] = ramp
        elif name == "CB":
            wheel[col:col + n, 1] = 255 - ramp
            wheel[col:col + n, 2] = 255
        elif name == "BM":
            wheel[col:col + n, 2] = 255
            wheel[col:col + n, 0] = ramp
        elif name == "MR":
            wheel[col:col + n, 2] = 255 - ramp
            wheel[col:col + n, 0] = 255
        col += n
    return wheel


def _flow_colors(u: np.ndarray, v: np.ndarray,
                 convert_to_bgr: bool = False) -> np.ndarray:
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    angle = np.arctan2(-v, -u) / np.pi
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((*u.shape, 3), np.uint8)
    for i in range(3):
        c0 = wheel[k0, i] / 255.0
        c1 = wheel[k1, i] / 255.0
        col = (1 - f) * c0 + f * c1
        in_range = rad <= 1
        col = np.where(in_range, 1 - rad * (1 - col), col * 0.75)
        img[..., 2 - i if convert_to_bgr else i] = np.floor(255 * col)
    return img


def flow_to_image(flow_uv: np.ndarray, clip_flow=None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 visualization."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    rad_max = np.sqrt(u ** 2 + v ** 2).max()
    scale = 1.0 / (rad_max + 1e-5)
    return _flow_colors(u * scale, v * scale, convert_to_bgr)


def filter_uv(flow: np.ndarray, threshold_factor: float = 0.1,
              sample_prob: float = 1.0,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """Zero out sub-threshold flow vectors + random binary subsampling."""
    rng = rng or np.random.default_rng()
    rad = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    mask = rad >= threshold_factor * rad.max()
    flow = flow * mask[..., None]
    keep = (rng.standard_normal(flow.shape) >= (1 - sample_prob))
    return flow * keep


def bivariate_gaussian(kernel_size: int, sig_x: float, sig_y: float = None,
                       theta: float = 0.0, isotropic: bool = True
                       ) -> np.ndarray:
    """Normalized (an)isotropic 2D Gaussian kernel on a centered grid."""
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    grid = np.stack([xx, yy], axis=-1)
    if isotropic:
        sigma = np.diag([sig_x ** 2, sig_x ** 2])
    else:
        d = np.diag([sig_x ** 2, (sig_y or sig_x) ** 2])
        r = np.array([[np.cos(theta), -np.sin(theta)],
                      [np.sin(theta), np.cos(theta)]])
        sigma = r @ d @ r.T
    inv = np.linalg.inv(sigma)
    k = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", grid, inv, grid))
    return k / k.sum()
