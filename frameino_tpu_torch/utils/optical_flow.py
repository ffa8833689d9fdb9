"""The bivariate Gaussian kernel that dilates trajectory dots (the port's
own copy of ``bivariate_gaussian`` from ``frameino_tpu/utils/optical_flow.py``;
reference ``data_loader/video_dataset_motion_FrameINO.py:30``: kernel_size
45, sigma 3, isotropic).
"""

from __future__ import annotations

import numpy as np


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
