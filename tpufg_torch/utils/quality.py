"""Image quality metrics: SSIM and PSNR.

A copy of ``tpufg/utils/quality.py`` (numpy only), held equal to it by
``tests/test_torch_host.py``.

The north-star acceptance criterion for the bf16 production path is
SSIM >= 0.999 against the f32 oracle (BASELINE.md).  The reference ships no
quality metrics at all (readme.md:89, unchecked "Evaluate quality and
performance metrics"); this module supplies them for tests and
``tpufg_torch.validate``.

SSIM follows Wang et al. 2004 with the standard 11x11 Gaussian window
(sigma=1.5), K1=0.01, K2=0.03, computed per channel in float64 and averaged.
"""

from __future__ import annotations

import numpy as np


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(r**2) / (2.0 * sigma**2))
    g /= g.sum()
    return g


def _filter2d_sep(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution along H and W of [H, W]."""
    from numpy.lib.stride_tricks import sliding_window_view

    k = win.size
    out = sliding_window_view(img, k, axis=0) @ win      # [H-k+1, W]
    out = sliding_window_view(out, k, axis=1) @ win      # [H-k+1, W-k+1]
    return out


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM between two images [H, W] or [H, W, C] (channel-averaged)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    if a.shape[0] < 11 or a.shape[1] < 11:
        raise ValueError("images must be at least 11x11 for SSIM")
    win = _gaussian_window()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(a.shape[2]):
        x, y = a[..., c], b[..., c]
        mx = _filter2d_sep(x, win)
        my = _filter2d_sep(y, win)
        mxx = _filter2d_sep(x * x, win)
        myy = _filter2d_sep(y * y, win)
        mxy = _filter2d_sep(x * y, win)
        vx = mxx - mx * mx
        vy = myy - my * my
        cov = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cov + c2)) / (
            (mx * mx + my * my + c1) * (vx + vy + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))
