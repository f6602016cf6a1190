"""Exhaustive block-matching searches in plain torch: the per-pixel field
and the block lattice.

Counterpart of ``tpufg/kernels/motion_xla.py`` (``motion_search_xla`` and
``motion_search_lattice``), which tpufg writes in XLA ops, not Pallas, so
plain PyTorch is their port.

``motion_search_xla`` scores every pixel with the plain per-pixel search
of ``kernels/motion.py`` (separable box: the b rows added in turn, then
the b columns, as XLA's two ``reduce_window`` passes add them), the sqrt
dropped for the "ssd" metric.

``motion_search_lattice`` evaluates MVs only at the block centres of the
``grid``-px lattice the pyramid consumes.  While ``search_radius +
block_size/2 <= grid/2`` every candidate's prev-frame window stays inside
the curr block's grid cell, so after one [C, Hb, g, Wb, g] view each
candidate is a strided window.

Bitwise contract with tpufg: per pixel the Euclidean distance accumulates
the channels in order (d*d, then + d*d per channel, separate roundings),
then sqrt; the 8x8 block sum adds rows first, then columns, one add at a
time; the argmin keeps the first minimum of the dy-outer / dx-inner scan.
The lattice search stacks all (2r+1)^2 candidates on a leading axis and
reduces with ``torch.argmin``, which returns the first occurrence — the
same winner as the reference's strict-< scan, because every cost is
computed by the same ordered elementwise adds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpufg_torch.kernels.motion import pixel_search


def motion_search_xla(prev: torch.Tensor, curr: torch.Tensor,
                      block_size: int = 8, search_radius: int = 4,
                      metric: str = "euclidean") -> torch.Tensor:
    """Exhaustive per-pixel search: planar [C, H, W] -> f32 [2, H, W]
    pixel-unit backward-flow MVs (plane 0 = dx, plane 1 = dy).

    ``metric``: "euclidean" is the shader's per-pixel distance (sqrt of the
    channel sum of squares); "ssd" drops the sqrt, and so does any other
    string, as in tpufg.  Out-of-image block pixels of curr contribute
    nothing; prev's fetch clamps to the edge.
    """
    return pixel_search(prev, curr, block_size, search_radius,
                        exact_box=False, sqrt=metric == "euclidean")


def motion_search_lattice(prev: torch.Tensor, curr: torch.Tensor,
                          grid: int = 16, block_size: int = 8,
                          search_radius: int = 4,
                          bias: float = 0.0) -> torch.Tensor:
    """Planar [C, H, W] (H, W divisible by ``grid``) -> f32
    [2, H/grid, W/grid] backward-flow MVs (plane 0 = dx, plane 1 = dy).

    ``bias`` adds ``bias * (|dx| + |dy|)`` to each candidate's cost (the
    small-displacement preference of tpufg's ``--mv-bias``).
    """
    n_ch, h, w = prev.shape
    g, b, r = int(grid), int(block_size), int(search_radius)
    off = (g - b) // 2  # block start within its cell
    if h % g or w % g:
        raise ValueError(f"frame {h}x{w} not divisible by grid {g}")
    if off - r < 0 or off + b + r > g:
        raise ValueError(
            f"radius {r} leaves the grid cell (need r + b/2 <= g/2)")
    hb, wb = h // g, w // g
    n = 2 * r + 1

    # the (b + 2r)^2 window around each block, then every b x b sub-window:
    # [C, Hb, dy, Wb, dx, ky, kx] -> [K, C, Hb, ky, Wb, kx], K dy-major
    cells = prev.to(torch.float32).reshape(n_ch, hb, g, wb, g)
    win = cells[:, :, off - r:off + b + r, :, off - r:off + b + r]
    cand = win.unfold(2, b, 1).unfold(4, b, 1)
    cand = cand.permute(2, 4, 0, 1, 5, 3, 6).reshape(n * n, n_ch, hb, b, wb, b)
    blk = curr.to(torch.float32).reshape(n_ch, hb, g, wb, g)[
        :, :, off:off + b, :, off:off + b]

    d = blk[0] - cand[:, 0]
    acc = d * d
    for ci in range(1, n_ch):
        d = blk[ci] - cand[:, ci]
        acc = acc + d * d
    dist = torch.sqrt(acc)                        # [K, Hb, b, Wb, b]
    rowsum = dist[:, :, 0]
    for ky in range(1, b):
        rowsum = rowsum + dist[:, :, ky]          # [K, Hb, Wb, b]
    cost = rowsum[..., 0]
    for kx in range(1, b):
        cost = cost + rowsum[..., kx]             # [K, Hb, Wb]
    table, pen = _candidate_tables(r, float(bias), cost.device)
    if bias:
        cost = cost + pen
    best = torch.argmin(cost, dim=0)              # first minimum wins
    return table[:, best]


@functools.lru_cache(maxsize=32)
def _candidate_tables(r: int, bias: float, device: torch.device):
    """The candidates' (dx, dy) as f32 [2, K], dy-major, and their bias
    f32 [K, 1, 1] (tpufg's ``F32(bias * (|dx| + |dy|))``), made once per
    device: a copy from the host in every call would wait for the device."""
    dys, dxs = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                           indexing="ij")
    pen = (bias * (np.abs(dxs) + np.abs(dys))).astype(np.float32)
    table = np.stack([dxs.reshape(-1), dys.reshape(-1)]).astype(np.float32)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(pen.reshape(-1, 1, 1)).to(device))
