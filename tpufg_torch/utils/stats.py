"""Runtime statistics for the port.

``device_sync`` is the torch counterpart of ``tpufg.utils.stats.
device_sync``, whose one-element numpy fetch does not apply to CUDA
tensors; the engine takes ``FpsWindow`` and ``LatencyRecorder`` from
tpufg's own (JAX-free) module.
"""

from __future__ import annotations

import torch


def device_sync(x: torch.Tensor) -> None:
    """Wait until the work queued on ``x``'s current CUDA stream is done
    (a no-op for CPU tensors, which are computed synchronously)."""
    if x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()
