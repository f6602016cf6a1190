"""tpufg_torch — the PyTorch/CUDA port of tpufg for one NVIDIA Hopper GPU.

The JAX package ``tpufg`` stays the reference; this package mirrors its
module layout so each counterpart is easy to find:

- ``tpufg_torch.kernels`` — hand-written CUDA C++ kernels for ``sm_90a``
  (sources in ``csrc/``, built with nvcc on first use and bound with
  ctypes), each beside a plain PyTorch version of the same math, plus the
  plain-torch lattice search, block warp and the learned head's other
  convs.
- ``tpufg_torch.models.pyramid`` — the coarse-to-fine motion search;
  ``tpufg_torch.models.rife`` — the learned interpolation head (inference,
  v3 family).
- ``tpufg_torch.engine`` — the per-frame steps, the ingest ring and the
  streaming engine.
- ``tpufg_torch.cli`` — ``python -m tpufg_torch.cli``.
- ``tpufg_torch.config``, ``tpufg_torch.io`` (with the native ingest
  library, ``native/fgio.cpp``), ``tpufg_torch.utils`` — the port's own
  copies of tpufg's host modules.

The port imports nothing of ``tpufg`` and never imports ``jax``
(``tests/test_torch_package.py`` checks every module's imports).

Slice covered so far: fast precision, ``motion_mode`` pyramid,
exhaustive, learned (v3-family heads) or none, 16-px MV grid, fps doubling
at any interpolation factor, packed-int32 or uint8 wire, RGBA sink wire.
Other settings raise ``NotImplementedError``.
"""
