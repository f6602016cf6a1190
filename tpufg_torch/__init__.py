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
- ``tpufg_torch.ops.oracle`` — the GLSL-spec oracle in plain torch (the
  exact precision path; its scale and warp run on CUDA kernels of
  ``kernels/oracle.py``).
- ``tpufg_torch.cli`` — ``python -m tpufg_torch.cli``;
  ``tpufg_torch.validate`` — ``python -m tpufg_torch.validate``.
- ``tpufg_torch.config``, ``tpufg_torch.io`` (with the native ingest
  library, ``native/fgio.cpp``), ``tpufg_torch.utils`` — the port's own
  copies of tpufg's host modules.

The port imports nothing of ``tpufg`` and never imports ``jax``
(``tests/test_torch_package.py`` checks every module's imports).

Slice covered so far: fast and exact precision, ``motion_mode``
pyramid, exhaustive, learned (v3-family heads) or none, every MV grid and
quality option, any ``--fps-multiplier``, the streaming engine's options,
``--trace`` and ``--debug-checks``, packed-int32 or uint8 wire, RGBA or
y4m sink wire.  The v1 and v2 heads and ``--devices`` raise
``NotImplementedError``.
"""
