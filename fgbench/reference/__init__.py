"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy only: nothing here imports ``jax``, ``tpufg`` or
``tpufg_torch``, and nothing takes a tensor, table or weight the program
made.  It recomputes, from the frames the benchmark made and the
checkpoint file, what each timed step should have handed to the sink:
``steps.make_reference`` builds the scale-only step and the frame-pair
step of one configuration.

The arithmetic is frozen from the port's plain paths (the versions its
kernels are held to), one rounding per operation, with the compute type as
a parameter: ``precision="bf16"`` is what the configurations state, and
``precision="fp8"`` (float8 e4m3, saturating) is the control, the step
below it that a later change could be tempted to take.  A value "in the
compute type" is held in f32 and rounded by :func:`frames.rounder` after
each operation, which is bitwise what PyTorch's bf16 elementwise ops do
(each computes in f32 and rounds once).
"""
