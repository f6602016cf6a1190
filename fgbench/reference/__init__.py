"""The plain references that decide a run's ``correct``.

A configuration names its reference module, ``fgbench/reference/<name>.py``,
under the key ``reference`` (``steps``, configs 4 and 5's, where it names
none); ``fgbench/spec.py`` finds it by that name.  A reference module
exposes ``make(config, precision, device, root)``: it reads the
configuration as its file states it, and the weights file that names
(``checkpoint``) relative to ``root`` with its own reader, and returns an
object with

- ``first(frame)``: the stream's first frame's outputs, as a list;
- ``pair(prev, curr)``: the in-between frames and curr, in time order;
- ``wire(out, sink_wire)``: an output as the sink takes it on that wire
  (``rgba``, ``y4m420``, ``y4m444``).

Frames come as uint8 [H, W, 4] tensors on ``device``; outputs are uint8.
``precision`` is ``"bf16"``, what the configurations state, for the check,
and ``"fp8"`` (float8 e4m3, saturating) for the control, the step below it
that a later change could be tempted to take.

Plain PyTorch and NumPy only: nothing here imports ``jax``, ``tpufg`` or
``tpufg_torch``, and nothing takes a tensor, table or weight the program
made; a module imports only plain libraries and ``fgbench.reference``'s
own modules.  It recomputes, from the frames the benchmark made and the
weights file, what each timed step should have handed to the sink.

The arithmetic of ``steps`` and the modules it uses (``frames``,
``motion``, ``head``) is frozen from the port's plain paths (the versions
its kernels are held to), one rounding per operation, with the compute
type as a parameter.  A value "in the compute type" is held in f32 and
rounded by :func:`frames.rounder` after each operation, which is bitwise
what PyTorch's bf16 elementwise ops do (each computes in f32 and rounds
once).
"""
