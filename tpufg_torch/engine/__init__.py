"""Per-frame steps and the streaming engine of the port.

Unlike ``tpufg.engine``, importing this package imports nothing: pull
what you need from ``tpufg_torch.engine.pipeline`` / ``.runner``.
"""
