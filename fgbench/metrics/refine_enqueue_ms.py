"""Host ms an interpolated frame in the IFNet step's
``tpufg.step.context`` (the new frame's Contextnet convs) and
``tpufg.step.refine`` (the 8 feature warps, the U-Net, the merge, clamp
and crop) spans, as launched: their total over the ``tpufg.step.refine``
spans' count."""


def read(t):
    refine = t.spans.get("tpufg.step.refine")
    if not refine:
        return None
    total = t.span_total_s("tpufg.step.context") + t.span_total_s(
        "tpufg.step.refine")
    return total / len(refine) * 1e3
