"""The program's spans, frame by frame.

The engine opens one span of each of ``tpufg.ingest``, ``tpufg.step`` and
``tpufg.readback`` for every input frame, in the frame's order, so the
k-th span of each name in a run belongs to input frame k (a
``record_function`` span carries no frame number).  The readers here sort
each name's spans by start and pair them by that ordinal, over the frames
that every name they read has.  Times are seconds on the trace's clock;
results are ms, or None where a span is missing.

The program's frames are paired only where it opens ``tpufg.ingest``
spans: before those, its first ``tpufg.readback`` span was an empty flush
and the last flush had none, so readback k was frame k - 1's hand-over.
"""

from __future__ import annotations

# the span whose presence says that the program spans one readback a frame
PER_FRAME = "tpufg.ingest"


def ordered(t, name: str) -> list:
    """``name``'s spans in ``t`` as (start, end), by start."""
    return sorted((s, s + d) for s, d in t.spans.get(name, []))


def mean_ms(t, name: str):
    """Mean host ms of one ``name`` span, a frame's time in it."""
    spans = t.spans.get(name)
    return sum(d for _, d in spans) / len(spans) * 1e3 if spans else None


def wait_ms(t, first: str, then: str):
    """Mean over frames k of the start of ``then``'s k-th span less the
    end of ``first``'s k-th span: how long a frame waited between them."""
    if PER_FRAME not in t.spans:
        return None
    a, b = ordered(t, first), ordered(t, then)
    n = min(len(a), len(b))
    if not n:
        return None
    return sum(b[k][0] - a[k][1] for k in range(n)) / n * 1e3
