"""Output frames the sink received inside the window, over the window's
length (closed-loop mixes)."""


def read(r):
    if r.source.fps > 0:
        return None
    end = r.t0 + r.seconds
    return sum(1 for t in r.sink.times if t <= end) / r.seconds
