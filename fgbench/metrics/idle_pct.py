"""% of the traced window in which no kernel, copy or fill ran on the
device."""


def read(t):
    busy = t.busy_s()
    if t.window[1] <= 0 or busy <= 0:
        return None     # the trace recorded no device activity
    return (1.0 - busy / t.window[1]) * 100.0
