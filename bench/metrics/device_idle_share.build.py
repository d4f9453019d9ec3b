"""device_idle_share.build: the share of the traced window in which no
kernel, copy or memset ran on the card."""


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - run.trace.busy_s() / (hi - lo))
