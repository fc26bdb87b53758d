"""Device: percent of the traced call's wall time in which no kernel ran
(one less the union of the kernels' intervals over the call)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
