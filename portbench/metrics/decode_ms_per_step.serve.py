"""Decode loop: milliseconds a decode step, the engine's ``decode`` stage
(its eager first step and graph capture included) over the decode steps the
calls ran, wasted ones included, in the calls that ran without the
profiler."""


def read(ctx):
    recs = [ctx.records[i] for i in ctx.steady()]
    steps = sum(r["decode_steps"] for r in recs)
    if not steps:
        return None
    return 1e3 * sum(r["stages"].get("decode", 0.0) for r in recs) / steps
