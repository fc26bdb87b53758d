"""Decode loop: the host's own milliseconds a decode step, the engine's
``decode`` stage less the seconds it spent blocked on the card in it
(``decode_wait``: closing syncs, done-flag event waits, readbacks) and less
its graph captures (``decode_capture``), over the decode steps run, in the
calls that ran without the profiler. Nothing where the program does not
count ``decode_wait``."""


def read(ctx):
    recs = [ctx.records[i] for i in ctx.steady()]
    steps = sum(r["decode_steps"] for r in recs)
    if not steps or not any("decode_wait" in r["stages"] for r in recs):
        return None
    own = sum(r["stages"].get("decode", 0.0) - r["stages"].get("decode_wait", 0.0)
              - r["stages"].get("decode_capture", 0.0) for r in recs)
    return 1e3 * own / steps
