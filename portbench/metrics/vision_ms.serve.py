"""Vision tower: milliseconds a tower pass, the engine's ``vision`` stage
(synced on both ends) over its ``tower_passes``, in the window's calls that
ran without the profiler."""


def read(ctx):
    recs = [ctx.records[i] for i in ctx.steady()]
    passes = sum(r["counters"].get("tower_passes", 0) for r in recs)
    if not passes:
        return None
    return 1e3 * sum(r["stages"].get("vision", 0.0) for r in recs) / passes
