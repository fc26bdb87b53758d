"""Decoder prefill: milliseconds a call in the engine's ``prefill`` stage
(prefix blocks, admissions and suffixes; synced on both ends), in the
window's calls that ran without the profiler."""


def read(ctx):
    recs = [ctx.records[i] for i in ctx.steady()]
    if not recs:
        return None
    return 1e3 * sum(r["stages"].get("prefill", 0.0) for r in recs) / len(recs)
