"""Scheduler: percent of the admitted prompt tokens that no prefill forward
computed (a prefix block served them), 100 x (1 - the engine's
``prefill_tokens`` / its ``prompt_tokens``), in the calls that ran without
the profiler. Nothing where the program has no such counters."""


def read(ctx):
    recs = [ctx.records[i] for i in ctx.steady()]
    prompt = sum(r["counters"].get("prompt_tokens", 0) for r in recs)
    if not prompt:
        return None
    return 100.0 * (1.0 - sum(r["counters"].get("prefill_tokens", 0) for r in recs) / prompt)
