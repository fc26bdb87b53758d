"""Decode loop: percent of its memory floor, the least time the decode
steps could take (every decoder weight read once a step, and each live
row's keys and values once, at the card's HBM rate) over the engine's
``decode`` stage, in the calls that ran without the profiler."""

from portbench.lib import counts


def read(ctx):
    least = spent = 0.0
    weights = counts.text_weight_bytes(ctx.arch)
    kv = counts.kv_bytes_per_token(ctx.arch)
    for i in ctx.steady():
        w = ctx.work[i]
        for s in range(1, max(w["answers"], default=0)):
            live = [p + s for p, n in zip(w["prompts"], w["answers"]) if n > s]
            least += (weights + kv * sum(live)) / counts.PEAK_HBM_BYTES_PER_S
        spent += ctx.records[i]["stages"].get("decode", 0.0)
    if not spent or not least:
        return None
    return 100.0 * least / spent
