"""Decode loop: percent of a mixture model's decode memory floor, as
``decode_roofline.serve`` takes it (each live row's keys and values and the
decoder weights read once a step at the card's HBM rate, over the engine's
``decode`` stage in the calls that ran without the profiler), with the
routed experts counted at the experts a step read: the traced call's
``expert_reads`` over its ``moe_layer_steps`` (distinct experts per layer
and step), not all of them. Nothing where the program has no such
counters."""

from portbench.lib import counts


def read(ctx):
    t = ctx.arch.text
    if ctx.traced_index is None or not t.experts:
        return None
    c = ctx.records[ctx.traced_index]["counters"]
    if not c.get("moe_layer_steps"):
        return None
    unread = t.experts - c.get("expert_reads", 0) / c["moe_layer_steps"]
    weights = (counts.text_weight_bytes(ctx.arch)
               - counts.BF16 * t.layers * unread * 3 * t.hidden * t.moe_inter)
    kv = counts.kv_bytes_per_token(ctx.arch)
    least = spent = 0.0
    for i in ctx.steady():
        w = ctx.work[i]
        for s in range(1, max(w["answers"], default=0)):
            live = [p + s for p, n in zip(w["prompts"], w["answers"]) if n > s]
            least += (weights + kv * sum(live)) / counts.PEAK_HBM_BYTES_PER_S
        spent += ctx.records[i]["stages"].get("decode", 0.0)
    if not spent or not least:
        return None
    return 100.0 * least / spent
