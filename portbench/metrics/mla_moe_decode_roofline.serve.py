"""Decode loop: percent of Kimi-VL's decode memory floor, as
``moe_decode_roofline.serve`` takes a mixture model's: every decode step
reads once the attention projections, the dense layer, the shared experts,
the routers, the lm_head and the routed experts a step read (the traced
call's ``expert_reads`` over its ``moe_layer_steps``, distinct experts a
layer and step), and each live row's latent cache, at the card's HBM
rate, over the engine's ``decode`` stage in the calls that ran without the
profiler. Nothing where the program has no such counters."""

from portbench.lib import counts, counts_mla


def read(ctx):
    if ctx.traced_index is None:
        return None
    c = ctx.records[ctx.traced_index]["counters"]
    if not c.get("moe_layer_steps"):
        return None
    weights = counts_mla.text_weight_bytes(ctx.arch, c.get("expert_reads", 0)
                                           / c["moe_layer_steps"])
    per_token = counts_mla.latent_bytes_per_token(ctx.arch)
    least = spent = 0.0
    for i in ctx.steady():
        w = ctx.work[i]
        for s in range(1, max(w["answers"], default=0)):
            live = [p + s for p, n in zip(w["prompts"], w["answers"]) if n > s]
            least += (weights + per_token * sum(live)) / counts.PEAK_HBM_BYTES_PER_S
        spent += ctx.records[i]["stages"].get("decode", 0.0)
    if not spent or not least:
        return None
    return 100.0 * least / spent
