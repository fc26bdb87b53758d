"""Whole step: percent of the card's bf16 peak, the model operations the
calls' inputs need (the tower over every video, the prefill with a shared
prefix once, every decode step; matrices at 2 per weight a token, the
routed experts' top k only, attention by causal pairs) over the wall time
of the calls that ran without the profiler."""

from portbench.lib import counts


def read(ctx):
    flops = secs = 0.0
    for i in ctx.steady():
        w = ctx.work[i]
        for g in w["grids"]:
            flops += counts.vision_flops(ctx.arch, g)
        pre_tokens = sum(q for q, _ in w["forwards"])
        pre_pairs = sum(counts.causal_pairs(q, kv) for q, kv in w["forwards"])
        flops += counts.decoder_flops(ctx.arch, pre_tokens, pre_pairs, 0)
        dec_tokens = sum(max(n - 1, 0) for n in w["answers"])
        dec_pairs = sum(sum(p + s for s in range(1, n)) for p, n in zip(w["prompts"], w["answers"]))
        flops += counts.decoder_flops(ctx.arch, dec_tokens, dec_pairs, sum(w["answers"]))
        secs += ctx.records[i]["seconds"]
    if not secs:
        return None
    return 100.0 * flops / secs / counts.PEAK_BF16_FLOPS
