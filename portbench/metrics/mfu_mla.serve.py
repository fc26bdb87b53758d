"""Whole step: percent of the card's bf16 peak in Kimi-VL's session calls,
the model operations the calls' inputs need (``counts_mla``: the tower
over every video, the prefill with the shared video prefix once and its
attention in the expanded form, every decode step at 2 per active weight
and its attention at 2 x 16 x (192 + 128) a pair, the lm_head a token)
over the wall time of the calls that ran without the profiler."""

from portbench.lib import counts, counts_mla


def read(ctx):
    flops = secs = 0.0
    for i in ctx.steady():
        w = ctx.work[i]
        for g in w["grids"]:
            flops += counts_mla.vision_flops(ctx.arch, g)
        pre_tokens = sum(q for q, _ in w["forwards"])
        pre_pairs = sum(counts.causal_pairs(q, kv) for q, kv in w["forwards"])
        flops += counts_mla.decoder_flops(ctx.arch, pre_tokens, pre_pairs, 0)
        dec_tokens = sum(max(n - 1, 0) for n in w["answers"])
        dec_pairs = sum(sum(p + s for s in range(1, n)) for p, n in zip(w["prompts"], w["answers"]))
        flops += counts_mla.decoder_flops(ctx.arch, dec_tokens, dec_pairs, sum(w["answers"]))
        secs += ctx.records[i]["seconds"]
    if not secs:
        return None
    return 100.0 * flops / secs / counts.PEAK_BF16_FLOPS
