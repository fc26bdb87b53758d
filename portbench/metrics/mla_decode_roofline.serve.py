"""Kernels: percent of the absorbed decode attention's roofline in the
traced call, the least time its decode steps' attention needs (each live
row's visible latent columns once, its queries and outputs; operations
2 x heads x (576 + 512) per row, key and layer: ``counts_mla``) over the
device time of the MLA decode kernels (``o3v_mla_decode`` and its
combine). Nothing where the program has no such kernel."""

from portbench.lib import counts_mla, trace

MARKS = ("o3v_mla_decode",)


def read(ctx):
    if ctx.trace is None:
        return None
    spent = trace.kernel_seconds(ctx.trace, MARKS)
    if not spent:
        return None
    w = ctx.work[ctx.traced_index]
    least = 0.0
    for s in range(1, max(w["answers"], default=0)):
        live = [p + s for p, n in zip(w["prompts"], w["answers"]) if n > s]
        least += counts_mla.bound_s(*counts_mla.decode_attention(ctx.arch, live))
    return 100.0 * least / spent
