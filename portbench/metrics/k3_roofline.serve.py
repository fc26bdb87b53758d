"""Kernels: percent of K3's roofline in the traced call, the least time of
the prefill attention the call's inputs need (causal pairs from the prompt
shapes, a shared prefix once; the larger of its operations at the bf16 peak
and its bytes at the HBM rate) over the device time of K3's kernels."""

from portbench.lib import counts, trace

K3 = ("k3::",)


def read(ctx):
    if ctx.trace is None:
        return None
    spent = trace.kernel_seconds(ctx.trace, K3)
    if not spent:
        return None
    flops, nbytes = counts.prefill_attention(ctx.arch, ctx.work[ctx.traced_index]["forwards"])
    return 100.0 * counts.bound_s(flops, nbytes) / spent
