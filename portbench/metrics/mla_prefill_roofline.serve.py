"""Kernels: percent of the expanded prefill attention's roofline in the
traced call, the least time the call's prefill attention needs (causal
pairs of the shared video prefix once and of each prompt's suffix, 16
heads, 2 x (192 + 128) operations a pair and layer, its q, k, v and output
bytes: ``counts_mla``) over the device time of ``o3v_mla_prefill``.
Nothing where the program has no such kernel."""

from portbench.lib import counts_mla, trace

MARKS = ("o3v_mla_prefill",)


def read(ctx):
    if ctx.trace is None:
        return None
    spent = trace.kernel_seconds(ctx.trace, MARKS)
    if not spent:
        return None
    flops, nbytes = counts_mla.prefill_attention(ctx.arch, ctx.work[ctx.traced_index]["forwards"])
    return 100.0 * counts_mla.bound_s(flops, nbytes) / spent
