"""flash_attn's share of its roofline in the profiled sub-window: the
least time the admissions' causal attention over their real prompt rows
needs (bf16 q, K, V and output once; 4 D flops a kept pair at the bf16
peak) over the device time of its kernels, in %."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr["family_s"]["flash_attn"] <= 0:
        return None
    return 100.0 * ctx["trace_work"].flash_min_s / tr["family_s"]["flash_attn"]
