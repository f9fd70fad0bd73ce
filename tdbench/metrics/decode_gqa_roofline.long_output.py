"""decode_gqa's share of its roofline in the profiled sub-window: the
least time the decode steps' attention needs (each occupied row's live
K and V prefix and its q and output in bf16, once) over the device time
of its kernels, in %."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr["family_s"]["decode_gqa"] <= 0:
        return None
    return 100.0 * ctx["trace_work"].decode_min_s / tr["family_s"]["decode_gqa"]
