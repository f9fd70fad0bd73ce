"""td_vmm's share of its roofline in the profiled sub-window: the least
time its products need (tdbench/work.py, per call the larger of
operations at the int8 peak and least bytes at the HBM rate) over the
device time of its kernels, in %."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr["family_s"]["td_vmm"] <= 0:
        return None
    return 100.0 * ctx["trace_work"].td_min_s / tr["family_s"]["td_vmm"]
