"""The whole serving loop's share of the chip's peak: the seconds the
window's work (tdbench/work.py: td products at the int8 peak, attention
and the router at the bf16 peak) takes at peak, over the window's
seconds, in %."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["window_work"].peak_seconds() / ctx["window_s"]
