"""Median host time of a decode step (to its token read) over the
window's steps: the engine's own `decode_ms`."""
import statistics


def read(ctx):
    v = ctx["decode_ms"]
    return statistics.median(v) if v else None
