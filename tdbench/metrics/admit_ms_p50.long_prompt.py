"""Median host time of an admission (bucketed prefill and insert, to
the token read) over the admissions whose first token fell in the
window: the engine's own `admit_ms`."""
import statistics


def read(ctx):
    v = ctx["admit_ms"]
    return statistics.median(v) if v else None
