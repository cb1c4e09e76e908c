"""``sq_distance_prune`` (csrc/prune.cu) against its roofline, in %: the
least time of the traced calls, counted from each call's launch shape
(``roofline.prune_least_s``), over the kernel's device time in the
trace.  Launches past the shapes the engine names for its batches (a
capacity re-dispatch) are counted at the smallest shape."""

from benchmark import devtrace, roofline


def read(ctx):
    n, secs = devtrace.kernel_time(ctx.events, "prune_kernel")
    calls = ctx.launches.get("sq_distance_prune", 0)
    if not n or not secs > 0 or not calls or not ctx.shapes:
        return None
    least = [roofline.prune_least_s(s["C"], s["B"], s["D"])
             for s in ctx.shapes][:calls]
    least += [min(least)] * max(0, calls - len(least))
    return 100.0 * sum(least) / secs
