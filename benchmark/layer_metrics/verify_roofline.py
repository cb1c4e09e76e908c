"""``ptable_verify`` (csrc/ptable_verify.cu) against its roofline, in %:
the least time of the traced calls from their launch shapes
(``roofline.verify_least_s``, bytes fixed by the shapes only) over the
kernel's device time in the trace."""

from benchmark import devtrace, roofline


def read(ctx):
    n, secs = devtrace.kernel_time(ctx.events, "verify_kernel")
    calls = ctx.launches.get("ptable_verify", 0)
    if not n or not secs > 0 or not calls or not ctx.shapes:
        return None
    least = [roofline.verify_least_s(s["C"], s["kb"], s["bs"], s["L"])
             for s in ctx.shapes][:calls]
    least += [min(least)] * max(0, calls - len(least))
    return 100.0 * sum(least) / secs
