"""Share of the segment uploads' copy time that lies under running
kernels: how much of ``upload_segment``'s side-stream upload the search
hides.  Only the host-to-device copies on the stream that runs the
bounds pass (``bounds_kernel``, queued after each upload on the same
side stream) count, not ``ivf.search``'s own uploads of the centers."""

from benchmark import devtrace


def read(ctx):
    got = devtrace.stream_copies_under_kernels(ctx.events, "bounds_kernel")
    if got is None or not got[0] > 0:
        return None
    return got[1] / got[0]
