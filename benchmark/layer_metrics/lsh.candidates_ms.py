"""Device milliseconds per batch of the LSH candidate path: the kernels
whose launch lies inside an ``lsh.candidates`` span (the searchsorted
probes of every table, the gather of up to cand_max ids per probed
bucket and the dedup sort), matched to their launch by the trace's
``correlation`` id."""

from benchmark import spans


def read(ctx):
    return spans.kernel_ms_per_batch(ctx, "lsh.candidates")
