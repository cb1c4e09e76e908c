"""Device milliseconds per batch that the search's stream stalled on the
segment uploads: the program's ``stats_out["upload_wait_ms"]`` (CUDA
events on the search's stream around each wait for the upload stream,
recorded while a trace records), summed over the traced batches."""

from benchmark import spans


def read(ctx):
    return spans.counter_per_batch(ctx, "upload_wait_ms")
