"""Bytes copied from the host to the device per batch: the program's
``stats_out["h2d_bytes"]`` (the padded centers and their embedding, per
segment in the segmented engine, and every streamed segment's rows and
order map), summed over the traced batches."""

from benchmark import spans


def read(ctx):
    return spans.counter_per_batch(ctx, "h2d_bytes")
