"""Bytes copied from the device to the host per batch: the program's
``stats_out["d2h_bytes"]`` (the packed hit buffers, and any re-dispatched
or full fallback buffers), summed over the traced batches."""

from benchmark import spans


def read(ctx):
    return spans.counter_per_batch(ctx, "d2h_bytes")
