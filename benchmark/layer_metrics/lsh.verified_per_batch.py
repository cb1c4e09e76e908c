"""Distinct database ids the LSH verify read per batch: the program's
``stats_out["cand_distinct"]`` (over the real centers, carried in the
packed buffer's meta), summed over the traced batches."""

from benchmark import spans


def read(ctx):
    return spans.counter_per_batch(ctx, "cand_distinct")
