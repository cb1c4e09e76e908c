"""Host milliseconds per batch in ``ivf.search``'s preparation of the
centers (the ``ivf.centers`` spans): embedding, padding to whole center
blocks and the upload; once per segment in the segmented engine."""

from benchmark import spans


def read(ctx):
    return spans.span_ms_per_batch(ctx, "ivf.centers")
