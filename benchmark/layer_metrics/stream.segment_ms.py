"""Mean wall time of one segment's search in ``search_segmented``'s host
loop: the program's own ``stats_out["seg_walls_s"]`` over the traced
window's batches."""


def read(ctx):
    walls = [w for st in ctx.stats for w in st.get("seg_walls_s", ())]
    if not walls:
        return None
    return 1e3 * sum(walls) / len(walls)
