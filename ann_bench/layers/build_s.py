"""build_s: seconds of the index's Build on the host's clock, ending in a
device synchronise (models/hnsw.py, models/ivf.py Build)."""


def read(ctx):
    return ctx.build_s
