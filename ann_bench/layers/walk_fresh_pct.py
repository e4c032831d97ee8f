"""walk_fresh_pct: the share of the inline walk's scored candidates that
were fresh, neither visited nor in the beam (`graph_inline.fresh` over
`graph_inline.scored`: every query row times W x degree a step run, in
ops/graph_inline.py), over the profiled part's complete requests, in
percent."""

from ann_bench import spans


def read(ctx):
    return spans.counter_pct(ctx, "graph_inline.fresh", "graph_inline.scored")
