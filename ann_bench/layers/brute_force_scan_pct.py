"""brute_force_scan_pct: the share of the exact fallback's stored rows that it
scanned (`hnsw.brute_force_rows_scanned` over `hnsw.brute_force_rows_stored`:
queries times rows scanned, and queries times rows stored, each fallback
call of models/hnsw.py), over the profiled part's complete requests, in
percent. Under a bitset that keeps at most half of the rows the fallback
scans the kept rows alone; else every row."""

from ann_bench import spans


def read(ctx):
    return spans.counter_pct(ctx, "hnsw.brute_force_rows_scanned", "hnsw.brute_force_rows_stored")
