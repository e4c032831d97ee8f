"""layers/brute_force_scan_pct.py on span logs built by hand: the share of
the stored rows the exact fallback scanned, over the trace's requests only,
and None where no fallback counted (the inline walk, or a program without
the counters)."""

import pytest

from ann_bench.tests.test_annbench_tracing_layers import ctx, read, rec, store  # noqa: F401


def fallback_log(scanned_per_request):
    """One 10,000-query request a window, each a fallback over 1M stored
    rows that scanned the given rows (None: a walk, no fallback)."""
    out = []
    for i, rows in enumerate(scanned_per_request):
        root = 100 * (i + 1)
        t0 = 11 + 40 * i if i < 2 else 81
        out.append(rec(root, "knowhere_search", t0, t0 + 10))
        if rows is None:
            out.append(rec(root + 1, "graph_inline.walk", t0 + 1, t0 + 9, parent=root, root=root))
        else:
            out.append(rec(root + 1, "hnsw.brute_force", t0 + 1, t0 + 9, parent=root, root=root,
                           **{"hnsw.brute_force_rows_scanned": 10_000 * rows,
                              "hnsw.brute_force_rows_stored": 10_000 * 1_000_000}))
    return out


def test_scan_share_over_the_requests_only(store):
    store["log"] = fallback_log([10_000, 30_000, 1_000_000])  # request 2 is outside the trace
    assert read("brute_force_scan_pct", ctx()) == pytest.approx(100 * 40_000 / 2_000_000)


@pytest.mark.parametrize("scanned", [[None, None], [None]])
def test_scan_share_is_none_without_a_fallback_count(store, scanned):
    store["log"] = fallback_log(scanned)
    assert read("brute_force_scan_pct", ctx(requests=tuple(range(len(scanned))))) is None
