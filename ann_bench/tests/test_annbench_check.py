"""The arithmetic of the end-to-end metrics and of the comparison, on values
worked by hand."""

import numpy as np
import pytest
import torch

from ann_bench import check


@pytest.mark.parametrize("values,expected", [
    (list(range(1, 101)), 95),  # 95 of 100 values at or below 95
    (list(range(1, 21)), 19),  # ceil(0.95 * 20) = 19th smallest
    ([5.0], 5.0),
    ([3.0, 1.0, 2.0], 3.0),  # ceil(2.85) = 3rd smallest
    (list(range(200, 0, -1)), 190),  # order does not matter
])
def test_p95_nearest_rank(values, expected):
    assert check.p95(values) == expected


def test_recall_hits():
    truth = torch.tensor([[1, 2, 3], [4, 5, 6]])
    ids = torch.tensor([[3, 9, 1], [6, 5, 4]])
    assert check.recall_hits(ids, truth) == 5  # 2 of the first row, 3 of the second
    assert check.recall_hits(ids, torch.tensor([[1, -1, -1], [7, 8, -1]])) == 1  # -1 is no truth


def test_bad_entries_counts_each_contract_break():
    nb = 10
    keep = torch.ones(nb, dtype=torch.bool)
    keep[0] = False
    good_ids = torch.tensor([[1, 2, 3]])
    good_d = torch.tensor([[0.5, 1.0, 1.0]])
    assert check.bad_entries(good_ids, good_d, nb, keep, 3) == 0
    cases = [
        (torch.tensor([[1, 2, 10]]), good_d),  # out of range
        (torch.tensor([[1, 2, -1]]), torch.tensor([[0.5, 1.0, float("inf")]])),  # short while rows remain
        (torch.tensor([[0, 2, 3]]), good_d),  # filtered out
        (torch.tensor([[1, 2, 1]]), good_d),  # twice in a row
        (good_ids, torch.tensor([[0.5, float("nan"), 1.0]])),  # not finite
        (good_ids, torch.tensor([[0.5, 2.0, 1.0]])),  # out of order
    ]
    for ids, d in cases:
        assert check.bad_entries(ids, d, nb, keep, 3) == 1, (ids, d)
    # -1 past the kept rows' count is the contract, not a break
    assert check.bad_entries(torch.tensor([[1, -1, -1]]), torch.tensor([[0.5, float("inf"), float("inf")]]),
                             nb, keep, 1) == 0


def test_judge_worked_by_hand():
    xb = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0], [3.0, 0.0]])
    pool = torch.tensor([[0.0, 0.0], [3.0, 0.0]])  # one block of 2 queries
    truth = {0: torch.tensor([[0, 1], [3, 1]])}
    ids = np.array([[0, 1], [3, 2]])  # query 1's second answer is not in its truth
    dists = np.array([[0.0, 1.0], [0.0, 13.0 * 1.01]], dtype=np.float32)  # a 1% error on a returned distance
    out = check.judge([(0, ids, dists)], pool, 2, xb, None, truth, 2, seed=5)
    assert out["bad_answers"] == 0
    assert out["recall_at_10"] == 0.75
    assert out["dist_rel_err"] == pytest.approx(0.01, rel=1e-5)


def test_verdict():
    limits = {"recall_at_10_min": 0.95, "dist_rel_err_max": 1e-4}
    good = {"bad_answers": 0.0, "recall_at_10": 0.97, "dist_rel_err": 1e-6}
    ok, checks = check.verdict(good, 0, limits)
    assert ok and checks["recall_at_10_min"] == [0.97, 0.95] and checks["dist_rel_err_max"] == [1e-6, 1e-4]
    for bad, failed in ((dict(good, recall_at_10=0.94), 0), (dict(good, dist_rel_err=2e-4), 0),
                        (dict(good, bad_answers=1.0), 0), (good, 1)):
        assert not check.verdict(bad, failed, limits)[0]
