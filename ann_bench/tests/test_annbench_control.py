"""Each cell's control in the program's place, at a tiny size on the CPU:
the comparison has to find it not correct by the number its limit was set
for, where the program passes that number. On the chip at the cells' own
size, `python3 ann_bench/readings.py --workload <cell> --control-seeds ...`
reads the same (PERF.md). The requests carry 1,000 queries: the widest gap
is a maximum, and fewer queries read less of the control's."""

import pytest

from ann_bench import readings
from ann_bench.tests import tiny

SEED = 3 * 10**9 + 17


@pytest.mark.parametrize("name", ["sift1m-hnsw.bulk", "sift1m-ivf_pq.bulk", "sift1m-hnsw.filter99"])
def test_control_fails_where_the_program_passes(name):
    w = tiny.workload(name, nq=1000)
    program = readings.reading(w, SEED, 1.0, "cpu", control=False)
    control = readings.reading(w, SEED, 1.0, "cpu", control=True)
    value, limit = program["checks"]["dist_rel_err_max"]
    assert value <= limit
    value, limit = control["checks"]["dist_rel_err_max"]
    assert value > limit and not control["correct"]
