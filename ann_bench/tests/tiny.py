"""Tiny copies of the cells for CPU runs of the harness: the cells' own
traffic shape and limits, over 3,000 rows and 200-query requests (IVF_PQ at
nlist 16, nprobe 4). Their recall is not the full size's, so the tests that
run them judge the compared numbers one by one."""

import copy

from ann_bench import spec

NB, NQ, BLOCKS = 3000, 200, 3


def workload(name: str, **cell):
    w = spec.load_workload(spec.load_benchmark(), name)
    w.config = copy.deepcopy(w.config)
    w.cell = copy.deepcopy(w.cell)
    w.config["nb"] = NB
    if "nlist" in w.config["build"]:
        w.config["build"]["nlist"] = 16
        w.config["search"]["nprobe"] = 4
    w.cell.update(dict(nq=NQ, pool_blocks=BLOCKS), **cell)
    if w.cell["filter"]:
        w.cell["filter"] = {"drop_id_below_share": 0.95}
    return w
