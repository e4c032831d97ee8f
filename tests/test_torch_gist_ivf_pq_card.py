"""GIST1M IVF_PQ at its published scale on a CUDA card: the benchmark's
`gist1m-ivf_pq` configuration (ann_bench/configs/gist1m-ivf_pq.json: 1M x
960 rows, nlist 1024, m 96, nbits 8, OPQ, FP16 refine, its nprobe and
refine_k, FAST precision) built and searched through the factory and
`Index.Search`, as the benchmark's harness does.

- The ADC kernel at the cell's task shape (the first launch of a
  1,000-query request: SUB 10, 24 LUT chunks of 4 subspaces, d 1,024)
  against its plain version, `adc_cuda.adc_scan_plain`, on the same inputs:
  scores within 1e-3 relative + 1e-2, positions equal on 99% of the slots
  (chip_smoke.py's ADC tolerance: an entry near a bf16 midpoint may round
  the other way in the kernel's order), the empty slots exactly.
- The whole search against the plain reference (ann_bench/ivf_pq_plain.py)
  on 256 queries of each of 3 seeds, under tests/ivf_pq_plain_checks.py's
  tolerances, the CPU test's (tests/test_torch_gist_ivf_pq.py).

Each test is marked ``card`` and skips without a CUDA device, deciding
inside the test. The file imports no JAX. On a machine with a card, from the
root of a checkout (about five minutes, most of it the build):

    python -m pytest --noconftest -p no:cacheprovider -o "markers=card" -q -s tests/test_torch_gist_ivf_pq_card.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import knowhere_tpu_torch as ktt
from ann_bench import data, ivf_pq_plain
from knowhere_tpu_torch.ops import adc_cuda, ivf_scan

from . import ivf_pq_plain_checks as checks

pytestmark = pytest.mark.card

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "ann_bench" / "configs" / "gist1m-ivf_pq.json").read_text())
SEARCH = dict(CONFIG["search"], metric_type=CONFIG["metric"], k=10)
SEEDS = (2_147_483_701, 2_147_483_759, 2_147_484_001)
ADC_RTOL, ADC_ATOL, ADC_POS_AGREE = 1e-3, 1e-2, 0.99


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def built():
    """(index, plain reference's copy) of the configuration at full size."""
    dev = _cuda()
    ktt.set_device(dev)
    ktt.KnowhereConfig.SetSimdType(CONFIG["simd_type"])
    xb, _ = data.mixture(CONFIG["corpus"], CONFIG["nb"], 1, SEEDS[0])
    idx = ktt.IndexFactory.Instance().Create(CONFIG["index_type"]).value()
    assert idx.Build(ktt.GenDataSetFromArray(xb), dict(CONFIG["build"], metric_type=CONFIG["metric"])) == ktt.Status.success
    del xb
    assert idx.node._scan_plan(SEARCH["k"], SEARCH["refine_k"]).route == "adc" and idx.node._d_dev == 1024
    bs = ktt.BinarySet()
    assert idx.Serialize(bs) == ktt.Status.success
    plain = ivf_pq_plain.load(bytes(bs.GetByName("IVF_PQ").data), dev)
    del bs
    yield idx, plain


def _queries(seed: int, n: int) -> np.ndarray:
    return data.mixture(CONFIG["corpus"], 1, n, seed)[1]


def test_adc_kernel_at_the_cells_task_shape(built):
    idx, _ = built
    held = []
    real = ivf_scan.adc_scan_tasks

    def hold(*args, **kw):
        s_k, p_k = real(*args, **kw)
        if not held:
            held.append((args, kw, s_k, p_k))
        return s_k, p_k

    ivf_scan.adc_scan_tasks = hold
    try:
        checks.port_search(idx, _queries(SEEDS[1], 1000), SEARCH)
    finally:
        ivf_scan.adc_scan_tasks = real
    args, kw, s_k, p_k = held[0]
    q_task, books = args[3], args[4]
    assert q_task.shape[1:] == (128, 1024) and tuple(books.shape) == (96, 256, 10)
    s_p, p_p = adc_cuda.adc_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    empty = p_p == -1
    same = int((p_k == p_p).sum()) / p_k.numel()
    err = float((s_k - s_p).abs().max())
    print(f"adc kernel at the cell's task shape: tasks {q_task.shape[0]}, empty {int((args[1] <= 0).sum())}, "
          f"max abs error {err}, positions {same}")
    assert torch.allclose(s_k, s_p, rtol=ADC_RTOL, atol=ADC_ATOL) and same >= ADC_POS_AGREE
    assert torch.equal(p_k == -1, empty) and bool((s_k[empty] == -1e38).all())


@pytest.mark.parametrize("seed", SEEDS)
def test_search_matches_the_plain_reference(built, seed):
    idx, plain = built
    xq = _queries(seed, 256)
    port = checks.port_search(idx, xq, SEARCH)
    d, i, stages = ivf_pq_plain.search(plain, torch.from_numpy(xq).to(plain.centroids.device), SEARCH["k"],
                                       SEARCH["nprobe"], SEARCH["refine_k"])
    numbers = checks.compare(plain, xq, port, (d, i), stages, SEARCH["k"])
    print(f"seed {seed}: {json.dumps(numbers)}")
    assert checks.failed(numbers) == [], numbers
