"""The ADC count and the bound on shapes worked by hand, and the reading of a
serialized index's sections."""

import json

import numpy as np
import pytest
import torch

from ann_bench import roofline


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12, {}) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, {"f32": 67e12}) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, {"f32": 67e12}) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e13, {"bf16": 989e12, "int8": 1979e12}) == pytest.approx(10.0)


def test_adc_work_by_hand():
    # 2 queries, 3 probes each: sizes (q0: 10, 20, 30; q1: 10, 40, 50); lists probed: 5 of 150 rows
    sizes = np.array([[10, 20, 30], [10, 40, 50]])
    nbytes, ops = roofline.adc_work(sizes, n_lists_probed=5, lists_code_rows=150, nq=2, d=8, m=4, ksub=16,
                                    nbits=8, n_out=6)
    lut = 2 * 16 * 8 * 2 + 2 * 3 * 4 * 16  # queries x ksub x d multiply-adds; (query, list) pairs x m x ksub adds
    scan = 160 * 4  # probed rows x m table additions
    assert ops == {"f32": float(lut + scan)}
    # codes, queries, 5 lists' centroids and (m, ksub) terms, codebooks, candidates
    want = 150 * 4 + 2 * 8 * 4 + 5 * 8 * 4 + 5 * 4 * 16 * 4 + 4 * 16 * 2 * 4 + 2 * 6 * 8
    assert nbytes == pytest.approx(want)
    nb4, _ = roofline.adc_work(sizes, 5, 150, 2, 8, 4, 16, 4, 6)  # 4-bit codes: half the code bytes
    assert want - nb4 == pytest.approx(150 * 4 / 2)


def test_adc_request_bound_uses_its_own_probe():
    cents = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]])
    sizes = torch.tensor([100, 200, 300])
    xq = torch.tensor([[9.0, 0.0], [0.0, 9.0]])  # probe lists (1, 0) and (2, 0)
    got = roofline.adc_request_bound_s(xq, cents, sizes, nprobe=2, m=2, ksub=4, nbits=8, n_out=3)
    nbytes, ops = roofline.adc_work(np.array([[200, 100], [300, 100]]), 3, 600, 2, 2, 2, 4, 8, 3)
    assert got == pytest.approx(roofline.bound_s(nbytes, ops))


def test_coarse_probe_equals_numpy():
    rng = np.random.default_rng(1)
    q, c = rng.standard_normal((30, 16)).astype(np.float32), rng.standard_normal((64, 16)).astype(np.float32)
    got = roofline.coarse_probe(torch.from_numpy(q), torch.from_numpy(c), 5).numpy()
    d = ((q[:, None, :].astype(np.float64) - c[None]) ** 2).sum(2)
    assert np.array_equal(np.sort(got, 1), np.sort(np.argsort(d, 1)[:, :5], 1))


def test_read_sections_of_a_hand_built_blob():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = np.array([5, 7], dtype=np.int64)
    header = {"format_version": 1, "meta": {"pq_nbits": 8},
              "sections": {"centroids": {"offset": 1024, "nbytes": a.nbytes, "dtype": "float32", "shape": [3, 4]},
                           "lengths": {"offset": 1088, "nbytes": b.nbytes, "dtype": "int64", "shape": [2]},
                           "rows": {"offset": 1152, "nbytes": 4, "dtype": "bfloat16", "shape": [2]}}}
    h = json.dumps(header).encode()
    blob = bytearray(1160)
    blob[:6] = b"KWTPU\x01"
    blob[6:10] = np.uint32(len(h)).tobytes()
    blob[10 : 10 + len(h)] = h
    blob[1024 : 1024 + a.nbytes] = a.tobytes()
    blob[1088 : 1088 + b.nbytes] = b.tobytes()
    arrays, meta = roofline.read_sections(bytes(blob))
    assert meta == {"pq_nbits": 8} and set(arrays) == {"centroids", "lengths"}
    assert np.array_equal(arrays["centroids"], a) and np.array_equal(arrays["lengths"], b)
    with pytest.raises(ValueError):
        roofline.read_sections(b"NOPE" + bytes(blob[4:]))
