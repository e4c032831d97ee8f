"""The port's foundation layer: import hygiene, Status parity on misuse
probes, the index registry, and KWTPU sections crossing packages."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import knowhere_tpu as kt
import knowhere_tpu_torch as ktt
from knowhere_tpu.io import serialize as jser
from knowhere_tpu_torch.io import serialize as tser

torch.set_num_threads(2)
ktt.set_device("cpu")


def test_import_does_not_pull_in_jax():
    code = (
        "import sys, knowhere_tpu_torch, knowhere_tpu_torch.ops.ivf_scan, "
        "knowhere_tpu_torch.ops.cuda_flat, knowhere_tpu_torch.parallel.sharding\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'knowhere_tpu' or m.startswith('knowhere_tpu.')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_status_enum_matches_reference():
    assert [(s.name, int(s)) for s in ktt.Status] == [(s.name, int(s)) for s in kt.Status]


def test_only_flat_and_ivf_flat_registered():
    """The names the port registers: the FLAT and IVF families, the HNSW
    family, the SVS names, the CAGRA / cuVS names, the DISKANN family, the
    sparse family, SCANN_DVR, MINHASH_LSH, FAISS and the SHARDED_* names
    (named when FLAT and IVF_FLAT were all)."""
    names = {name for name, _ in ktt.IndexFactory.Instance()._registry}
    assert names == {
        "FLAT", "BIN_FLAT", "BINFLAT", "TPU_BRUTE_FORCE", "GPU_CUVS_BRUTE_FORCE", "GPU_BRUTE_FORCE",
        "GPU_FAISS_FLAT", "IVF_FLAT", "IVF_FLAT_CC", "GPU_FAISS_IVF_FLAT", "IVF_PQ", "GPU_FAISS_IVF_PQ",
        "SCANN", "IVF_SQ8", "IVF_SQ_CC", "GPU_FAISS_IVF_SQ8", "IVF_RABITQ", "IVF_RABITQ_FASTSCAN",
        "BIN_IVF_FLAT", "IVFBIN", "HNSW", "HNSW_SQ", "HNSW_PQ", "HNSW_PRQ",
        "SVS_FLAT", "SVS_VAMANA", "SVS_VAMANA_LVQ", "SVS_VAMANA_LEANVEC", "HNSWLIB_DEPRECATED", "HNSW_DEPRECATED",
        "GPU_CUVS_CAGRA", "GPU_CAGRA", "TPU_CAGRA", "GPU_CUVS_IVF_FLAT", "GPU_IVF_FLAT", "TPU_IVF_FLAT",
        "GPU_CUVS_IVF_PQ", "GPU_IVF_PQ", "TPU_IVF_PQ", "DISKANN", "DISKANN_DEPRECATED", "AISAQ",
        "SPARSE_INVERTED_INDEX", "SPARSE_WAND", "SPARSE_INVERTED_INDEX_CC", "SPARSE_WAND_CC",
        "SCANN_DVR", "MINHASH_LSH", "FAISS",
        "SHARDED_FLAT", "SHARDED_IVF_FLAT", "SHARDED_IVF_SQ8", "SHARDED_IVF_PQ", "SHARDED_HNSW",
    }


def _probe(pkg, name, action):
    """Run one misuse probe in a package and return its Status name."""
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((2000, 32)).astype(np.float32)
    created = pkg.IndexFactory.Instance().Create(name)
    if not created.has_value():
        return created.error().name
    idx = created.value()
    ds = pkg.GenDataSetFromArray(xb)
    if action == "bad_metric":
        return idx.Build(ds, {"metric_type": "HAMMING", "nlist": 8}).name
    if action == "search_empty":
        res = idx.Search(pkg.GenDataSetFromArray(xb[:2]), {"metric_type": "L2", "k": 5}, pkg.BitsetView())
        return res.error().name
    if action == "serialize_empty":
        return idx.Serialize(pkg.BinarySet()).name
    if action == "empty_binaryset":
        return idx.Deserialize(pkg.BinarySet()).name
    if action == "out_of_range":
        return idx.Build(ds, {"metric_type": "L2", "nlist": 0}).name
    if action == "type_conflict":
        return idx.Build(ds, {"metric_type": "L2", "nlist": "many"}).name
    if action == "metric_mismatch":
        assert idx.Build(ds, {"metric_type": "IP", "nlist": 8}).name == "success"
        res = idx.Search(pkg.GenDataSetFromArray(xb[:2]), {"metric_type": "L2", "k": 5}, pkg.BitsetView())
        return res.error().name
    if action == "bitset_size":
        assert idx.Build(ds, {"metric_type": "L2", "nlist": 8}).name == "success"
        bs = pkg.BitsetView.from_bool_array(np.zeros(10, bool))
        return idx.Search(pkg.GenDataSetFromArray(xb[:2]), {"metric_type": "L2", "k": 5}, bs).error().name
    raise ValueError(action)


@pytest.mark.parametrize(
    "name,action,want",
    [
        ("FLAT", "bad_metric", "invalid_metric_type"),
        ("IVF_FLAT", "bad_metric", "invalid_metric_type"),
        ("FLAT", "search_empty", "empty_index"),
        ("IVF_FLAT", "search_empty", "empty_index"),
        ("FLAT", "serialize_empty", "empty_index"),
        ("IVF_FLAT", "empty_binaryset", "invalid_binary_set"),
        ("FLAT", "empty_binaryset", "invalid_binary_set"),
        ("IVF_FLAT", "out_of_range", "out_of_range_in_json"),
        ("IVF_FLAT", "type_conflict", "type_conflict_in_json"),
        ("IVF_FLAT", "metric_mismatch", "invalid_metric_type"),
        ("IVF_FLAT", "bitset_size", "invalid_args"),
        ("NO_SUCH_INDEX", "search_empty", "invalid_index_error"),
    ],
)
def test_misuse_status_matches_reference(name, action, want):
    assert _probe(ktt, name, action) == want
    assert _probe(kt, name, action) == want


def test_unported_family_gives_unknown_index_status():
    """No family is left unported: SHARDED_FLAT, the last, creates in both
    packages, and an unknown name gives invalid_index_error in both."""
    assert kt.IndexFactory.Instance().Create("SHARDED_FLAT").has_value()
    assert ktt.IndexFactory.Instance().Create("SHARDED_FLAT").has_value()
    unknown = ktt.IndexFactory.Instance().Create("NO_SUCH_INDEX")
    assert unknown.error() == ktt.Status.invalid_index_error
    assert kt.IndexFactory.Instance().Create("NO_SUCH_INDEX").error() == kt.Status.invalid_index_error


# Public top-level names of the port that the JAX package lacks by design:
# the port selects its device itself (the JAX package through JAX's own
# platform setting).
PORT_ONLY_NAMES = {
    "device": "the port's device module (set_device / get_device)",
    "set_device": "selects the device the port places its tensors on",
    "get_device": "the device the port places its tensors on",
}


def test_public_namespace_matches_reference():
    """Both packages' public top-level names, each imported fresh in its own
    process, are the same but for PORT_ONLY_NAMES."""
    code = "import sys, {0}\nprint(sorted(n for n in dir({0}) if not n.startswith('_')))"
    names = {}
    for pkg in ("knowhere_tpu", "knowhere_tpu_torch"):
        res = subprocess.run([sys.executable, "-c", code.format(pkg)], capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        names[pkg] = set(eval(res.stdout.strip().splitlines()[-1]))
    assert names["knowhere_tpu_torch"] - names["knowhere_tpu"] == set(PORT_ONLY_NAMES)
    assert names["knowhere_tpu"] - names["knowhere_tpu_torch"] == set()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_kwtpu_sections_cross(direction):
    rng = np.random.default_rng(1)
    arrays = {
        "a": rng.standard_normal((7, 5)).astype(np.float32),
        "b": np.arange(11, dtype=np.int64),
        "c": rng.integers(-128, 127, (3, 4)).astype(np.int8),
    }
    meta = {"dim": 5, "metric": "L2"}
    write, read = (jser.write_sections, tser.read_sections)
    if direction == "port_to_jax":
        write, read = tser.write_sections, jser.read_sections
    got, got_meta = read(write(arrays, meta=meta))
    assert got_meta["dim"] == 5 and got_meta["metric"] == "L2"
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype
    assert tser.MAGIC == jser.MAGIC and tser.FORMAT_VERSION == jser.FORMAT_VERSION


def test_device_mask_is_a_tensor_on_the_port_device():
    keep_out = np.zeros(100, bool)
    keep_out[::3] = True
    mask = ktt.BitsetView.from_bool_array(keep_out).device_mask(100)
    assert isinstance(mask, torch.Tensor) and mask.device.type == "cpu"
    np.testing.assert_array_equal(mask.numpy(), ~keep_out)


def test_memory_stats_counts_tensors():
    xb = np.random.default_rng(2).standard_normal((500, 16)).astype(np.float32)
    idx = ktt.IndexFactory.Instance().Create("FLAT").value()
    assert idx.Build(ktt.GenDataSetFromArray(xb), {"metric_type": "L2"}) == ktt.Status.success
    idx.Search(ktt.GenDataSetFromArray(xb[:2]), {"metric_type": "L2", "k": 3}, ktt.BitsetView())
    stats = idx.node.MemoryStats()
    assert stats["device_bytes"] == 0  # CPU tensors count as host memory
    assert stats["host_bytes"] >= 2 * xb.nbytes
