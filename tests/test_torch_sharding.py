"""The port's sharding layer (knowhere_tpu_torch/parallel/sharding.py) on the
CPU: the checks of tests/test_sharding.py on device lists of the CPU
repeated (8 shards, or 4 / 3 where the JAX test takes that many of its
devices), and the layer's functions held against the JAX package's on the
same inputs.

Tolerances: sharded_search's distances within 1e-5 relative + 1e-4
absolute of the JAX function's (both compute the same f32 products, summed
in other orders) and its ids equal except between distances that close;
_kmeanspp_init bit-equal (the same numpy draws); one k-means step within
1e-5 (the same assignment, sums in another order); the IVF engine's
re-distribution onto the JAX engine's owners, offsets and row order
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import knowhere_tpu_torch as ktt
from knowhere_tpu.parallel import sharding as JS
from knowhere_tpu_torch import device as tdev
from knowhere_tpu_torch.parallel import sharding as S

from .utils import knn_recall

torch.set_num_threads(2)
ktt.set_device("cpu")

NB, NQ, DIM, K = 1000, 10, 64, 10
RTOL, ATOL = 1e-5, 1e-4


def cpus(n):
    return ["cpu"] * n


def gen(rows, dim, seed):
    return np.random.default_rng(seed).standard_normal((rows, dim), dtype=np.float32)


def exact(xb, xq, k, metric="L2"):
    """(ids, distances) of the exact top-k in f64."""
    if metric == "IP":
        s = xq.astype(np.float64) @ xb.T.astype(np.float64)
        ids = np.argsort(-s, 1, kind="stable")[:, :k]
    else:
        s = ((xq[:, None, :].astype(np.float64) - xb[None]) ** 2).sum(-1)
        ids = np.argsort(s, 1, kind="stable")[:, :k]
    return ids, np.take_along_axis(s, ids, 1)


def assert_near_tie_parity(ids_j, d_j, ids_t, d_t, rtol=RTOL, atol=ATOL):
    """distances within rtol/atol; ids equal except where the JAX distances
    of the slot and a neighbour lie within the tolerance."""
    np.testing.assert_allclose(d_t, d_j, rtol=rtol, atol=atol)
    diff = ids_t != ids_j
    if diff.any():
        gap = np.abs(np.diff(d_j, axis=1)) <= atol + rtol * np.abs(d_j[:, 1:])
        near = np.zeros_like(diff)
        near[:, 1:] |= gap
        near[:, :-1] |= gap
        near[:, -1] = True  # the k-th slot may tie with the first one past k
        assert (~diff | near).all()


@pytest.fixture(scope="module")
def mesh():
    return JS.make_mesh(jax.devices()[:8])


class TestShardedSearch:
    def test_matches_single_chip_exact(self):
        xb, xq = gen(NB, DIM, 21), gen(NQ, DIM, 22)
        idx = S.ShardedFlatIndex(cpus(8), "L2")
        idx.build(xb)
        dists, ids = idx.search(xq, K)
        gt_ids, gt_d = exact(xb, xq, K)
        assert knn_recall(gt_ids, ids, NQ, K) >= 0.99
        np.testing.assert_allclose(np.sort(dists, 1), np.sort(gt_d, 1), rtol=1e-3, atol=1e-3)

    def test_ip_metric(self):
        xb, xq = gen(NB, DIM, 23), gen(NQ, DIM, 24)
        idx = S.ShardedFlatIndex(cpus(8), "IP")
        idx.build(xb)
        _, ids = idx.search(xq, K)
        assert knn_recall(exact(xb, xq, K, "IP")[0], ids, NQ, K) >= 0.99

    def test_filtered(self):
        xb, xq = gen(NB, DIM, 25), gen(NQ, DIM, 26)
        keep = np.random.default_rng(0).random(NB) > 0.5
        idx = S.ShardedFlatIndex(cpus(8), "L2")
        idx.build(xb)
        _, ids = idx.search(xq, K, bitset_keep=keep)
        assert (ids >= 0).all() and keep[ids].all()

    def test_padding_rows_never_returned(self):
        # 1003 rows do not divide 8: the padding must be masked out
        xb, xq = gen(1003, DIM, 27), gen(NQ, DIM, 28)
        idx = S.ShardedFlatIndex(cpus(8), "L2")
        idx.build(xb)
        _, ids = idx.search(xq, K)
        assert ids.max() < 1003
        # a query equal to the last real row finds it first
        _, ids = idx.search(xb[-1:], K)
        assert ids[0, 0] == 1002

    @pytest.mark.parametrize("metric", ["L2", "IP"])
    @pytest.mark.parametrize("filtered", [False, True])
    def test_matches_jax_sharded_search(self, mesh, metric, filtered):
        """sharded_search against the JAX function on the same rows, padded
        (1003 over 8 shards), with and without a bitset."""
        xb, xq = gen(1003, DIM, 29), gen(NQ, DIM, 30)
        keep = np.random.default_rng(1).random(1003) > 0.5 if filtered else None
        jidx = JS.ShardedFlatIndex(mesh, metric)
        jidx.build(xb)
        d_j, i_j = jidx.search(xq, K, bitset_keep=keep)
        tidx = S.ShardedFlatIndex(cpus(8), metric)
        tidx.build(xb)
        d_t, i_t = tidx.search(xq, K, bitset_keep=keep)
        assert i_t.dtype == np.int64 and i_t.shape == (NQ, K)
        assert_near_tie_parity(i_j, d_j, i_t, d_t)

    def test_ties_take_the_lower_global_id(self):
        """Repeated rows across shards: equal distances come back lowest id
        first, as lax.top_k over the gathered columns gives."""
        base = gen(8, DIM, 31)
        xb = np.tile(base, (16, 1))  # row r equals rows r + 8j
        idx = S.ShardedFlatIndex(cpus(4), "L2")
        idx.build(xb)
        _, ids = idx.search(base[:3], 16)
        for q in range(3):
            np.testing.assert_array_equal(ids[q], q + 8 * np.arange(16))

    def test_k_beyond_the_rows_pads(self):
        xb, xq = gen(6, DIM, 32), gen(2, DIM, 33)
        idx = S.ShardedFlatIndex(cpus(4), "L2")
        idx.build(xb)
        dists, ids = idx.search(xq, 10)
        assert sorted(ids[0, :6].tolist()) == list(range(6))
        assert (ids[:, 6:] == -1).all() and np.isinf(dists[:, 6:]).all()


class TestShardedKmeans:
    def test_step_matches_host_lloyd(self):
        x = np.random.default_rng(31).standard_normal((800, DIM)).astype(np.float32)
        init = x[:16].copy()
        devs = cpus(8)
        out = S.sharded_kmeans_step(devs, S.shard_rows(devs, x), S.replicate(devs, init)).numpy()
        d = ((x[:, None, :] - init[None, :, :]) ** 2).sum(-1)
        a = d.argmin(1)
        want = init.copy()
        for c in range(16):
            if (a == c).any():
                want[c] = x[a == c].mean(0)
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)

    def test_full_kmeans_converges(self):
        rng = np.random.default_rng(32)
        centers = rng.standard_normal((8, DIM)).astype(np.float32) * 10
        x = np.concatenate([c + rng.standard_normal((100, DIM)).astype(np.float32) for c in centers])
        cents = S.sharded_kmeans(cpus(8), x, k=8, n_iters=15, seed=1)
        d = ((centers[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
        assert (d.min(1) < DIM * 0.5).all()

    def test_kmeanspp_init_bit_equal_to_jax(self):
        x = np.random.default_rng(33).standard_normal((3000, 32)).astype(np.float32)
        a = JS._kmeanspp_init(x, 20, np.random.default_rng(5))
        b = S._kmeanspp_init(x, 20, np.random.default_rng(5))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)

    def test_step_matches_jax_step(self, mesh):
        """One step from the same centroids, 803 rows (padded to 808, as in
        the reference) over 8 shards."""
        rng = np.random.default_rng(34)
        x = rng.standard_normal((803, DIM)).astype(np.float32)
        init = x[rng.choice(803, 24, replace=False)]
        want = np.asarray(JS.sharded_kmeans_step(mesh, JS.shard_rows(mesh, x), JS.replicate(mesh, init)))
        devs = cpus(8)
        got = S.sharded_kmeans_step(devs, S.shard_rows(devs, x), init).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_sharded_kmeans_matches_jax(self, mesh):
        rng = np.random.default_rng(35)
        x = rng.standard_normal((1200, 16)).astype(np.float32)
        want = JS.sharded_kmeans(mesh, x, k=12, n_iters=6, seed=3)
        got = S.sharded_kmeans(cpus(8), x, k=12, n_iters=6, seed=3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lloyd_step_in_blocks_equals_one_block(monkeypatch):
    """The device Lloyd step assigns its rows in blocks of at most
    ASSIGN_BLOCK_BYTES of scores (at nlist 4096 a 1M-row training set would
    hold 48 GB at once): blocks of 37 rows give the one block's answer."""
    from knowhere_tpu_torch.ops import kmeans as K

    rng = np.random.default_rng(36)
    x = torch.from_numpy(rng.standard_normal((1000, 24)).astype(np.float32))
    c = x[torch.from_numpy(rng.choice(1000, 40, replace=False))]
    whole, n_whole = K._lloyd_step(x, c, k=40)
    a_whole = K.assign_device(x, c)
    monkeypatch.setattr(K, "ASSIGN_BLOCK_BYTES", 37 * 4 * 40)
    blocked, n_blocked = K._lloyd_step(x, c, k=40)
    assert torch.equal(K.assign_device(x, c), a_whole) and torch.equal(n_blocked, n_whole)
    torch.testing.assert_close(blocked, whole, rtol=0, atol=0)


class TestShardedIVF:
    def test_matches_exact_at_full_probe(self):
        rng = np.random.default_rng(77)
        xb = rng.standard_normal((2000, 32)).astype(np.float32)
        xq = rng.standard_normal((8, 32)).astype(np.float32)
        idx = S.ShardedIVFIndex(devices=cpus(4), metric="L2")
        idx.build(xb, nlist=32)
        _, ids = idx.search(xq, k=5, nprobe=32)
        assert knn_recall(exact(xb, xq, 5)[0], ids, 8, 5) >= 0.99

    def test_partial_probe_recall(self):
        rng = np.random.default_rng(78)
        xb = rng.standard_normal((2000, 32)).astype(np.float32)
        xq = xb[:8] + 0.01 * rng.standard_normal((8, 32)).astype(np.float32)
        idx = S.ShardedIVFIndex(devices=cpus(4), metric="L2")
        idx.build(xb, nlist=32)
        _, ids = idx.search(xq, k=5, nprobe=8)
        assert (ids[:, 0] == np.arange(8)).mean() >= 0.9

    @pytest.mark.parametrize("variant,m", [("sq8", 0), ("pq", 8)])
    def test_quantized_variants(self, variant, m):
        rng = np.random.default_rng(79)
        xb = rng.standard_normal((2000, 32)).astype(np.float32)
        xq = xb[:8] + 0.01 * rng.standard_normal((8, 32)).astype(np.float32)
        idx = S.ShardedIVFIndex(devices=cpus(4), metric="L2")
        idx.build(xb, nlist=32, variant=variant, m=m)
        _, ids = idx.search(xq, k=5, nprobe=32)
        assert np.mean([(ids[i] == i).any() for i in range(8)]) >= 0.85

    @pytest.mark.parametrize("n_dev", [3, 4])
    def test_distribute_matches_jax_owners(self, n_dev):
        """The JAX engine's logical index re-sharded by the port: the same
        owners, offsets, row order and local list ids on every shard."""
        rng = np.random.default_rng(80)
        xb = rng.standard_normal((3000, 16)).astype(np.float32)
        jeng = JS.ShardedIVFIndex(devices=jax.devices()[:n_dev], metric="L2")
        jeng.build(xb, nlist=48)
        teng = S.ShardedIVFIndex(devices=cpus(n_dev), metric="L2")
        teng._nlist, teng._rows, teng._kind = jeng._nlist, jeng._rows, "raw"
        teng._centroids, teng._assign, teng._payload = jeng._centroids, jeng._assign, jeng._payload
        teng._distribute()
        for js, ts in zip(jeng._shards, teng._shards):
            np.testing.assert_array_equal(ts["offsets"], js["offsets"])
            np.testing.assert_array_equal(ts["row_ids"], js["row_ids"])
            np.testing.assert_array_equal(ts["global_to_local"], js["global_to_local"])
            np.testing.assert_array_equal(ts["store"]["data"].numpy(), np.asarray(js["store"]["data"]))
            np.testing.assert_array_equal(ts["store"]["norms"].numpy(), np.asarray(js["store"]["norms"]))

    def test_sharded_stores_take_the_plain_scan(self):
        """Per-shard offsets are cumsum(bincount), not LIST_ALIGN multiples,
        and the stores carry no kernel sidecar: every route is the plain
        scan at every precision, as in the reference."""
        from knowhere_tpu_torch.ops.ivf_scan import scan_route

        rng = np.random.default_rng(81)
        xb = rng.standard_normal((2000, 128)).astype(np.float32)
        for variant in ("flat", "sq8", "pq"):
            idx = S.ShardedIVFIndex(devices=cpus(2), metric="L2")
            idx.build(xb, nlist=16, variant=variant, m=16)
            for sh in idx._shards:
                for prec in ("exact", "fast", "bf16", "int8"):
                    route, _ = scan_route(sh["store"], 128, 10, sh["offsets"], prec, idx._sq_levels)
                    assert route == "plain", (variant, prec)


class TestShardedGraph:
    def test_recall_vs_bruteforce(self):
        rng = np.random.default_rng(80)
        xb = rng.standard_normal((2000, 32)).astype(np.float32)
        xq = rng.standard_normal((16, 32)).astype(np.float32)
        idx = S.ShardedGraphIndex(devices=cpus(4), metric="L2")
        idx.build(xb, M=16, ef_construction=100)
        dists, ids = idx.search(xq, k=10, ef=64)
        assert knn_recall(exact(xb, xq, 10)[0], ids, 16, 10) >= 0.8
        row = ids[0, 0]
        np.testing.assert_allclose(dists[0, 0], ((xq[0] - xb[row]) ** 2).sum(), rtol=1e-3, atol=1e-3)

    def test_ip_metric(self):
        rng = np.random.default_rng(81)
        xb = rng.standard_normal((1500, 32)).astype(np.float32)
        xq = rng.standard_normal((8, 32)).astype(np.float32)
        idx = S.ShardedGraphIndex(devices=cpus(3), metric="IP")
        idx.build(xb, M=16)
        _, ids = idx.search(xq, k=10, ef=64)
        assert knn_recall(exact(xb, xq, 10, "IP")[0], ids, 8, 10) >= 0.8

    @pytest.mark.parametrize("bits", ["8", "4"])
    def test_inline_fast_path(self, monkeypatch, bits):
        """Forced per-shard inline tables (8-bit, the sharded default, and
        4-bit) give the general walk's quality, and ids and distances within
        the parity tolerance of the JAX engine's on the same rows."""
        monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "1")
        monkeypatch.setenv("KNOWHERE_INLINE_BITS", bits)
        rng = np.random.default_rng(82)
        xb = rng.standard_normal((2000, 32)).astype(np.float32)
        xq = rng.standard_normal((16, 32)).astype(np.float32)
        idx = S.ShardedGraphIndex(devices=cpus(4), metric="L2")
        idx.build(xb, M=16, ef_construction=100)
        assert all(sh["inline"].bits == int(bits) for sh in idx._shards)
        dists, ids = idx.search(xq, k=10, ef=64)
        assert knn_recall(exact(xb, xq, 10)[0], ids, 16, 10) >= 0.8
        row = ids[0, 0]
        np.testing.assert_allclose(dists[0, 0], ((xq[0] - xb[row]) ** 2).sum(), rtol=1e-3, atol=1e-3)
        jidx = JS.ShardedGraphIndex(devices=jax.devices()[:4], metric="L2")
        jidx.build(xb, M=16, ef_construction=100)
        for hj, ht in zip(jidx._host_graphs, idx._host_graphs):
            np.testing.assert_array_equal(ht["graph"], hj["graph"])
        d_j, i_j = jidx.search(xq, k=10, ef=64)
        assert_near_tie_parity(i_j, d_j, ids, dists)

    def test_general_walk_matches_jax(self, monkeypatch):
        monkeypatch.setenv("KNOWHERE_GRAPH_INLINE", "0")
        rng = np.random.default_rng(83)
        xb = rng.standard_normal((1500, 24)).astype(np.float32)
        xq = rng.standard_normal((12, 24)).astype(np.float32)
        keep = rng.random(1500) > 0.3
        jidx = JS.ShardedGraphIndex(devices=jax.devices()[:3], metric="L2")
        jidx.build(xb, M=8, ef_construction=64)
        tidx = S.ShardedGraphIndex(devices=cpus(3), metric="L2")
        tidx.build(xb, M=8, ef_construction=64)
        assert not any("inline" in sh for sh in tidx._shards)
        for bk in (None, keep):
            d_j, i_j = jidx.search(xq, k=10, ef=32, bitset_keep=bk)
            d_t, i_t = tidx.search(xq, k=10, ef=32, bitset_keep=bk)
            assert_near_tie_parity(i_j, d_j, i_t, d_t)


class TestDevices:
    def test_scoped_device_restores_the_device(self):
        before = ktt.get_device()
        with tdev.scoped_device("meta") as dev:
            assert dev == torch.device("meta") and ktt.get_device() == torch.device("meta")
            assert tdev.to_device(np.zeros(3, np.float32)).device.type == "meta"
        assert ktt.get_device() == before
        with pytest.raises(RuntimeError):
            with tdev.scoped_device("meta"):
                raise RuntimeError("inside the scope")
        assert ktt.get_device() == before

    def test_scoped_device_holds_for_its_thread_only(self):
        """A scope open on one thread leaves another thread's placement on
        the port's device, as jax.default_device does."""
        import threading

        opened, done, seen = threading.Event(), threading.Event(), {}

        def scoped():
            with tdev.scoped_device("meta"):
                seen["inside"] = tdev.to_device(np.zeros(3, np.float32)).device
                opened.set()
                done.wait(10)

        t = threading.Thread(target=scoped)
        t.start()
        try:
            assert opened.wait(10)
            assert ktt.get_device() == torch.device("cpu")
            assert tdev.to_device(np.zeros(3, np.float32)).device == torch.device("cpu")
        finally:
            done.set()
            t.join()
        assert seen["inside"].type == "meta"

    def test_default_devices(self, monkeypatch):
        assert S.default_devices() == [torch.device("cpu")]
        assert S.make_devices(["cpu", torch.device("cpu")]) == [torch.device("cpu")] * 2
        # CUDA selected and none visible: no CPU fallback
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        ktt.set_device("cuda")
        try:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                S.default_devices()
        finally:
            ktt.set_device("cpu")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        ktt.set_device("cuda")
        try:
            assert S.default_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]
        finally:
            ktt.set_device("cpu")
