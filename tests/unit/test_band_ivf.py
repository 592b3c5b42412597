"""Band-pruned IVF: recall vs oracle, nprobe behavior, save/load (interpret)."""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex
from cloudvectordb_tpu.ops.pallas_band import order_centroids


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=90, normalize=True)
    q = queries_from(db, 48, seed=91, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


def test_order_centroids_is_permutation():
    c = clustered_vectors(64, 16, seed=92)
    p = order_centroids(c)
    assert sorted(p.tolist()) == list(range(64))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_band_full_probe_near_exact(data, dtype):
    db, q, gt = data
    idx = BandIVFIndex.build(
        db, nlist=16, dtype=dtype, kmeans_iters=6, tile_n=512, tile_q=16
    )
    _, found = idx.search(q, 10, nprobe=16, interpret=True)
    r = recall_at_k(found, gt)
    # full probe → full scan; loss only from bucketed merge (+int8 quant)
    floor = 0.9 if dtype == "float32" else 0.85
    assert r >= floor, r


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_tiles_strategy_recall(data, dtype):
    db, q, gt = data
    idx = BandIVFIndex.build(
        db, nlist=32, dtype=dtype, kmeans_iters=6, tile_n=256, tile_q=16
    )
    # all tiles selected → equals full scan (merge/quant-limited)
    _, found = idx.search(q, 10, interpret=True,
                          p_tiles=idx._payload.shape[0] // idx.tile_n)
    r_full = recall_at_k(found, gt)
    floor = 0.9 if dtype == "float32" else 0.85
    assert r_full >= floor, r_full
    # pruned tile set still recalls well on clustered data
    _, found_p = idx.search(q, 10, nprobe=8, interpret=True)
    r_p = recall_at_k(found_p, gt)
    assert r_p >= r_full - 0.15, (r_p, r_full)


def test_band_partial_probe_prunes_but_recalls(data):
    db, q, gt = data
    idx = BandIVFIndex.build(
        db, nlist=32, dtype="float32", kmeans_iters=6, tile_n=256, tile_q=16
    )
    _, found = idx.search(q, 10, nprobe=8, interpret=True)
    r8 = recall_at_k(found, gt)
    assert r8 >= 0.7, r8


def test_band_save_load(tmp_path, data):
    db, q, _ = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", kmeans_iters=5,
                             tile_n=512, tile_q=16)
    v1, i1 = idx.search(q, 5, nprobe=16, interpret=True)
    idx.save(tmp_path / "band")
    from cloudvectordb_tpu.index import load_index

    idx2 = load_index(tmp_path / "band")
    v2, i2 = idx2.search(q, 5, nprobe=16, interpret=True)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5)


def test_band_pq_with_refine(data, tmp_path):
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex
    from cloudvectordb_tpu.index import load_index

    db, q, gt = data
    idx = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=6, refine="int8", kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16,
    )
    n_tiles = idx._n_pad_rows // idx.tile_n
    _, found = idx.search(q, 10, p_tiles=n_tiles, interpret=True)
    r_full = recall_at_k(found, gt)
    assert r_full >= 0.8, r_full  # refine recovers PQ's reconstruction loss
    _, found_p = idx.search(q, 10, p_tiles=max(4, n_tiles // 2), interpret=True)
    assert recall_at_k(found_p, gt) >= r_full - 0.15
    idx.save(tmp_path / "bpq")
    idx2 = load_index(tmp_path / "bpq")
    _, f2 = idx2.search(q, 10, p_tiles=n_tiles, interpret=True)
    np.testing.assert_array_equal(found, f2)


def test_band_pq_no_refine(data):
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    idx = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=6, refine="none", kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16,
    )
    n_tiles = idx._n_pad_rows // idx.tile_n
    _, found = idx.search(q, 10, p_tiles=n_tiles, interpret=True)
    assert recall_at_k(found, gt) >= 0.2  # PQ-ceiling-limited (m=8, nbits=6)


def test_band_pq_opq(data, tmp_path):
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex
    from cloudvectordb_tpu.index import load_index

    db, q, gt = data
    idx = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=6, refine="int8", opq=True, kmeans_iters=5,
        pq_train_iters=5, tile_n=256, tile_q=16,
    )
    assert idx.opq_matrix is not None
    np.testing.assert_allclose(idx.opq_matrix @ idx.opq_matrix.T,
                               np.eye(db.shape[1]), atol=1e-3)
    n_tiles = idx._n_pad_rows // idx.tile_n
    _, found = idx.search(q, 10, p_tiles=n_tiles, interpret=True)
    r = recall_at_k(found, gt)
    assert r >= 0.8, r
    idx.save(tmp_path / "opq")
    idx2 = load_index(tmp_path / "opq")
    _, f2 = idx2.search(q, 10, p_tiles=n_tiles, interpret=True)
    np.testing.assert_array_equal(found, f2)


# -- LSM incremental adds (BASELINE "incremental") ------------------------

def test_band_add_pending_then_merge(data):
    """add() is searchable immediately (pending scan), matches bulk rebuild
    after merge, and ids stay globally consistent."""
    db, q, _ = data
    base, extra = db[:3000], db[3000:]
    idx = BandIVFIndex.build(base, nlist=16, dtype="int8", kmeans_iters=5,
                             tile_n=256, tile_q=16)
    for s in range(0, extra.shape[0], 250):
        idx.add(extra[s : s + 250])
    assert idx.ntotal == db.shape[0]
    # added rows are found as their own nearest neighbor (exact pending scan
    # or arena scan post-merge)
    qa = extra[:32]
    _, found = idx.search(qa, 1, interpret=True,
                          p_tiles=idx._payload.shape[0] // idx.tile_n)
    self_ids = 3000 + np.arange(32)
    hit = (found[:, 0] == self_ids).mean()
    assert hit >= 0.9, hit
    # recall on the union matches a bulk-built index (same quantizer family)
    from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    _, f_inc = idx.search(q, 10, interpret=True,
                          p_tiles=idx._payload.shape[0] // idx.tile_n)
    bulk = BandIVFIndex.build(db, nlist=16, dtype="int8", kmeans_iters=5,
                              tile_n=256, tile_q=16)
    _, f_bulk = bulk.search(q, 10, interpret=True,
                            p_tiles=bulk._payload.shape[0] // bulk.tile_n)
    r_inc, r_bulk = recall_at_k(f_inc, gt), recall_at_k(f_bulk, gt)
    assert r_inc >= r_bulk - 0.03, (r_inc, r_bulk)
    # forced merge drains pending and preserves results
    idx.merge_pending()
    assert idx._pending.size == 0 and idx._n == db.shape[0]
    _, f_merged = idx.search(q, 10, interpret=True,
                             p_tiles=idx._payload.shape[0] // idx.tile_n)
    assert recall_at_k(f_merged, gt) >= r_bulk - 0.03


def test_band_pq_add_no_crash_and_searchable(data):
    """r1 regression: inherited add() crashed indexing the code matrix as
    raw rows. The PQ add path must encode+insert and serve the new rows."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    base, extra = db[:3200], db[3200:]
    idx = BandIVFPQIndex.build(base, nlist=16, m=8, nbits=6, refine="int8",
                               kmeans_iters=5, pq_train_iters=5,
                               tile_n=256, tile_q=16)
    idx.add(extra)  # crashed in r1
    assert idx.ntotal == db.shape[0]
    qa = extra[:32]
    _, found = idx.search(qa, 1, interpret=True,
                          p_tiles=idx._n_pad_rows // idx.tile_n)
    self_ids = 3200 + np.arange(32)
    assert (found[:, 0] == self_ids).mean() >= 0.9
    from cloudvectordb_tpu.eval.recall import recall_at_k
    _, f = idx.search(q, 10, interpret=True,
                      p_tiles=idx._n_pad_rows // idx.tile_n)
    r_pend = recall_at_k(f, gt)
    assert r_pend >= 0.75, r_pend
    # merge folds codes+refine rows into the arena; recall holds
    idx.merge_pending()
    assert idx._pending.size == 0 and idx._n == db.shape[0]
    _, f2 = idx.search(q, 10, interpret=True,
                       p_tiles=idx._n_pad_rows // idx.tile_n)
    assert recall_at_k(f2, gt) >= r_pend - 0.05
    # reconstruct covers arena rows (near-exact via refine store)
    rec = idx.reconstruct(np.arange(0, 64))
    cos = np.sum(rec * db[:64], axis=1) / (
        np.linalg.norm(rec, axis=1) * np.linalg.norm(db[:64], axis=1))
    assert cos.min() > 0.95, cos.min()


def test_band_pq_add_no_refine(data):
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, _ = data
    idx = BandIVFPQIndex.build(db[:3000], nlist=16, m=8, nbits=6,
                               refine="none", kmeans_iters=5,
                               pq_train_iters=5, tile_n=256, tile_q=16)
    idx.add(db[3000:])
    qa = db[3000:3032]
    _, found = idx.search(qa, 1, interpret=True,
                          p_tiles=idx._n_pad_rows // idx.tile_n)
    assert (found[:, 0] == 3000 + np.arange(32)).mean() >= 0.85
    idx.merge_pending()
    assert idx.ntotal == db.shape[0]


def test_band_add_save_load_merges(data, tmp_path):
    from cloudvectordb_tpu.index import load_index

    db, q, _ = data
    idx = BandIVFIndex.build(db[:3500], nlist=16, dtype="int8",
                             kmeans_iters=5, tile_n=256, tile_q=16)
    idx.add(db[3500:])
    idx.save(tmp_path / "lsm")
    idx2 = load_index(tmp_path / "lsm")
    assert idx2.ntotal == db.shape[0]
    v1, i1 = idx.search(q, 5, interpret=True,
                        p_tiles=idx._payload.shape[0] // idx.tile_n)
    v2, i2 = idx2.search(q, 5, interpret=True,
                         p_tiles=idx2._payload.shape[0] // idx2.tile_n)
    np.testing.assert_array_equal(i1, i2)


# -- residual-int8 encoding (r2: the recall-at-scale lever) ----------------

def test_residual_int8_beats_row_int8(data):
    """Residual quantization (row − centroid) has ~3-4× finer scale, so
    full-coverage recall must dominate whole-row int8 on clustered data."""
    db, q, gt = data
    kw = dict(nlist=16, dtype="int8", kmeans_iters=6, tile_n=256, tile_q=16)
    row = BandIVFIndex.build(db, **kw)
    res = BandIVFIndex.build(db, residual=True, **kw)
    assert res._scale < row._scale, (res._scale, row._scale)
    p_all = row._payload.shape[0] // row.tile_n
    _, f_row = row.search(q, 10, interpret=True, p_tiles=p_all)
    _, f_res = res.search(q, 10, interpret=True, p_tiles=p_all)
    r_row = recall_at_k(f_row, gt)
    r_res = recall_at_k(f_res, gt)
    assert r_res >= r_row - 0.01, (r_res, r_row)
    assert r_res >= 0.9, r_res


def test_residual_int8_add_merge_save_load(data, tmp_path):
    from cloudvectordb_tpu.index import load_index

    db, q, gt = data
    idx = BandIVFIndex.build(db[:3000], nlist=16, dtype="int8", residual=True,
                             kmeans_iters=5, tile_n=256, tile_q=16)
    for s in range(3000, 4000, 500):
        idx.add(db[s : s + 500])
    assert idx.ntotal == db.shape[0]
    qa = db[3500:3532]
    _, found = idx.search(qa, 1, interpret=True,
                          p_tiles=idx._payload.shape[0] // idx.tile_n)
    assert (found[:, 0] == 3500 + np.arange(32)).mean() >= 0.9
    idx.merge_pending()
    _, f = idx.search(q, 10, interpret=True,
                      p_tiles=idx._payload.shape[0] // idx.tile_n)
    assert recall_at_k(f, gt) >= 0.9
    # reconstruct returns near-exact rows (residual dequant + centroid)
    rec = idx.reconstruct(np.arange(64))
    cos = np.sum(rec * db[:64], axis=1) / (
        np.linalg.norm(rec, axis=1) * np.linalg.norm(db[:64], axis=1))
    assert cos.min() > 0.99, cos.min()
    idx.save(tmp_path / "resid")
    idx2 = load_index(tmp_path / "resid")
    assert idx2._resid8 and idx2._valid_end is not None
    v1, i1 = idx.search(q, 5, interpret=True, p_tiles=4)
    v2, i2 = idx2.search(q, 5, interpret=True, p_tiles=4)
    np.testing.assert_array_equal(i1, i2)


def test_residual_int8_device_streaming(data):
    import jax.numpy as jnp

    db, q, gt = data
    chunks = [jnp.asarray(db[s : s + 1000]) for s in range(0, 4000, 1000)]
    idx = BandIVFIndex.build_device_streaming(
        lambda i: chunks[i], 4, nlist=16, train_sample=1000, residual=True,
        kmeans_iters=6, tile_n=256, tile_q=16,
    )
    assert idx._resid8 and idx.ntotal == 4000
    _, f = idx.search(q, 10, interpret=True,
                      p_tiles=idx._payload.shape[0] // idx.tile_n)
    assert recall_at_k(f, gt) >= 0.9


def test_device_annex_fold(data):
    """Threshold-triggered folds on a DEVICE-resident
    arena go to the device annex (_fold_pending), never round-tripping the
    payload through the host. Annexed rows stay exactly searchable, the
    arena buffer object is untouched, and merge_pending() compacting the
    annex preserves results."""
    import jax.numpy as jnp

    db, q, gt = data
    chunks = [jnp.asarray(db[s : s + 1000]) for s in range(0, 3000, 1000)]
    idx = BandIVFIndex.build_device_streaming(
        lambda i: chunks[i], 3, nlist=16, train_sample=1000, residual=True,
        kmeans_iters=6, tile_n=128, tile_q=16,  # fold floor = 4·tile_n = 512
    )
    payload_before = idx._payload  # device buffer identity
    extra = db[3000:4000]
    for s in range(0, 1000, 250):
        idx.add(extra[s : s + 250])
    # threshold (5% of 3000 = 150) crossed → annex holds the folded rows
    assert idx._annex is not None and idx._annex["n"] > 0
    assert idx._payload is payload_before  # no arena rebuild, no host trip
    assert idx.ntotal == 4000
    p_all = idx._payload.shape[0] // idx.tile_n
    _, f = idx.search(q, 10, interpret=True, p_tiles=p_all)
    r_annex = recall_at_k(f, gt)
    assert r_annex >= 0.9, r_annex
    # every annexed row is retrievable as its own nearest neighbor
    _, self_hit = idx.search(extra[:16], 1, interpret=True, p_tiles=p_all)
    match = (self_hit[:, 0] == np.arange(3000, 3016))
    dup_ok = np.array([  # identical twins elsewhere in db tie-break
        np.allclose(db[h], extra[i], atol=1e-6)
        for i, h in enumerate(self_hit[:, 0])])
    assert (match | dup_ok).all()
    # reconstruct covers annexed ids
    rec = idx.reconstruct(np.arange(3000, 3016))
    assert np.abs(rec - extra[:16]).max() < 0.25
    # compaction folds the annex into the arena with identical results
    idx.merge_pending()
    assert idx._annex is None and idx.ntotal == 4000
    p_all2 = idx._payload.shape[0] // idx.tile_n
    _, f2 = idx.search(q, 10, interpret=True, p_tiles=p_all2)
    assert recall_at_k(f2, gt) >= r_annex - 0.01


def test_pq_multi_pool_candidates(data):
    """n_pools > 1 splits probed tiles across independent kernel candidate
    pools: deeper k_cand (beyond one pool's l_buckets slots) and n_pools×
    fewer same-slot shadowing competitors under noisy PQ scores. Full
    coverage + deep refine must therefore recall at least as well as the
    single-pool path, and every hit must be a real row."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    idx = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=5, refine="int8", kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16,
    )
    n_tiles = idx._n_pad_rows // idx.tile_n
    _, f1 = idx.search(q, 10, p_tiles=n_tiles, refine_factor=64,
                       n_pools=1, interpret=True)
    _, f4 = idx.search(q, 10, p_tiles=n_tiles, refine_factor=64,
                       n_pools=4, interpret=True)
    r1, r4 = recall_at_k(f1, gt), recall_at_k(f4, gt)
    assert r4 >= r1 - 1e-9, (r4, r1)
    assert r4 >= 0.8, r4
    assert f4.max() < db.shape[0] and f4.min() >= 0


def test_pq_multi_pool_scores_match_reconstruction(data):
    """No-refine multi-pool scores must equal exact IPs against the PQ
    reconstructions (pools change candidate bookkeeping, not scoring)."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex
    from cloudvectordb_tpu.index.pq import pq_decode

    db, q, _ = data
    idx = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=5, refine="none", kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16, residual=False,
    )
    n_tiles = idx._n_pad_rows // idx.tile_n
    codes = np.asarray(idx._codes_cm)[: idx.m, : idx._n].T
    decoded = np.asarray(pq_decode(codes, idx.codebooks))  # arena order
    arena_pos = np.empty(idx._n, np.int64)
    arena_pos[idx._ids] = np.arange(idx._n)
    s, f = idx.search(q, 10, p_tiles=n_tiles, n_pools=4, interpret=True)
    for row in range(0, q.shape[0], 7):
        ip = q[row] @ decoded[arena_pos[f[row]]].T
        np.testing.assert_allclose(s[row], ip, rtol=2e-2, atol=2e-2)


def test_pq_serve_from_refine(data):
    """r3: serve_from='refine' scans the residual-int8 refine arena with the
    tiles kernel — recall must at least match the PQ+gather-refine path at
    the same coverage (it removes the PQ candidate-generation ceiling)."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    idx = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=6, refine="int8", kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16, residual=True,
    )
    p_all = idx._n_pad_rows // idx.tile_n
    _, f_pq = idx.search(q, 10, interpret=True, p_tiles=p_all, tile_q=16)
    _, f_rf = idx.search(q, 10, interpret=True, p_tiles=p_all, tile_q=16,
                         serve_from="refine")
    r_pq, r_rf = recall_at_k(f_pq, gt), recall_at_k(f_rf, gt)
    assert r_rf >= max(0.9, r_pq - 0.01), (r_pq, r_rf)
    # OPQ path: queries rotate before planning; still near-exact
    idx2 = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=6, refine="int8", kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16, residual=True, opq=True,
    )
    _, f_o = idx2.search(q, 10, interpret=True, p_tiles=p_all, tile_q=16,
                         serve_from="refine")
    assert recall_at_k(f_o, gt) >= 0.9


def test_pq2_and_host_refine_tiers(data, tmp_path):
    """r3 config-#5 refine tiers: 'pq2' (in-HBM tier-2 ADC correction) must
    beat PQ-only ranking; 'host' (exact int8 rescore of the shortlist from
    host RAM) must be at least as good as pq2. Both survive add()+merge and
    save/load."""
    from cloudvectordb_tpu.index import load_index
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    kw = dict(nlist=16, m=8, nbits=4, kmeans_iters=6, pq_train_iters=6,
              tile_n=256, tile_q=16)
    base = BandIVFPQIndex.build(db, refine="none", **kw)
    pq2 = BandIVFPQIndex.build(db, refine="pq2", m2=16, **kw)
    host = BandIVFPQIndex.build(db, refine="host", **kw)
    p_all = pq2._n_pad_rows // 256
    skw = dict(interpret=True, p_tiles=p_all, tile_q=16, refine_factor=16)
    _, f0 = base.search(q, 10, **skw)
    _, f2 = pq2.search(q, 10, **skw)
    _, fh = host.search(q, 10, **skw)
    r0 = recall_at_k(f0, gt)
    r2 = recall_at_k(f2, gt)
    rh = recall_at_k(fh, gt)
    assert r2 >= r0 + 0.02, (r0, r2)   # tier-2 adds real information
    assert rh >= r2 - 0.01, (r2, rh)   # exact rescore ≥ tier-2 PQ
    assert rh >= 0.9, rh

    # adds: tier-2 stores are gid-keyed → survive the pending/merge cycle
    for idx in (pq2, host):
        before = idx.ntotal
        idx.add(db[:50])
        assert idx.ntotal == before + 50
        _, fs = idx.search(db[:8], 1, **skw)
        assert ((fs[:, 0] == np.arange(8)) | (fs[:, 0] >= before)).all()
        idx.merge_pending()
        _, fs2 = idx.search(db[:8], 1, **skw)
        assert ((fs2[:, 0] == np.arange(8)) | (fs2[:, 0] >= before)).all()

    # save/load round-trip keeps the tier-2 stores
    pq2.save(tmp_path / "pq2")
    host.save(tmp_path / "host")
    l2, lh = load_index(tmp_path / "pq2"), load_index(tmp_path / "host")
    assert l2.codebooks2 is not None and l2._codes2 is not None
    assert lh._host_rows is not None and lh._host_scale > 0
    _, g2 = l2.search(q, 10, **skw)
    _, gh = lh.search(q, 10, **skw)
    assert recall_at_k(g2, gt) >= r2 - 0.03
    assert recall_at_k(gh, gt) >= rh - 0.03


def test_pq2_host_device_streaming(data):
    """r3: the config-#5 build path (build_device_streaming) with the
    pq2/host refine tiers — tier-2 codes are written by a SEPARATE
    sub-batched jit (tier2_scatter) so its decode temps never stack on the
    tier-1 encode peak (observed 21.3 GB OOM at 125M fused)."""
    import jax.numpy as jnp

    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    chunks = [jnp.asarray(db[s : s + 1000]) for s in range(0, 4000, 1000)]
    kw = dict(nlist=16, m=8, nbits=4, kmeans_iters=6, pq_train_iters=6,
              tile_n=256, tile_q=16, train_sample=1000)
    i_pq2 = BandIVFPQIndex.build_device_streaming(
        lambda i: chunks[i], 4, refine="pq2", m2=16, **kw)
    i_none = BandIVFPQIndex.build_device_streaming(
        lambda i: chunks[i], 4, refine="none", **kw)
    i_host = BandIVFPQIndex.build_device_streaming(
        lambda i: chunks[i], 4, refine="host", **kw)
    p_all = i_pq2._n_pad_rows // 256
    skw = dict(interpret=True, p_tiles=p_all, tile_q=16, refine_factor=16)
    _, f2 = i_pq2.search(q, 10, **skw)
    _, f0 = i_none.search(q, 10, **skw)
    _, fh = i_host.search(q, 10, **skw)
    r2, r0, rh = (recall_at_k(f, gt) for f in (f2, f0, fh))
    assert r2 >= r0 + 0.02, (r0, r2)   # tier-2 adds real information
    assert rh >= r2 - 0.01, (r2, rh)   # exact host rescore ≥ tier-2 PQ


def test_inplace_device_merge(data):
    """A device-resident compact int8 arena built with
    merge_headroom folds pending adds IN PLACE — same buffer (capacity
    unchanged), zero payload fetch, results identical to the host-merge
    path on the same rows."""
    import jax
    import jax.numpy as jnp

    db, q, gt = data
    chunks = [jnp.asarray(db[s : s + 1000]) for s in range(0, 3000, 1000)]
    kw = dict(nlist=16, kmeans_iters=6, tile_n=256, tile_q=16,
              residual=True, train_sample=1000)
    dev = BandIVFIndex.build_device_streaming(
        lambda i: chunks[i], 3, merge_headroom=0.5, **kw)
    host = BandIVFIndex.build_device_streaming(
        lambda i: chunks[i], 3, merge_headroom=0.0, **kw)
    cap = int(dev._payload.shape[0])
    assert cap > int(host._payload.shape[0])  # headroom allocated
    buf_before = dev._payload
    for idx in (dev, host):
        idx.add(jnp.asarray(db[3000:3500]))
        idx.merge_pending()
    # the in-place path kept the SAME capacity buffer shape (a host merge
    # reassembles at a new padded size) and never fetched the payload
    assert isinstance(dev._payload, jax.Array)
    assert int(dev._payload.shape[0]) == cap
    assert dev.ntotal == host.ntotal == 3500
    p_all_d = cap // 256
    p_all_h = int(host._payload.shape[0]) // 256
    _, fd = dev.search(q, 10, interpret=True, p_tiles=p_all_d, tile_q=16)
    _, fh = host.search(q, 10, interpret=True, p_tiles=p_all_h, tile_q=16)
    np.testing.assert_array_equal(fd, fh)  # same rows, same quantizer
    # ids/offsets coherent: every row reconstructs to its own neighborhood
    _, fs = dev.search(db[3000:3008], 1, interpret=True, p_tiles=p_all_d,
                       tile_q=16)
    assert (fs[:, 0] == np.arange(3000, 3008)).mean() >= 0.9
    del buf_before

    # headroom exhausted → falls back to the host merge (arena grows)
    dev.add(jnp.asarray(db[:2000]))
    dev.merge_pending()
    assert dev.ntotal == 5500
    assert int(dev._payload.shape[0]) > cap  # reassembled at a new size
    _, fs2 = dev.search(db[3000:3008], 1, interpret=True,
                        p_tiles=int(np.asarray(dev._payload).shape[0]) // 256,
                        tile_q=16)
    assert (fs2[:, 0] == np.arange(3000, 3008)).mean() >= 0.9


def test_inplace_device_merge_multiple_rounds(data):
    """Repeated in-place folds accumulate correctly until the headroom is
    spent (the capacity bound is checked per merge)."""
    import jax.numpy as jnp

    db, q, gt = data
    chunks = [jnp.asarray(db[s : s + 1000]) for s in range(0, 2000, 1000)]
    kw = dict(nlist=16, kmeans_iters=6, tile_n=256, tile_q=16,
              residual=True, train_sample=1000)
    idx = BandIVFIndex.build_device_streaming(
        lambda i: chunks[i], 2, merge_headroom=1.2, **kw)
    cap = int(idx._payload.shape[0])
    for s in range(2000, 4000, 500):
        idx.add(jnp.asarray(db[s : s + 500]))
        idx.merge_pending()
    assert idx.ntotal == 4000 and int(idx._payload.shape[0]) == cap
    p_all = cap // 256
    _, found = idx.search(q, 10, interpret=True, p_tiles=p_all, tile_q=16)
    ref = BandIVFIndex.build_device_streaming(
        lambda i: chunks[i], 2, **kw)
    for s in range(2000, 4000, 500):
        ref.add(jnp.asarray(db[s : s + 500]))
        ref.merge_pending()
    _, fr = ref.search(q, 10, interpret=True,
                       p_tiles=int(np.asarray(ref._payload).shape[0]) // 256,
                       tile_q=16)
    np.testing.assert_array_equal(found, fr)


def test_pq2_host_cascade(data, tmp_path):
    """refine='pq2+host' — the tier-2 ADC narrows the
    kernel's k_cand candidate set ON-CHIP to a k·host_factor shortlist and
    only the survivors' rows cross to the host rescore. At matched k_cand
    the cascade must (a) carry both tiers through build/save/load/add, (b)
    reach the plain 'host' tier's recall within noise while gathering ~8×
    fewer host rows, and (c) beat pq2-only ranking."""
    from cloudvectordb_tpu.index import load_index
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    kw = dict(nlist=16, m=8, nbits=4, kmeans_iters=6, pq_train_iters=6,
              tile_n=256, tile_q=16)
    casc = BandIVFPQIndex.build(db, refine="pq2+host", m2=16, **kw)
    host = BandIVFPQIndex.build(db, refine="host", **kw)
    pq2 = BandIVFPQIndex.build(db, refine="pq2", m2=16, **kw)
    assert casc.codebooks2 is not None and casc._codes2 is not None
    assert casc._host_rows is not None and casc._host_scale > 0
    p_all = casc._n_pad_rows // 256
    skw = dict(interpret=True, p_tiles=p_all, tile_q=16, refine_factor=16)
    _, fc = casc.search(q, 10, host_factor=6, **skw)  # 60-row shortlist
    _, fh = host.search(q, 10, **skw)                 # 160-row shortlist
    _, f2 = pq2.search(q, 10, **skw)
    rc, rh, r2 = (recall_at_k(f, gt) for f in (fc, fh, f2))
    assert rc >= r2, (r2, rc)          # exact host tail ≥ tier-2 ranking
    assert rc >= rh - 0.02, (rh, rc)   # 2.7× narrower shortlist, same recall
    # (at real scale — m2=32, 8-bit, 768-d — tier-2 ranks far better and
    # the measured narrowing is ~8–13× at equal recall)
    # a wide-open shortlist (host_factor ≥ refine_factor) IS the host tier
    _, fw = casc.search(q, 10, host_factor=16, **skw)
    assert recall_at_k(fw, gt) >= rh - 0.01

    # adds ride both tiers' pending stores
    before = casc.ntotal
    casc.add(db[:50])
    _, fs = casc.search(db[:8], 1, host_factor=2, **skw)
    assert ((fs[:, 0] == np.arange(8)) | (fs[:, 0] >= before)).all()
    casc.merge_pending()
    _, fs2 = casc.search(db[:8], 1, host_factor=2, **skw)
    assert ((fs2[:, 0] == np.arange(8)) | (fs2[:, 0] >= before)).all()

    # save/load keeps BOTH tiers and the cascade mode
    casc.save(tmp_path / "casc")
    lc = load_index(tmp_path / "casc")
    assert lc.refine == "pq2+host"
    assert lc.codebooks2 is not None and lc._codes2 is not None
    assert lc._host_rows is not None
    _, gl = lc.search(q, 10, host_factor=6, **skw)
    assert recall_at_k(gl, gt) >= rc - 0.04  # (dup adds above cost a little)


def test_attach_upgrades_pq2_to_cascade(data):
    """r4: attach_host_refine on a pq2 device build keeps the in-HBM
    tier-2 table and upgrades refine to the 'pq2+host' cascade (the 125M
    endgame: tier-2 already resident, host rows attached link-free)."""
    import jax.numpy as jnp

    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    chunks = [jnp.asarray(db[s : s + 1000]) for s in range(0, 4000, 1000)]
    kw = dict(nlist=16, m=8, nbits=4, kmeans_iters=6, pq_train_iters=6,
              tile_n=256, tile_q=16, train_sample=1000)
    idx = BandIVFPQIndex.build_device_streaming(
        lambda i: chunks[i], 4, refine="pq2", m2=16, **kw)
    p_all = idx._n_pad_rows // 256
    skw = dict(interpret=True, p_tiles=p_all, tile_q=16, refine_factor=16)
    _, f2 = idx.search(q, 10, **skw)
    r2 = recall_at_k(f2, gt)
    idx.attach_host_refine(lambda i: np.asarray(chunks[i]), 4)
    assert idx.refine == "pq2+host"
    assert idx._codes2 is not None  # tier-2 survived the attach
    _, fc = idx.search(q, 10, host_factor=2, **skw)
    rc = recall_at_k(fc, gt)
    assert rc >= r2, (r2, rc)  # exact tail on a narrowed shortlist


def test_slack_build_parity_and_masking(data):
    """slack>0 changes arena LAYOUT only: same rows, same quantizer, same
    scores — full-coverage results must match the compact build. Hole slots
    (zero residuals → they'd reconstruct to the list centroid, a plausible
    high-IP phantom) must be masked by the per-tile-list valid_end table."""
    db, q, gt = data
    kw = dict(nlist=16, dtype="int8", kmeans_iters=6, tile_n=256, tile_q=16,
              residual=True)
    compact = BandIVFIndex.build(db, **kw)
    slack = BandIVFIndex.build(db, slack=0.3, **kw)
    assert slack._list_lens is not None
    assert slack._n > compact._n  # slack slots exist
    assert slack.ntotal == compact.ntotal == db.shape[0]
    p_c = compact._payload.shape[0] // compact.tile_n
    p_s = int(np.asarray(slack._payload).shape[0]) // slack.tile_n
    vc, fc = compact.search(q, 10, interpret=True, p_tiles=p_c)
    vs, fs = slack.search(q, 10, interpret=True, p_tiles=p_s)
    assert recall_at_k(fs, gt) >= recall_at_k(fc, gt) - 1e-9
    np.testing.assert_allclose(vs, vc, rtol=1e-4, atol=1e-4)


def test_slack_add_in_place(data):
    """Adds go into slack slots — NO pending rows, searchable immediately,
    and the arena is updated by an O(batch) device scatter."""
    db, q, gt = data
    idx = BandIVFIndex.build(
        db[:3000], nlist=16, dtype="int8", kmeans_iters=6, tile_n=256,
        tile_q=16, residual=True, slack=0.5,
    )
    extent_before = idx._n
    idx.add(db[3000:3400])
    assert idx._pending.size == 0, "slack should absorb the whole batch"
    assert idx._n == extent_before  # no re-sort, no growth
    assert idx.ntotal == 3400
    # the new rows are immediately retrievable (self-query, full coverage)
    p_all = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    _, found = idx.search(db[3000:3400], 5, interpret=True, p_tiles=p_all)
    self_hit = (found == np.arange(3000, 3400)[:, None]).any(axis=1)
    assert self_hit.mean() >= 0.99, self_hit.mean()
    # original content still searchable at build quality
    _, f = idx.search(q, 10, interpret=True, p_tiles=p_all)
    _, gt_sub = brute_force_topk(db[:3400], q, 10, metric="ip")
    assert recall_at_k(f, gt_sub) >= 0.9


def test_slack_overflow_spills_to_pending(data):
    """Rows beyond a list's slack capacity spill to the pending buffer and
    stay searchable; merge_pending() folds them in and re-opens slack."""
    db, q, _ = data
    idx = BandIVFIndex.build(
        db[:2000], nlist=8, dtype="int8", kmeans_iters=6, tile_n=256,
        tile_q=16, residual=True, slack=0.01,
    )
    idx.merge_threshold = 1e9  # keep pending; we merge manually below
    idx.add(db[2000:3000])  # slack ~28 rows/list — most must spill
    assert idx._pending.size > 0
    assert idx.ntotal == 3000
    p_all = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    _, found = idx.search(db[2500:2600], 3, interpret=True, p_tiles=p_all)
    self_hit = (found == np.arange(2500, 2600)[:, None]).any(axis=1)
    assert self_hit.mean() >= 0.99
    idx.merge_pending()
    assert idx._pending.size == 0 and idx.ntotal == 3000
    assert idx._list_lens.sum() == 3000
    p_all = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    _, found = idx.search(db[2500:2600], 3, interpret=True, p_tiles=p_all)
    self_hit = (found == np.arange(2500, 2600)[:, None]).any(axis=1)
    assert self_hit.mean() >= 0.99


def test_slack_holes_never_surface_adversarially(rng):
    """All-negative-score regime: every real row anti-correlated with the
    query. An unmasked hole (zero residual → reconstructs to the list
    centroid) would score ≈ q·c ≥ 0 and win — assert every returned id is a
    real row and every score negative."""
    d = 64
    base = rng.normal(size=(1, d)).astype(np.float32)
    base /= np.linalg.norm(base)
    db = -base + 0.05 * rng.normal(size=(512, d)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    idx = BandIVFIndex.build(db, nlist=4, dtype="int8", kmeans_iters=4,
                             tile_n=128, tile_q=8, residual=True, slack=0.5)
    p_all = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    v, f = idx.search(base, 10, interpret=True, p_tiles=p_all)
    assert f.min() >= 0 and f.max() < 512, f
    assert (v < 0).all(), v


def test_slack_save_load_roundtrip(data, tmp_path):
    from cloudvectordb_tpu.index import load_index

    db, q, _ = data
    idx = BandIVFIndex.build(db[:3000], nlist=16, dtype="int8",
                             kmeans_iters=6, tile_n=256, tile_q=16,
                             residual=True, slack=0.3)
    idx.add(db[3000:3200])
    idx.save(tmp_path / "slk")
    idx2 = load_index(tmp_path / "slk")
    assert idx2.slack == idx.slack and idx2.ntotal == idx.ntotal
    assert idx2._list_lens is not None
    p_all = int(np.asarray(idx2._payload).shape[0]) // idx2.tile_n
    _, f1 = idx.search(q, 10, interpret=True, p_tiles=p_all)
    _, f2 = idx2.search(q, 10, interpret=True, p_tiles=p_all)
    np.testing.assert_array_equal(f1, f2)


def test_slack_add_after_mmap_load(data, tmp_path):
    """add() on a loaded slack index: load_index mmaps arrays read-only, and
    the in-place slack insert mutates _ids/_list_lens — the load path must
    hand add() writable copies (r2 advisor high: half-applied insert after
    'assignment destination is read-only')."""
    from cloudvectordb_tpu.index import load_index

    db, q, _ = data
    idx = BandIVFIndex.build(db[:3000], nlist=16, dtype="int8",
                             kmeans_iters=6, tile_n=256, tile_q=16,
                             residual=True, slack=0.3)
    idx.save(tmp_path / "slk2")
    idx2 = load_index(tmp_path / "slk2")  # default mmap=True
    before = idx2.ntotal
    idx2.add(db[3000:3100])  # must not raise, must land in slack slots
    assert idx2.ntotal == before + 100
    p_all = int(np.asarray(idx2._payload).shape[0]) // idx2.tile_n
    _, found = idx2.search(db[3000:3100], 1, interpret=True, p_tiles=p_all,
                           tile_q=16)
    self_hit = float((found[:, 0] == np.arange(before, before + 100)).mean())
    assert self_hit >= 0.95, self_hit


def test_aniso_pq_index_end_to_end(data, tmp_path):
    """aniso_eta>1 trains score-aware codebooks; the index must stay a
    correct index (full-coverage recall in the plain index's range), the
    metric-matched encoder must be used, and eta must round-trip."""
    from cloudvectordb_tpu.index import load_index
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    kw = dict(nlist=16, m=8, nbits=5, refine="none", kmeans_iters=6,
              pq_train_iters=6, tile_n=256, tile_q=16)
    plain = BandIVFPQIndex.build(db, **kw)
    aniso = BandIVFPQIndex.build(db, aniso_eta=4.0, **kw)
    nt = aniso._n_pad_rows // aniso.tile_n
    _, fp = plain.search(q, 10, p_tiles=nt, interpret=True)
    _, fa = aniso.search(q, 10, p_tiles=nt, interpret=True)
    rp, ra = recall_at_k(fp, gt), recall_at_k(fa, gt)
    assert ra >= rp - 0.05, (ra, rp)  # no-refine PQ ceiling comparable
    aniso.save(tmp_path / "aniso")
    idx2 = load_index(tmp_path / "aniso")
    assert idx2.aniso_eta == 4.0
    _, f2 = idx2.search(q, 10, p_tiles=nt, interpret=True)
    np.testing.assert_array_equal(fa, f2)


def test_auto_p_tiles_span_aware(data):
    """The shared-tile-table budget must grow when query groups are more
    diverse (small batch relative to tile_q) and shrink for homogeneous
    groups (large batch), covering the group's union span (measured at 2M:
    batch-blind budgets cost 36 recall points)."""
    db, q, gt = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", kmeans_iters=6,
                             tile_n=256, tile_q=64, residual=True)
    n_tiles = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    p_small_batch = idx._auto_p_tiles(64, 8, n_tiles)
    p_big_batch = idx._auto_p_tiles(4096, 8, n_tiles)
    assert p_small_batch >= p_big_batch
    p_small_tq = idx._auto_p_tiles(64, 8, n_tiles, tile_q=16)
    assert p_small_tq <= p_small_batch  # tighter groups -> smaller budget
    assert 1 <= p_big_batch <= n_tiles and 1 <= p_small_tq <= n_tiles
    # recall with auto budget at this tiny scale covers everything relevant
    _, f = idx.search(q, 10, interpret=True)
    assert recall_at_k(f, gt) >= 0.9


def test_search_tile_q_override(data):
    """Per-search tile_q must produce valid (and at small scale identical-
    coverage) results without touching the index's stored tile_q."""
    db, q, gt = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", kmeans_iters=6,
                             tile_n=256, tile_q=64, residual=True)
    n_tiles = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    _, f1 = idx.search(q, 10, interpret=True, p_tiles=n_tiles)
    _, f2 = idx.search(q, 10, interpret=True, p_tiles=n_tiles, tile_q=16)
    assert idx.tile_q == 64
    r1, r2 = recall_at_k(f1, gt), recall_at_k(f2, gt)
    assert abs(r1 - r2) <= 0.02, (r1, r2)  # full coverage: grouping moot


def test_pq_segmented_arena_parity(data):
    """Row-major code arenas past seg_rows_cap split into segments, each
    dispatched separately with a filtered tile table and a maskable pad
    tile (seg_rows_cap — class doc). With identical
    quantizers, segmented search must match the single-arena results at
    full coverage (candidate pools can only widen)."""
    import jax.numpy as jnp
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    chunks = [db[:2000], db[2000:]]

    def cf(i):
        return jnp.asarray(chunks[i])

    kw = dict(nlist=16, m=8, nbits=5, refine="none", kmeans_iters=5,
              pq_train_iters=5, tile_n=256, tile_q=16, train_sample=2048)
    single = BandIVFPQIndex.build_device_streaming(cf, 2, **kw)

    class Seg(BandIVFPQIndex):
        seg_rows_cap = 1024  # 4000 rows -> 4 segments

    seg = Seg.build_device_streaming(cf, 2, **kw)
    assert seg._segmented and len(seg._codes_cm) >= 3
    # identical codes end-to-end (same quantizers, same data)
    np.testing.assert_array_equal(
        single._codes_np_rows(), seg._codes_np_rows())
    nt = single._n_pad_rows // single.tile_n
    v1, f1 = single.search(q, 10, p_tiles=nt, interpret=True)
    v2, f2 = seg.search(q, 10, p_tiles=nt, interpret=True)
    r1, r2 = recall_at_k(f1, gt), recall_at_k(f2, gt)
    assert r2 >= r1 - 1e-9, (r2, r1)  # segment pools only widen candidates
    assert f2.max() < db.shape[0] and f2.min() >= 0


def test_pq_segmented_add_merge_save_load(data, tmp_path):
    """Pending adds on a segmented index: merge re-sorts on host and
    re-installs segments; save stores one row-major matrix and load
    re-segments past the cap."""
    import jax.numpy as jnp
    from cloudvectordb_tpu.index import load_index
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex
    from cloudvectordb_tpu.index.registry import _KINDS

    db, q, gt = data

    class Seg(BandIVFPQIndex):
        seg_rows_cap = 1024

    def cf(i):
        return jnp.asarray(db[:3000][i * 1500 : (i + 1) * 1500])

    idx = Seg.build_device_streaming(
        cf, 2, nlist=16, m=8, nbits=5, refine="none", kmeans_iters=5,
        pq_train_iters=5, tile_n=256, tile_q=16, train_sample=2048)
    assert idx._segmented
    idx.add(db[3000:])
    idx.merge_pending()
    assert idx._pending.size == 0 and idx.ntotal == db.shape[0]
    assert idx._segmented  # merge re-installed segments (4000 > cap)
    nt = idx._n_pad_rows // idx.tile_n
    # recall floor: PQ-only (no refine) at m=8/nbits=5 is reconstruction-
    # ceiling-limited; the invariant under test is that merge PRESERVES it
    _, f3 = idx.search(q, 10, p_tiles=nt, interpret=True)
    _, gt4 = brute_force_topk(db, q, 10, metric="ip")
    r_merged = recall_at_k(f3, gt4)
    fresh = Seg.build(db, nlist=16, m=8, nbits=5, refine="none",
                      kmeans_iters=5, pq_train_iters=5, tile_n=256,
                      tile_q=16)
    nt_f = fresh._n_pad_rows // fresh.tile_n
    _, ff = fresh.search(q, 10, p_tiles=nt_f, interpret=True)
    assert r_merged >= recall_at_k(ff, gt4) - 0.1, (
        r_merged, recall_at_k(ff, gt4))
    f = f3
    # merged adds' codes/centroid bookkeeping intact: reconstructions of
    # the added rows stay close to the originals (self-retrieval by PQ-only
    # score is genuinely ambiguous in tightly clustered data)
    rec = idx.reconstruct(np.arange(3000, 3032))
    cos = (rec * db[3000:3032]).sum(1) / np.maximum(
        np.linalg.norm(rec, axis=1) * np.linalg.norm(db[3000:3032], axis=1),
        1e-9)
    assert cos.min() > 0.8, cos.min()
    idx.save(tmp_path / "seg")
    try:
        _KINDS["band_ivf_pq"] = Seg  # load with the test's small cap
        idx2 = load_index(tmp_path / "seg")
    finally:
        _KINDS["band_ivf_pq"] = BandIVFPQIndex
    assert idx2._segmented
    _, f2 = idx2.search(q, 10, p_tiles=nt, interpret=True)
    np.testing.assert_array_equal(f, f2)


def test_segmented_refine_growth_raises_cleanly(data):
    """An int8-refine index may NOT silently cross the segment cap via adds:
    segmented refine gathers are unimplemented and the refine rows would be
    tens of GB — merge must raise NotImplementedError, not corrupt state."""
    import pytest
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, _ = data

    class Seg(BandIVFPQIndex):
        seg_rows_cap = 1024

    idx = Seg.build(db[:1000], nlist=8, m=8, nbits=5, refine="int8",
                    kmeans_iters=4, pq_train_iters=4, tile_n=256, tile_q=16)
    idx.merge_threshold = 1e9
    idx.add(db[1000:])  # crosses the 1024-row cap at merge
    with pytest.raises(NotImplementedError):
        idx.merge_pending()


def test_pq2_rescore_chunking_parity():
    """r3: _pq2_rescore sub-chunks the query batch (lax.map) when the
    (b, k_cand, m2) gather temps exceed the element budget — at 125M/chip
    the fused form's >2 GB of HLO temps OOM next to 12 GB of resident code
    tables. Chunked and fused forms must agree exactly."""
    import jax.numpy as jnp

    from cloudvectordb_tpu.index.ivf_band import _pq2_rescore, _rescore_nsub

    # budget policy: headline shape chunks, unit-test shapes don't
    assert _rescore_nsub(4096, 2048, 32) == 8
    assert _rescore_nsub(4096, 1020, 32) > 1   # odd kc still chunks on b
    assert _rescore_nsub(256, 256, 16) == 1
    assert _rescore_nsub(1, 4096, 32) == 1     # b=1 cannot split

    rng = np.random.default_rng(11)
    b, kc, m2, c2n, dsub2, nrows = 64, 96, 8, 16, 4, 500
    q = rng.standard_normal((b, m2 * dsub2)).astype(np.float32)
    v = rng.standard_normal((b, kc)).astype(np.float32)
    v[:, -3:] = -np.inf  # invalid slots stay invalid
    gids = rng.integers(0, nrows, (b, kc)).astype(np.int32)
    codes2 = rng.integers(0, c2n, (nrows, m2)).astype(np.uint8)
    cb2 = rng.standard_normal((m2, c2n, dsub2)).astype(np.float32)
    v2, g2 = _pq2_rescore(jnp.asarray(q), jnp.asarray(v), jnp.asarray(gids),
                          jnp.asarray(codes2), jnp.asarray(cb2), k=10)
    # numpy oracle: full decode of the tier-2 correction
    lut = np.einsum("bmd,mcd->bmc", q.reshape(b, m2, dsub2), cb2)
    corr = np.take_along_axis(np.transpose(lut, (0, 2, 1)),
                              codes2[gids].astype(np.int64), axis=1).sum(2)
    ex = np.where(v > -np.inf, v + corr, -np.inf)
    ref_v = np.sort(ex, axis=1)[:, ::-1][:, :10]
    assert np.allclose(np.asarray(v2), ref_v, atol=1e-3)
    # force the chunked path on the same data (tiled to a chunking shape)
    rep = 64  # 4096 queries, kc=96, m2=8 -> 3.1M elts; shrink budget instead
    v2c, g2c = None, None
    import functools as _ft
    import jax as _jax

    from cloudvectordb_tpu.index import ivf_band as _band
    orig = _band._rescore_nsub
    _band._rescore_nsub = _ft.partial(orig, budget=1 << 12)
    try:
        # new jit trace sees the patched chunk count
        v2c, g2c = _jax.jit(
            _band._pq2_rescore.__wrapped__, static_argnames=("k",)
        )(jnp.asarray(q), jnp.asarray(v), jnp.asarray(gids),
          jnp.asarray(codes2), jnp.asarray(cb2), k=10)
    finally:
        _band._rescore_nsub = orig
    assert np.allclose(np.asarray(v2c), np.asarray(v2), atol=1e-5)
    assert (np.asarray(g2c) == np.asarray(g2)).all()


def test_host_refine_add_after_streaming_build(data):
    """r3 review: add() must append to the gid-keyed host store even when
    the store still lives in _host_pending_rows (fresh build_streaming —
    _host_rows is None until the first fold). The old `_host_rows is not
    None` gate silently dropped every add, permanently misaligning the
    store after merge."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    chunks = [db[s : s + 1000] for s in range(0, 4000, 1000)]
    idx = BandIVFPQIndex.build_streaming(
        iter(chunks), nlist=16, m=8, nbits=4, refine="host", kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16)
    assert idx._host_rows is None and idx._host_pending_rows
    n0 = idx.ntotal
    idx.add(db[:50])
    rows_h, assign_h = idx._host_store()
    assert rows_h.shape[0] == n0 + 50, rows_h.shape  # append not dropped
    idx.merge_pending()
    idx.add(db[100:130])  # appends AFTER a fold must stay gid-aligned too
    rows_h, assign_h = idx._host_store()
    assert rows_h.shape[0] == n0 + 80
    # gid-keyed store must hold exactly the quantized residual of its
    # source row (a dropped append shifts every later gid → garbage here);
    # ±1 LSB slack for f32-order-of-operations differences, and clipping
    # (residuals can exceed the trained 127·scale range) is reproduced
    for gid, src in ((n0 + 10, db[10]), (n0 + 60, db[110])):
        resid = src - idx.centroids[assign_h[gid]]
        exp = np.clip(np.round(resid / idx._host_scale), -127, 127)
        assert np.abs(rows_h[gid].astype(np.int32)
                      - exp.astype(np.int32)).max() <= 1, gid


def test_host_refine_nonresidual_no_centroid_term(data):
    """r3 review: refine='host' with residual=False stores WHOLE rows; the
    rescore must not add the centroid term (q·x + q·c inflated arena
    scores over the exact pending scan)."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    kw = dict(nlist=16, m=8, nbits=4, residual=False, kmeans_iters=6,
              pq_train_iters=6, tile_n=256, tile_q=16)
    idx = BandIVFPQIndex.build(db, refine="host", **kw)
    none = BandIVFPQIndex.build(db, refine="none", **kw)
    p_all = idx._n_pad_rows // 256
    skw = dict(interpret=True, p_tiles=p_all, tile_q=16, refine_factor=16)
    _, f = idx.search(q, 10, **skw)
    r = recall_at_k(f, gt)
    _, f0 = none.search(q, 10, **skw)
    r0 = recall_at_k(f0, gt)
    # exact rescore of the same tier-1 candidates can only help; with the
    # spurious +q·c term it fell measurably below the PQ-only ranking
    assert r >= r0 - 0.01, (r, r0)
    # scores must be plain dequantized IP against the TRUE stored rows
    v, g = idx.search(q[:8], 1, **skw)
    ip = np.sum(q[:8] * db[g[:, 0]], axis=1)
    assert np.allclose(v[:, 0], ip, atol=0.05), (v[:, 0], ip)


def test_attach_host_refine_from_host_source(data):
    """r3: attach the host exact-rescore tier AFTER a device-resident pq2
    build from a host-side row source (zero device-link traffic). Must
    match a refine='host' build's results on the same data."""
    import jax.numpy as jnp

    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    chunks = [db[s : s + 1000] for s in range(0, 4000, 1000)]
    kw = dict(nlist=16, m=8, nbits=4, kmeans_iters=6, pq_train_iters=6,
              tile_n=256, tile_q=16, train_sample=1000)
    idx = BandIVFPQIndex.build_device_streaming(
        lambda i: jnp.asarray(chunks[i]), 4, refine="pq2", m2=16, **kw)
    host = BandIVFPQIndex.build_device_streaming(
        lambda i: jnp.asarray(chunks[i]), 4, refine="host", **kw)
    p_all = idx._n_pad_rows // 256
    skw = dict(interpret=True, p_tiles=p_all, tile_q=16, refine_factor=16)
    _, f2 = idx.search(q, 10, **skw)           # pq2 tier before attach
    idx.attach_host_refine(lambda i: chunks[i], 4)
    # r4: a pq2 build upgrades to the cascade (tier-2 kept in HBM); the
    # default host_factor (64) leaves this k_cand=160 shortlist un-narrowed,
    # so every parity assertion below is unchanged
    assert idx.refine == "pq2+host" and idx._host_rows.shape[0] == 4000
    _, fa = idx.search(q, 10, **skw)           # host tier after attach
    _, fh = host.search(q, 10, **skw)          # built-as-host reference
    r2_, ra, rh = (recall_at_k(f, gt) for f in (f2, fa, fh))
    assert ra >= rh - 0.01, (ra, rh)   # attach ≡ built-as-host
    assert ra >= r2_ - 0.01, (ra, r2_)  # exact rescore ≥ tier-2 ADC
    # attached store rows match the built-as-host store bit-for-bit up to
    # the scale (both quantize the same residuals; scales from same chunk)
    assert abs(idx._host_scale - host._host_scale) < 1e-9
    assert (idx._host_rows == host._host_rows).mean() > 0.995

    # OPQ build: attach must rotate host chunks with the SAME convention
    # (x @ R.T) as every encode path — the missing transpose quantized
    # garbage and only showed at bench scale (review finding, r3)
    o_pq2 = BandIVFPQIndex.build_device_streaming(
        lambda i: jnp.asarray(chunks[i]), 4, refine="pq2", m2=16, opq=True,
        **kw)
    o_host = BandIVFPQIndex.build_device_streaming(
        lambda i: jnp.asarray(chunks[i]), 4, refine="host", opq=True, **kw)
    o_pq2.attach_host_refine(lambda i: chunks[i], 4)
    assert abs(o_pq2._host_scale - o_host._host_scale) < 1e-9
    assert (o_pq2._host_rows == o_host._host_rows).mean() > 0.995
    _, fo = o_pq2.search(q, 10, **skw)
    _, fr = o_host.search(q, 10, **skw)
    assert recall_at_k(fo, gt) >= recall_at_k(fr, gt) - 0.01

    # attach after add() must refuse (later gids absent from the store)
    o_host.add(db[:16])
    with pytest.raises(AssertionError):
        o_host.attach_host_refine(lambda i: chunks[i], 4)


def test_attach_host_refine_rotated_chunks(data):
    """chunks_rotated=True: chunks supplied already in OPQ space skip the
    host-side rotation and must yield the identical store (bench_config5
    folds R into its generator — saves dim²·N host FLOPs at 125M)."""
    import jax.numpy as jnp

    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    chunks = [db[s : s + 1000] for s in range(0, 4000, 1000)]
    kw = dict(nlist=16, m=8, nbits=4, kmeans_iters=6, pq_train_iters=6,
              tile_n=256, tile_q=16, train_sample=1000, opq=True,
              refine="none")
    a = BandIVFPQIndex.build_device_streaming(
        lambda i: jnp.asarray(chunks[i]), 4, **kw)
    b = BandIVFPQIndex.build_device_streaming(
        lambda i: jnp.asarray(chunks[i]), 4, **kw)
    a.attach_host_refine(lambda i: chunks[i], 4)
    rot_t = np.asarray(b.opq_matrix, np.float32).T
    b.attach_host_refine(lambda i: chunks[i] @ rot_t, 4, chunks_rotated=True)
    assert abs(a._host_scale - b._host_scale) < 1e-6 * a._host_scale
    assert (a._host_rows == b._host_rows).mean() > 0.999
    p_all = a._n_pad_rows // 256
    skw = dict(interpret=True, p_tiles=p_all, tile_q=16, refine_factor=16)
    _, fa = a.search(q, 10, **skw)
    _, fb = b.search(q, 10, **skw)
    assert recall_at_k(fb, gt) >= recall_at_k(fa, gt) - 0.01


def test_search_device_parity_and_annex(data):
    """search_device (all-device serving path) returns the same results as
    search() — before and after pending adds fold into the device annex."""
    import jax.numpy as jnp

    db, q, gt = data
    chunks = [jnp.asarray(db[s : s + 1000]) for s in range(0, 3000, 1000)]
    idx = BandIVFIndex.build_device_streaming(
        lambda i: chunks[i], 3, nlist=16, train_sample=1000, residual=True,
        kmeans_iters=6, tile_n=128, tile_q=16,
    )
    p_all = idx._payload.shape[0] // idx.tile_n
    v_h, f_h = idx.search(q, 10, interpret=True, p_tiles=p_all)
    v_d, f_d = idx.search_device(jnp.asarray(q), 10, interpret=True,
                                 p_tiles=p_all)
    assert isinstance(v_d, jnp.ndarray) and f_d.dtype == jnp.int32
    np.testing.assert_allclose(np.asarray(v_d), v_h, rtol=1e-5, atol=1e-5)
    assert (np.asarray(f_d).astype(np.int64) == f_h).all()

    # adds cross add()'s fold threshold → annex rows; the remainder stays
    # in pending (search_device scans it exactly on device — it must NOT
    # fold per call, which would promote the PQ family's host compact
    # into a per-search cost). Parity must hold over arena+annex+pending.
    extra = db[3000:4000]
    for s in range(0, 1000, 250):
        idx.add(extra[s : s + 250])
    v_d2, f_d2 = idx.search_device(jnp.asarray(q), 10, interpret=True,
                                   p_tiles=p_all)
    assert idx._annex is not None and idx._annex["n"] > 0
    assert idx._pending.size > 0  # remainder scanned, not folded
    v_h2, f_h2 = idx.search(q, 10, interpret=True, p_tiles=p_all)
    np.testing.assert_allclose(np.asarray(v_d2), v_h2, rtol=1e-5, atol=1e-5)
    assert (np.asarray(f_d2).astype(np.int64) == f_h2).all()
    # annexed rows are found by the device path
    _, self_hit = idx.search_device(jnp.asarray(extra[:8]), 1,
                                    interpret=True, p_tiles=p_all)
    hits = np.asarray(self_hit)[:, 0]
    ok = (hits == np.arange(3000, 3008)) | np.array([
        np.allclose(db[h], extra[i], atol=1e-6)
        for i, h in enumerate(hits)])
    assert ok.all()


def test_search_device_parity_pq_family(data):
    """BandIVFPQIndex.search_device matches search() on the PQ+int8-refine
    path, the direct refine scan (serve_from='refine'), and with OPQ
    rotation applied on device."""
    import jax.numpy as jnp

    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    idx = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=6, refine="int8", opq=True, kmeans_iters=5,
        pq_train_iters=5, tile_n=256, tile_q=16,
    )
    n_tiles = idx._n_pad_rows // idx.tile_n
    for kw in ({"p_tiles": n_tiles},                        # PQ + refine
               {"p_tiles": n_tiles, "serve_from": "refine"},
               {"p_tiles": max(4, n_tiles // 2), "refine_factor": 8,
                "n_pools": 2}):
        v_h, f_h = idx.search(q, 10, interpret=True, **kw)
        v_d, f_d = idx.search_device(jnp.asarray(q), 10, interpret=True,
                                     **kw)
        assert f_d.dtype == jnp.int32
        np.testing.assert_allclose(np.asarray(v_d), v_h, rtol=1e-4,
                                   atol=1e-4)
        assert (np.asarray(f_d).astype(np.int64) == f_h).all(), kw


def test_search_device_pq_pending_no_annex_fold(data):
    """r3 review (high): a device-streaming-built PQ index used to route
    search_device's fold-on-entry through the base-class ANNEX fold —
    orphaning _pending_codes (the next merge_pending concatenated stale
    codes against a shorter drain → misaligned arena), dropping the
    annexed rows from save (PQ merge_pending never folded the annex), and
    scoring annex rows at the wrong scale. search_device now scans pending
    exactly on device without folding; the PQ fold is always the family's
    own compact merge."""
    import jax
    import jax.numpy as jnp

    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    chunks = [jnp.asarray(db[s : s + 1000]) for s in range(0, 3000, 1000)]
    idx = BandIVFPQIndex.build_device_streaming(
        lambda i: chunks[i], 3, nlist=16, m=8, nbits=4, kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16, train_sample=1000)
    assert isinstance(idx._payload, jax.Array)  # the F1 trigger state
    idx.add(db[3000:3500])  # below the merge threshold
    assert idx._pending.size == 500
    p_all = idx._n_pad_rows // idx.tile_n
    v_d, f_d = idx.search_device(jnp.asarray(q), 10, interpret=True,
                                 p_tiles=p_all)
    # no annex fold happened: pending intact and 1:1 with its codes
    assert idx._annex is None or idx._annex["n"] == 0
    assert idx._pending.size == 500
    assert sum(c.shape[0] for c in idx._pending_codes) == 500
    v_h, f_h = idx.search(q, 10, interpret=True, p_tiles=p_all)
    np.testing.assert_allclose(np.asarray(v_d), v_h, rtol=1e-4, atol=1e-4)
    assert (np.asarray(f_d).astype(np.int64) == f_h).all()
    # the compact merge stays consistent (codes aligned with the drain)
    idx.merge_pending()
    assert idx.ntotal == 3500 and idx._pending.size == 0
    assert not idx._pending_codes
    _, f2 = idx.search(q, 10, interpret=True, p_tiles=p_all)
    assert recall_at_k(f2, gt) >= recall_at_k(f_h, gt) - 0.05


def test_search_device_host_refine_guard(data):
    """r3 review: refine='host' rescores from host RAM, so search_device
    must refuse — including when the store is PENDING-ONLY (the normal
    state after build_streaming, where _host_rows is None); the old guard
    passed that state and silently served unrefined tier-1 scores."""
    import jax.numpy as jnp
    import pytest as _pytest

    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, _ = data
    chunks = [db[s : s + 1000] for s in range(0, 4000, 1000)]
    idx = BandIVFPQIndex.build_streaming(
        iter(chunks), nlist=16, m=8, nbits=4, refine="host", kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16)
    assert idx._host_rows is None and idx._host_pending_rows
    with _pytest.raises(AssertionError, match="host"):
        idx.search_device(jnp.asarray(q), 10, interpret=True)


def test_pq_top2_per_bucket_candidates(data):
    """top2=True keeps each pool's best TWO distinct rows per bucket
    (ops/pallas_pq.py streaming top-2 merge). With identical
    (n_pools, l_buckets) and plan, slot-1 contents match the top1 merge
    exactly, so the top2 candidate set must be a duplicate-free SUPERSET
    of the top1 set; with refine the extra candidates must not regress
    recall."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q, gt = data
    idx = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=5, refine="none", kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16, residual=False,
    )
    n_tiles = idx._n_pad_rows // idx.tile_n
    # full slot extraction: k = all candidate slots each way; both runs
    # derive l_buckets=128 from (k_cand, slots_per_pool) so the pools and
    # the tile plan are identical
    v1, f1 = idx.search(q, 256, p_tiles=n_tiles, n_pools=2, interpret=True,
                        top2=False)
    v2, f2 = idx.search(q, 512, p_tiles=n_tiles, n_pools=2, interpret=True,
                        top2=True)
    for row in range(q.shape[0]):
        got1 = set(f1[row][v1[row] > -np.inf].tolist())
        l2 = f2[row][v2[row] > -np.inf].tolist()
        got2 = set(l2)
        assert len(got2) == len(l2), f"duplicate candidates in row {row}"
        assert got1 <= got2, (row, got1 - got2)

    idx_r = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=5, refine="int8", kmeans_iters=6,
        pq_train_iters=6, tile_n=256, tile_q=16,
    )
    _, r1 = idx_r.search(q, 10, p_tiles=n_tiles, refine_factor=64,
                         n_pools=2, interpret=True, top2=False)
    _, r2 = idx_r.search(q, 10, p_tiles=n_tiles, refine_factor=64,
                         n_pools=2, interpret=True, top2=True)
    rec1, rec2 = recall_at_k(r1, gt), recall_at_k(r2, gt)
    assert rec2 >= rec1 - 1e-9, (rec2, rec1)
    assert rec2 >= 0.8, rec2


def test_band_resid_top2_per_bucket(data):
    """top2 on the residual tiles kernel: duplicate-free superset of the
    top1 pool at identical plan (slot-1 merge unchanged), and it widens a
    dense range_search ball past the single-index l_buckets ceiling."""
    db, q, gt = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", residual=True,
                             kmeans_iters=6, tile_n=128, tile_q=16, seed=3)
    n_tiles = idx._payload.shape[0] // idx.tile_n
    v1, f1 = idx.search(q, 128, p_tiles=n_tiles, interpret=True, top2=False)
    v2, f2 = idx.search(q, 256, p_tiles=n_tiles, interpret=True, top2=True)
    assert v2.shape[1] == 256  # the pool really widened past l_buckets
    for row in range(q.shape[0]):
        got1 = set(f1[row][v1[row] > -np.inf].tolist())
        l2_ = f2[row][v2[row] > -np.inf].tolist()
        got2 = set(l2_)
        assert len(got2) == len(l2_), f"duplicate candidates in row {row}"
        assert got1 <= got2, (row, got1 - got2)
    # top-10 recall unchanged or better at the same op point
    r1 = recall_at_k(f1[:, :10], gt)
    r2 = recall_at_k(f2[:, :10], gt)
    assert r2 >= r1 - 1e-9 and r2 >= 0.9, (r2, r1)
    # dense range ball: top2 recovers in-ball rows the 128-slot pool drops
    radius = 0.5
    s_full = q.astype(np.float64) @ db.astype(np.float64).T
    lims_a, _, ids_a = idx.range_search(q, radius, k_start=64, interpret=True,
                                        p_tiles=n_tiles)
    lims_b, _, ids_b = idx.range_search(q, radius, k_start=64, interpret=True,
                                        p_tiles=n_tiles, top2=True)
    # top2 keeps 2 rows/bucket, so ≥3-way bucket collisions can still drop
    # in-ball rows — the guarantee is strictly FEWER misses, not zero
    missed_a = missed_b = 0
    for i in range(q.shape[0]):
        ball = set(np.flatnonzero(s_full[i] >= radius + 0.05).tolist())
        ga = set(ids_a[lims_a[i]:lims_a[i + 1]].tolist())
        gb = set(ids_b[lims_b[i]:lims_b[i + 1]].tolist())
        missed_a += len(ball - ga)
        missed_b += len(ball - gb)
    assert missed_b <= missed_a, (missed_b, missed_a)
    if missed_a:  # the 128-slot pool drops rows on this data — top2 must
        assert missed_b < missed_a, (missed_b, missed_a)  # recover some
    # filtered search composes with top2 (mask applies before extraction)
    allow = np.zeros(db.shape[0], bool)
    allow[::3] = True
    vf, ff = idx.search(q, 32, p_tiles=n_tiles, interpret=True, top2=True,
                        where=allow)
    assert allow[ff[ff >= 0]].all()
