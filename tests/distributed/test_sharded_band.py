"""Sharded tile-pruned index on the 8-device simulated mesh (config #4 fast
path): full-coverage recall ≈ int8 ceiling; ids valid across shards."""

import numpy as np

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu.parallel.mesh import make_mesh


def test_sharded_band_recall_and_ids():
    db = clustered_vectors(4096, 64, n_clusters=32, seed=180, normalize=True)
    q = queries_from(db, 32, seed=181, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIndex.build(
        db, nlist=16, mesh=mesh, dtype="int8", kmeans_iters=6,
        tile_n=128, tile_q=16, seed=5,
    )
    assert idx.ntotal == 4096
    st = idx._device_state()
    _, found = idx.search(q, 10, p_tiles=st["n_tiles"])  # full coverage
    r = recall_at_k(found, gt)
    assert r >= 0.85, r  # int8 ceiling on this data
    assert found.min() >= 0 and found.max() < 4096
    # every shard's partition contributes: ids span all 8 row ranges
    owners = set((found // (4096 // 8)).flatten().tolist())
    assert len(owners) >= 6
    # pruned coverage still recalls
    _, found_p = idx.search(q, 10, nprobe=8)
    assert recall_at_k(found_p, gt) >= r - 0.15


def test_sharded_band_parity_with_single_index():
    """Merge-correctness: at full tile coverage both the
    sharded and single-device index are exact int8 scans of the same rows
    under the same quantizer. Sharded recall may legitimately EXCEED the
    single index (each shard keeps its own bucketed-merge pool → 8× fewer
    bucket collisions) but must never fall below it — a merge bug (wrong
    ids, dropped shards, bad all_gather transpose) costs ≫1% here where a
    loose 0.85 floor would not notice."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFIndex

    db = clustered_vectors(4096, 64, n_clusters=32, seed=182, normalize=True)
    q = queries_from(db, 64, seed=183, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    mesh = make_mesh(axis_name="shard")
    kw = dict(dtype="int8", kmeans_iters=6, tile_n=128, tile_q=16, seed=5)
    sharded = ShardedBandIndex.build(db, nlist=16, mesh=mesh, **kw)
    single = BandIVFIndex.build(db, nlist=16, **kw)
    st = sharded._device_state()
    _, i_sh = sharded.search(q, 10, p_tiles=st["n_tiles"])
    _, i_si = single.search(
        q, 10, interpret=True,
        p_tiles=single._payload.shape[0] // single.tile_n,
    )
    r_sh, r_si = recall_at_k(i_sh, gt), recall_at_k(i_si, gt)
    assert r_sh >= r_si - 0.005, (r_sh, r_si)
    assert r_sh >= 0.9, r_sh


def test_sharded_ivfpq_parity_with_single_index():
    """Same-quantizer IVF-PQ parity: per-shard probing covers the same global
    lists, so sharded recall must match the single index within ±0.01."""
    from cloudvectordb_tpu.index import IVFPQIndex
    from cloudvectordb_tpu.parallel.dist_ivf import ShardedIVFPQIndex

    db = clustered_vectors(4096, 32, n_clusters=24, seed=184, normalize=True)
    q = queries_from(db, 64, seed=185, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    mesh = make_mesh(axis_name="shard")
    kw = dict(nbits=6, metric="ip", kmeans_iters=6, pq_train_iters=6, seed=3,
              train_sample=4096)
    sharded = ShardedIVFPQIndex.build(db, nlist=16, m=8, mesh=mesh, **kw)
    single = IVFPQIndex.build(db, nlist=16, m=8, **kw)
    # identical training data + seed → identical quantizers
    np.testing.assert_allclose(sharded._shards[0].centroids, single.centroids,
                               atol=1e-5)
    _, i_sh = sharded.search(q, 10, nprobe=16)
    _, i_si = single.search(q, 10, nprobe=16)
    r_sh, r_si = recall_at_k(i_sh, gt), recall_at_k(i_si, gt)
    assert abs(r_sh - r_si) <= 0.01, (r_sh, r_si)


def test_sharded_band_residual_mode():
    """Residual-int8 shards: per-shard resid kernel + centroid term, global
    id validity, and recall at least matching whole-row int8 shards."""
    db = clustered_vectors(4096, 64, n_clusters=32, seed=186, normalize=True)
    q = queries_from(db, 32, seed=187, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    mesh = make_mesh(axis_name="shard")
    kw = dict(dtype="int8", kmeans_iters=6, tile_n=128, tile_q=16, seed=5)
    res = ShardedBandIndex.build(db, nlist=16, mesh=mesh, residual=True, **kw)
    row = ShardedBandIndex.build(db, nlist=16, mesh=mesh, **kw)
    st = res._device_state()
    assert "local" in st and "valid_end" in st
    _, i_res = res.search(q, 10, p_tiles=st["n_tiles"])
    _, i_row = row.search(q, 10, p_tiles=st["n_tiles"])
    r_res, r_row = recall_at_k(i_res, gt), recall_at_k(i_row, gt)
    assert r_res >= r_row - 0.01, (r_res, r_row)
    assert int(i_res.max()) < 4096 and int(i_res.min()) >= 0


def test_sharded_band_filtered_search():
    """Filtered sharded search (index/filters.py): the replicated allow
    bitmap reaches every shard, no disallowed id survives the merge, and
    results match the single-index filtered search at full coverage."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFIndex

    db = clustered_vectors(4096, 64, n_clusters=32, seed=196, normalize=True)
    q = queries_from(db, 32, seed=197, normalize=True)
    mesh = make_mesh(axis_name="shard")
    kw = dict(dtype="int8", kmeans_iters=6, tile_n=128, tile_q=16, seed=5)
    sharded = ShardedBandIndex.build(db, nlist=16, mesh=mesh, residual=True,
                                     **kw)
    single = BandIVFIndex.build(db, nlist=16, residual=True, **kw)
    rng = np.random.default_rng(7)
    mask = rng.random(4096) < 0.4
    st = sharded._device_state()
    v_sh, i_sh = sharded.search(q, 10, p_tiles=st["n_tiles"], where=mask)
    assert mask[i_sh[i_sh >= 0]].all(), "disallowed id crossed the merge"
    _, i_si = single.search(
        q, 10, interpret=True,
        p_tiles=single._payload.shape[0] // single.tile_n, where=mask)
    _, gt_all = brute_force_topk(db[mask], q, 10, metric="ip")
    gids = np.flatnonzero(mask)
    gt = gids[gt_all]  # oracle restricted to allowed rows
    r_sh, r_si = recall_at_k(i_sh, gt), recall_at_k(i_si, gt)
    assert r_sh >= r_si - 0.01, (r_sh, r_si)
    assert r_sh >= 0.85, r_sh
    # a low-selectivity filter pads with the (-inf, -1) convention
    few = np.array([5, 77, 1234])
    v3, i3 = sharded.search(q, 10, p_tiles=st["n_tiles"], where=few)
    assert set(i3[i3 >= 0].ravel()) <= set(few.tolist())
    assert (i3[:, 3:] == -1).all() and np.isneginf(v3[:, 3:]).all()


def test_sharded_band_residual_streaming():
    def chunks():
        db = clustered_vectors(4096, 64, n_clusters=32, seed=188,
                               normalize=True)
        for s in range(0, 4096, 512):
            yield db[s : s + 512]

    db = clustered_vectors(4096, 64, n_clusters=32, seed=188, normalize=True)
    q = queries_from(db, 32, seed=189, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIndex.build_streaming(
        chunks(), nlist=16, mesh=mesh, dtype="int8", residual=True,
        kmeans_iters=6, tile_n=128, tile_q=16, seed=5)
    st = idx._device_state()
    _, found = idx.search(q, 10, p_tiles=st["n_tiles"])
    assert recall_at_k(found, gt) >= 0.9


def test_sharded_band_2d_replica_mesh_parity():
    """('replica', 'shard') 2×4 mesh: full index replicas across the replica
    axis (multi-slice serving — replicas split query traffic, shards fan out
    within a slice). Results must be IDENTICAL to the 1-D 4-shard mesh: the
    replica axis only partitions the batch."""
    from cloudvectordb_tpu.parallel.mesh import make_2d_mesh

    db = clustered_vectors(4096, 64, n_clusters=32, seed=77, normalize=True)
    q = queries_from(db, 64, seed=78, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    kw = dict(nlist=16, dtype="int8", residual=True, kmeans_iters=6,
              tile_n=128, tile_q=16, seed=5)
    flat = ShardedBandIndex.build(
        db, mesh=make_mesh(4, axis_name="shard"), **kw)
    twod = ShardedBandIndex.build(db, mesh=make_2d_mesh(2, 4), **kw)
    st = flat._device_state()
    v1, i1 = flat.search(q, 10, p_tiles=st["n_tiles"])
    v2, i2 = twod.search(q, 10, p_tiles=st["n_tiles"])
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-5)
    assert recall_at_k(i2, gt) >= 0.9


def test_sharded_slack_build_preserves_hole_markers():
    """Slack arenas mark holes with id -1; the sharded builder's global-id
    offset must not shift them into the valid range (a phantom would alias
    a real row's id, and merges would absorb garbage rows)."""
    db = clustered_vectors(2048, 64, n_clusters=16, seed=55, normalize=True)
    idx = ShardedBandIndex.build(
        db, nlist=8, mesh=make_mesh(4, axis_name="shard"), dtype="int8",
        residual=True, slack=0.3, kmeans_iters=4, tile_n=128, tile_q=8)
    seen = []
    for sh in idx._shards:
        ids = np.asarray(sh._ids, np.int64)
        holes = ids < 0
        assert holes.sum() > 0  # slack slots exist
        assert (ids[holes] == -1).all()
        seen.append(ids[~holes])
    allv = np.concatenate(seen)
    assert allv.size == db.shape[0]
    assert np.unique(allv).size == db.shape[0]  # no duplicated global ids


def test_sharded_band_add():
    """r3 review: the documented s.add(v) surface — wrapper-allocated
    global ids (collision-free across shards), rows land on the smallest
    shard, searchable after the automatic re-stage."""
    db = clustered_vectors(4096, 64, n_clusters=32, seed=188, normalize=True)
    extra = clustered_vectors(256, 64, n_clusters=32, seed=189,
                              normalize=True)
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIndex.build(
        db, nlist=16, mesh=mesh, dtype="int8", residual=True,
        kmeans_iters=6, tile_n=128, tile_q=16, seed=5)
    idx._device_state()  # stage, so add() must invalidate + re-stage
    before = [sh.ntotal for sh in idx._shards]
    ids = idx.add(extra)
    assert idx.ntotal == 4096 + 256
    np.testing.assert_array_equal(ids, np.arange(4096, 4096 + 256))
    # exactly one shard grew, by the full batch
    after = [sh.ntotal for sh in idx._shards]
    grew = [a - b for a, b in zip(after, before)]
    assert sorted(grew) == [0] * 7 + [256]
    # no id collides across shards
    all_ids = np.concatenate([
        np.asarray(sh._ids)[np.asarray(sh._ids) >= 0] for sh in idx._shards])
    assert all_ids.size == np.unique(all_ids).size == 4096 + 256
    st = idx._device_state()
    _, found = idx.search(extra[:16], 1, p_tiles=st["n_tiles"])
    hits = (found.ravel() >= 4096).mean()
    assert hits >= 0.9, hits  # new rows self-retrieve under their new ids
    # add composes with remove: freed ids never reused
    idx.remove(ids[:100])
    ids2 = idx.add(extra[:50])
    assert ids2.min() >= 4096 + 256


def test_sharded_band_range_search():
    """RangeSearchMixin on the sharded wrapper, checked against the numpy
    oracle: the dense radius ball here (~125 hits/query) exceeds a SINGLE
    band index's per-query candidate pool (l_buckets = tile_n = 128, where
    slot-max collisions drop in-ball rows), but the 8-shard merge pools
    8 × 128 candidates — the sharded wrapper must surface the full ball."""
    db = clustered_vectors(2048, 64, n_clusters=16, seed=190, normalize=True)
    q = queries_from(db, 16, seed=191, normalize=True)
    mesh = make_mesh(axis_name="shard")
    kw = dict(dtype="int8", kmeans_iters=6, tile_n=128, tile_q=16, seed=5)
    sharded = ShardedBandIndex.build(db, nlist=16, mesh=mesh, **kw)
    st = sharded._device_state()
    radius = 0.6
    lims_s, sc_s, ids_s = sharded.range_search(
        q, radius, k_start=8, p_tiles=st["n_tiles"])
    s_full = q.astype(np.float64) @ db.astype(np.float64).T
    for i in range(q.shape[0]):
        got = set(ids_s[lims_s[i]:lims_s[i + 1]].tolist())
        # every clear in-ball row found (int8 noise margin on the edge) …
        clear = set(np.flatnonzero(s_full[i] >= radius + 0.05).tolist())
        assert clear <= got, (i, clear - got)
        # … and every returned hit is a true near neighbor up to that noise
        assert all(s_full[i, g] >= radius - 0.05 for g in got), i
        # CSR scores sorted descending within the row
        row = sc_s[lims_s[i]:lims_s[i + 1]]
        assert (np.diff(row) <= 1e-6).all()


def test_sharded_band_top2():
    """top2 rides the sharded path (statics contract + per-shard kernel):
    sorted scores must dominate the top1 run elementwise (the union pool
    only grows) and ids must be duplicate-free."""
    db = clustered_vectors(2048, 64, n_clusters=16, seed=200, normalize=True)
    q = queries_from(db, 16, seed=201, normalize=True)
    mesh = make_mesh(axis_name="shard")
    kw = dict(dtype="int8", residual=True, kmeans_iters=6, tile_n=128,
              tile_q=16, seed=5)
    idx = ShardedBandIndex.build(db, nlist=16, mesh=mesh, **kw)
    st = idx._device_state()
    v1, i1 = idx.search(q, 32, p_tiles=st["n_tiles"], top2=False)
    v2, i2 = idx.search(q, 32, p_tiles=st["n_tiles"], top2=True)
    assert (v2 >= v1 - 1e-5).all()
    for row in range(q.shape[0]):
        ids_row = i2[row][v2[row] > -np.inf].tolist()
        assert len(set(ids_row)) == len(ids_row)
