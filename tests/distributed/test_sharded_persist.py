"""Sharded index save/load on the 8-device simulated mesh (SURVEY.md §2.2
persistence row): build → save → load → search parity, plus post-load adds.
The artifact layout is parallel/persist.py's (top manifest + per-shard
single-index dirs), loaded polymorphically through index.load_index."""

import numpy as np

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index import load_index
from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu.parallel.dist_ivf import ShardedIVFPQIndex
from cloudvectordb_tpu.parallel.mesh import make_mesh


def test_sharded_band_save_load_parity(tmp_path):
    db = clustered_vectors(4096, 64, n_clusters=32, seed=200, normalize=True)
    q = queries_from(db, 32, seed=201, normalize=True)
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIndex.build(
        db, nlist=16, mesh=mesh, dtype="int8", kmeans_iters=6,
        tile_n=128, tile_q=16, seed=5, residual=True, slack=0.2,
    )
    st = idx._device_state()
    v1, i1 = idx.search(q, 10, p_tiles=st["n_tiles"])
    idx.save(tmp_path / "shband")

    loaded = load_index(tmp_path / "shband", mesh=mesh)
    assert isinstance(loaded, ShardedBandIndex)
    assert loaded.ntotal == idx.ntotal and loaded._scale == idx._scale
    v2, i2 = loaded.search(q, 10, p_tiles=st["n_tiles"])
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5)


def test_sharded_band_load_default_mesh_and_add(tmp_path):
    """load without an explicit mesh sizes one from the manifest; slack adds
    keep working on the loaded index (arrays arrive mmap'd read-only)."""
    db = clustered_vectors(3000, 64, n_clusters=16, seed=202, normalize=True)
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIndex.build(
        db[:2800], nlist=8, mesh=mesh, dtype="int8", kmeans_iters=5,
        tile_n=128, tile_q=16, seed=7, residual=True, slack=0.3,
    )
    idx.save(tmp_path / "shband2")
    loaded = ShardedBandIndex.load(tmp_path / "shband2")
    assert loaded.nshards == idx.nshards
    before = loaded.ntotal
    # adds go to a single shard's slack arena via the per-shard add path
    loaded._shards[0].add(db[2800:2900])
    assert loaded.ntotal == before + 100


def test_sharded_ivfpq_save_load_parity_with_refine(tmp_path):
    db = clustered_vectors(4096, 64, n_clusters=32, seed=204, normalize=True)
    q = queries_from(db, 32, seed=205, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    mesh = make_mesh(axis_name="shard")
    idx = ShardedIVFPQIndex.build(
        db, nlist=16, m=8, mesh=mesh, refine="int8", kmeans_iters=6,
        pq_train_iters=4, seed=3,
    )
    v1, i1 = idx.search(q, 10, nprobe=16)
    idx.save(tmp_path / "shpq")

    loaded = load_index(tmp_path / "shpq", mesh=mesh)
    assert isinstance(loaded, ShardedIVFPQIndex)
    assert loaded.refine == "int8"
    assert loaded._refine_scale == idx._refine_scale
    v2, i2 = loaded.search(q, 10, nprobe=16)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5)
    assert recall_at_k(i2, gt) >= 0.85

    # post-load adds reuse the persisted refine store + global id counter
    loaded.add(db[:64])
    assert loaded.ntotal == idx.ntotal + 64
    v3, i3 = loaded.search(db[:8], 1, nprobe=16)
    # each re-added row should retrieve itself or its identical twin
    assert ((i3[:, 0] == np.arange(8)) | (i3[:, 0] >= idx.ntotal)).all()


def test_build_index_nshards_config(tmp_path):
    """The CLI/pipeline surface: IndexConfig(nshards>0) builds the sharded
    wrapper, save/load round-trips through the polymorphic loader."""
    from cloudvectordb_tpu.index import build_index
    from cloudvectordb_tpu.utils.config import IndexConfig

    db = clustered_vectors(2048, 64, n_clusters=16, seed=208, normalize=True)
    q = queries_from(db, 16, seed=209, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    cfg = IndexConfig(kind="band_ivf", nlist=16, nshards=8, dtype="int8",
                      residual=True, kmeans_iters=5, train_sample=2048)
    idx = build_index(db, cfg)
    assert isinstance(idx, ShardedBandIndex) and idx.nshards == 8
    idx.save(tmp_path / "cfg_idx", extra_meta={"config_hash": cfg.config_hash()})
    loaded = load_index(tmp_path / "cfg_idx")
    st = loaded._device_state()
    _, found = loaded.search(q, 10, p_tiles=st["n_tiles"])
    assert recall_at_k(found, gt) >= 0.85


def test_sharded_tune_and_op_point_roundtrip(tmp_path):
    """r3: sharded wrappers expose tune(); the op point fills search()'s
    sentinel knobs and round-trips through the sharded manifest."""
    db = clustered_vectors(4096, 64, n_clusters=32, seed=210, normalize=True)
    q = queries_from(db, 48, seed=211, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    mesh = make_mesh(axis_name="shard")
    band = ShardedBandIndex.build(
        db, nlist=16, mesh=mesh, dtype="int8", kmeans_iters=6,
        tile_n=128, tile_q=16, seed=5, residual=True,
    )
    rep = band.tune(q, k=10, target_recall=0.9, gt=gt)
    assert rep["met"], rep
    _, f = band.search(q, 10)  # op point serves by default
    assert recall_at_k(f, gt) >= 0.9
    band.save(tmp_path / "tuned_band")
    loaded = ShardedBandIndex.load(tmp_path / "tuned_band", mesh=mesh)
    assert loaded._op_point == rep["op"]
    _, f2 = loaded.search(q, 10)
    assert recall_at_k(f2, gt) >= 0.9

    pq = ShardedIVFPQIndex.build(
        db, nlist=16, m=8, mesh=mesh, refine="int8", kmeans_iters=6,
        pq_train_iters=4, seed=3,
    )
    rep2 = pq.tune(q, k=10, target_recall=0.9, gt=gt)
    assert rep2["met"], rep2
    assert {"nprobe"} <= set(rep2["op"])
    _, g2 = pq.search(q, 10)
    assert recall_at_k(g2, gt) >= 0.9


def test_sharded_band_elastic_reshard(tmp_path):
    """r3: loading onto a mesh with a different 'shard' extent re-partitions
    rows host-side (8 ↔ 16 shards without a rebuild). At full
    tile coverage the searches are exactly equal: payloads move verbatim,
    requantized to the same global scale staging always used."""
    db = clustered_vectors(4096, 64, n_clusters=32, seed=212, normalize=True)
    q = queries_from(db, 32, seed=213, normalize=True)
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIndex.build(
        db, nlist=16, mesh=mesh, dtype="int8", kmeans_iters=6,
        tile_n=128, tile_q=16, seed=5, residual=True, slack=0.2,
    )
    st = idx._device_state()
    v1, i1 = idx.search(q, 10, p_tiles=st["n_tiles"])
    idx.save(tmp_path / "band_elastic")
    for s_new in (4, 3):  # shrink, and a non-divisor count
        loaded = ShardedBandIndex.load(
            tmp_path / "band_elastic",
            mesh=make_mesh(s_new, axis_name="shard"))
        assert loaded.nshards == s_new
        assert loaded.ntotal == idx.ntotal
        st2 = loaded._device_state()
        v2, i2 = loaded.search(q, 10, p_tiles=st2["n_tiles"])
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-5)
        # further adds allocate past every existing gid
        loaded._shards[0].add(db[:4])
        assert loaded.ntotal == idx.ntotal + 4


def test_sharded_ivfpq_elastic_reshard_with_refine(tmp_path):
    """PQ codes move verbatim across the re-partition; the gid-keyed refine
    store re-splits by arena membership — search parity is exact."""
    db = clustered_vectors(4096, 64, n_clusters=32, seed=214, normalize=True)
    q = queries_from(db, 32, seed=215, normalize=True)
    mesh = make_mesh(axis_name="shard")
    idx = ShardedIVFPQIndex.build(
        db, nlist=16, m=8, mesh=mesh, refine="int8", kmeans_iters=6,
        pq_train_iters=4, seed=3,
    )
    v1, i1 = idx.search(q, 10, nprobe=16)
    idx.save(tmp_path / "pq_elastic")
    loaded = ShardedIVFPQIndex.load(
        tmp_path / "pq_elastic", mesh=make_mesh(4, axis_name="shard"))
    assert loaded.nshards == 4 and loaded.ntotal == idx.ntotal
    assert loaded._refine_scale == idx._refine_scale
    v2, i2 = loaded.search(q, 10, nprobe=16)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5)
    # post-reshard adds reuse the re-split refine store + id counter
    loaded.add(db[:32])
    assert loaded.ntotal == idx.ntotal + 32


def test_sharded_ivfpq_save_load_no_refine(tmp_path):
    db = clustered_vectors(2048, 64, n_clusters=16, seed=206, normalize=True)
    q = queries_from(db, 16, seed=207, normalize=True)
    mesh = make_mesh(axis_name="shard")
    idx = ShardedIVFPQIndex.build(
        db, nlist=8, m=8, mesh=mesh, refine="none", kmeans_iters=5,
        pq_train_iters=3, seed=9,
    )
    v1, i1 = idx.search(q, 5, nprobe=8)
    idx.save(tmp_path / "shpq_nr")
    loaded = ShardedIVFPQIndex.load(tmp_path / "shpq_nr", mesh=mesh)
    v2, i2 = loaded.search(q, 5, nprobe=8)
    np.testing.assert_array_equal(i1, i2)
