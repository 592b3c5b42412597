"""Streaming sharded builds: 8-shard indexes built from
a chunk GENERATOR — the f32 corpus never materializes on the host — must
match the materialized builders' recall."""


from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu.parallel.dist_ivf import ShardedIVFPQIndex
from cloudvectordb_tpu.parallel.mesh import make_mesh


def _chunked(db, size):
    for s in range(0, db.shape[0], size):
        yield db[s : s + size]


def test_sharded_band_streaming_build():
    db = clustered_vectors(4096, 64, n_clusters=32, seed=70, normalize=True)
    q = queries_from(db, 32, seed=71, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    mesh = make_mesh(axis_name="shard")
    kw = dict(dtype="int8", kmeans_iters=6, tile_n=128, tile_q=16, seed=1)
    streamed = ShardedBandIndex.build_streaming(
        _chunked(db, 512), nlist=16, mesh=mesh, **kw)
    assert streamed.ntotal == 4096 and streamed.nshards == 8
    n_tiles = max(int(sh._payload.shape[0]) for sh in streamed._shards) // 128
    _, i_st = streamed.search(q, 10, p_tiles=n_tiles)
    r_st = recall_at_k(i_st, gt)
    materialized = ShardedBandIndex.build(db, nlist=16, mesh=mesh, **kw)
    _, i_mat = materialized.search(q, 10, p_tiles=n_tiles)
    r_mat = recall_at_k(i_mat, gt)
    assert r_st >= r_mat - 0.05, (r_st, r_mat)
    assert r_st >= 0.8, r_st
    # ids are global and unique across shards
    assert int(i_st.max()) < 4096 and int(i_st.min()) >= 0


def test_sharded_ivfpq_streaming_build_with_refine():
    db = clustered_vectors(4096, 32, n_clusters=24, seed=72, normalize=True)
    q = queries_from(db, 16, seed=73, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    mesh = make_mesh(axis_name="shard")
    kw = dict(nbits=6, metric="ip", kmeans_iters=6, pq_train_iters=6, seed=3)
    streamed = ShardedIVFPQIndex.build_streaming(
        _chunked(db, 512), nlist=16, m=8, mesh=mesh, refine="int8", **kw)
    assert streamed.ntotal == 4096
    _, i_st = streamed.search(q, 10, nprobe=16)
    r_st = recall_at_k(i_st, gt)
    assert r_st >= 0.85, r_st
    # streaming build still accepts incremental adds with refine
    extra = clustered_vectors(128, 32, n_clusters=24, seed=74, normalize=True)
    streamed.add(extra)
    assert streamed.ntotal == 4096 + 128
    _, late = streamed.search(extra[:16], 1, nprobe=16)
    assert (late[:, 0] >= 4096).mean() >= 0.8  # added rows retrieved
