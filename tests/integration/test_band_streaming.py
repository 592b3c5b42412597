"""Streaming build of the band index matches the bulk build's results."""

import numpy as np

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex


def test_streaming_build_matches_bulk():
    db = clustered_vectors(6000, 64, n_clusters=32, seed=170, normalize=True)
    q = queries_from(db, 32, seed=171, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    kw = dict(dtype="int8", kmeans_iters=6, tile_n=256, tile_q=16, seed=4)

    chunks = (db[s : s + 1500] for s in range(0, 6000, 1500))
    stream = BandIVFIndex.build_streaming(chunks, nlist=16, **kw)
    assert stream.ntotal == 6000
    n_tiles = stream._payload.shape[0] // stream.tile_n
    _, i_s = stream.search(q, 10, p_tiles=n_tiles, interpret=True)
    r_s = recall_at_k(i_s, gt)

    bulk = BandIVFIndex.build(db, nlist=16, **kw)
    _, i_b = bulk.search(q, 10, p_tiles=n_tiles, interpret=True)
    r_b = recall_at_k(i_b, gt)
    # streaming trains k-means on the first chunk only → small tolerance
    assert r_s >= r_b - 0.1, (r_s, r_b)
    assert r_s >= 0.8, r_s
    # ids must be valid original indices (the whole corpus reachable)
    assert i_s.min() >= 0 and i_s.max() < 6000
    # late chunks are findable
    q_late = db[5500:5508]
    _, late = stream.search(q_late, 1, p_tiles=n_tiles, interpret=True)
    _, gt_late = brute_force_topk(db, q_late, 1, metric="ip")
    assert recall_at_k(late, gt_late) >= 0.7


def test_streaming_band_pq_opq():
    """Config #5 verbatim at test scale: OPQ+IVF-PQ, streaming build, refine."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db = clustered_vectors(6000, 32, n_clusters=24, seed=175, normalize=True)
    q = queries_from(db, 32, seed=176, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    chunks = (db[s : s + 2000] for s in range(0, 6000, 2000))
    idx = BandIVFPQIndex.build_streaming(
        chunks, nlist=16, m=8, nbits=6, opq=True, refine="int8",
        kmeans_iters=6, pq_train_iters=5, tile_n=256, tile_q=16,
    )
    assert idx.ntotal == 6000 and idx.opq_matrix is not None
    n_tiles = idx._n_pad_rows // idx.tile_n
    _, found = idx.search(q, 10, p_tiles=n_tiles, interpret=True)
    r = recall_at_k(found, gt)
    assert r >= 0.75, r
    assert found.min() >= 0 and found.max() < 6000


def test_build_device_streaming_matches_build():
    """Two-pass device-resident assembly (scatter arena) must agree with the
    materialized build: same quantizer seed => same arena content."""
    import jax.numpy as jnp
    from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
    from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
    from cloudvectordb_tpu.index.ivf_band import BandIVFIndex

    db = clustered_vectors(4096, 64, n_clusters=32, seed=95, normalize=True)
    q = queries_from(db, 32, seed=96, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    chunks = [jnp.asarray(db[s : s + 1024]) for s in range(0, 4096, 1024)]
    idx = BandIVFIndex.build_device_streaming(
        lambda i: chunks[i], 4, nlist=16, train_sample=1024,
        kmeans_iters=6, tile_n=256, tile_q=16,
    )
    assert idx.ntotal == 4096
    p_all = idx._payload.shape[0] // idx.tile_n
    _, found = idx.search(q, 10, interpret=True, p_tiles=p_all)
    r = recall_at_k(found, gt)
    assert r >= 0.85, r
    # added rows from the LSM path still work on a device-resident arena? not
    # required at this scale; assert ids are the original row order instead
    rec = idx.reconstruct(np.arange(16))
    cos = np.sum(rec * db[:16], axis=1) / (
        np.linalg.norm(rec, axis=1) * np.linalg.norm(db[:16], axis=1))
    assert cos.min() > 0.95


def test_pq_build_device_streaming_matches_build():
    import jax.numpy as jnp
    from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
    from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db = clustered_vectors(4096, 64, n_clusters=32, seed=97, normalize=True)
    q = queries_from(db, 32, seed=98, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    chunks = [jnp.asarray(db[s : s + 1024]) for s in range(0, 4096, 1024)]
    idx = BandIVFPQIndex.build_device_streaming(
        lambda i: chunks[i], 4, nlist=16, m=8, train_sample=1024, opq=True,
        nbits=6, refine="int8", kmeans_iters=5, pq_train_iters=5,
        tile_n=256, tile_q=16,
    )
    assert idx.ntotal == 4096 and idx.opq_matrix is not None
    n_tiles = idx._n_pad_rows // idx.tile_n
    _, found = idx.search(q, 10, p_tiles=n_tiles, interpret=True)
    r = recall_at_k(found, gt)
    assert r >= 0.8, r
    # incremental add still works on the device-resident arena
    extra = clustered_vectors(64, 64, n_clusters=32, seed=99, normalize=True)
    idx.add(extra)
    _, late = idx.search(extra[:16], 1, interpret=True, p_tiles=n_tiles)
    assert (late[:, 0] >= 4096).mean() >= 0.85
    # forced merge converts the row-major device arena back to code-major
    assert idx._codes_row_major
    idx.merge_pending()
    assert not idx._codes_row_major and idx.ntotal == 4096 + 64
    _, f3 = idx.search(q, 10, p_tiles=n_tiles, interpret=True)
    assert recall_at_k(f3, gt) >= r - 0.05


def test_pq_row_major_save_load_roundtrip(tmp_path):
    import jax.numpy as jnp
    from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
    from cloudvectordb_tpu.index import load_index
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db = clustered_vectors(2048, 64, n_clusters=16, seed=101, normalize=True)
    q = queries_from(db, 16, seed=102, normalize=True)
    chunks = [jnp.asarray(db[s : s + 512]) for s in range(0, 2048, 512)]
    idx = BandIVFPQIndex.build_device_streaming(
        lambda i: chunks[i], 4, nlist=8, m=8, train_sample=512,
        nbits=6, refine="int8", kmeans_iters=5, pq_train_iters=5,
        tile_n=256, tile_q=16,
    )
    assert idx._codes_row_major
    n_tiles = idx._n_pad_rows // idx.tile_n
    v1, i1 = idx.search(q, 5, p_tiles=n_tiles, interpret=True)
    idx.save(tmp_path / "rm")
    idx2 = load_index(tmp_path / "rm")
    assert idx2._codes_row_major and idx2._local_rm is not None
    v2, i2 = idx2.search(q, 5, p_tiles=n_tiles, interpret=True)
    np.testing.assert_array_equal(i1, i2)
