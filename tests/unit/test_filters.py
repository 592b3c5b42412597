"""Filtered search (index/filters.py): exact score-time masking on the
residual-int8 kernel path, pending/annex filtering, device twin parity,
and the oversample fallback for non-masking families."""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index.filters import IdFilter, filtered_search
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=150, normalize=True)
    q = queries_from(db, 48, seed=151, normalize=True)
    return db, q


@pytest.fixture(scope="module")
def resid_index(data):
    db, _ = data
    return BandIVFIndex.build(db, nlist=16, dtype="int8", residual=True,
                              kmeans_iters=6, tile_n=256, tile_q=16)


def _oracle_filtered(db, q, k, allowed_mask):
    """Exact top-k restricted to allowed rows (numpy)."""
    s = q @ db.T
    s = np.where(allowed_mask[None, :], s, -np.inf)
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


def test_idfilter_coerce_forms():
    mask = np.zeros(100, bool)
    mask[[3, 7, 50]] = True
    f1 = IdFilter.coerce(mask, 100)
    f2 = IdFilter.coerce(np.array([3, 7, 50]), 100)
    f3 = IdFilter.coerce(f1, 100)
    assert f3 is f1
    g = np.array([3, 7, 50, 4, -1, 10_000])
    exp = np.array([True, True, True, False, False, False])
    assert (f1.allowed_np(g) == exp).all()
    assert (f2.allowed_np(g) == exp).all()
    assert f1.n_allowed == f2.n_allowed == 3
    # device twin agrees
    import jax.numpy as jnp

    assert (np.asarray(f1.allowed_dev(jnp.asarray(g))) == exp).all()


def test_filtered_band_resid_exact_vs_oracle(data, resid_index):
    """Full coverage + 50% filter: results match the allowed-only oracle
    at the arena's quantization ceiling, and NO disallowed id appears."""
    db, q = data
    idx = resid_index
    rng = np.random.default_rng(0)
    mask = rng.random(db.shape[0]) < 0.5
    gt_f = _oracle_filtered(db, q, 10, mask)
    p_all = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    v, f = idx.search(q, 10, interpret=True, p_tiles=p_all, where=mask)
    assert mask[f[f >= 0]].all(), "disallowed id returned"
    assert recall_at_k(f, gt_f) >= 0.9
    # unfiltered results on the same index differ (the filter did bite)
    _, f_un = idx.search(q, 10, interpret=True, p_tiles=p_all)
    assert not (f_un == f).all()


def test_filtered_low_selectivity_exact(data, resid_index):
    """5 allowed ids, full coverage: exactly those ids rank (the top-5 of
    the restricted oracle), remaining slots pad with (-inf, -1)."""
    db, q = data
    idx = resid_index
    allowed = np.array([11, 222, 1333, 2444, 3555])
    p_all = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    v, f = idx.search(q, 10, interpret=True, p_tiles=p_all, where=allowed)
    assert set(f[f >= 0].ravel()) <= set(allowed.tolist())
    assert (f[:, 5:] == -1).all() and np.isneginf(v[:, 5:]).all()
    # each query's top-1 equals the restricted oracle's top-1 (scores are
    # residual-int8 quantized; top-1 among 5 well-separated rows is stable)
    mask = np.zeros(db.shape[0], bool)
    mask[allowed] = True
    gt_f = _oracle_filtered(db, q, 5, mask)
    assert (f[:, 0] == gt_f[:, 0]).mean() >= 0.9


def test_filtered_pending_and_annex(data):
    """The filter must bite pending/annex rows too: add rows (some landing
    in the annex via the fold threshold, some staying pending), then
    filter exactly the added ids out — none may return, while an
    allow-only-added filter returns only them."""
    db, q = data
    idx = BandIVFIndex.build(db[:3000], nlist=16, dtype="int8",
                             residual=True, kmeans_iters=6, tile_n=128,
                             tile_q=16)
    for s in range(0, 1000, 250):
        idx.add(db[3000 + s : 3250 + s])
    assert idx._pending.size > 0 or (idx._annex and idx._annex["n"])
    p_all = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    base_ids = np.arange(3000)
    v, f = idx.search(db[3000:3050], 5, interpret=True, p_tiles=p_all,
                      where=base_ids)
    assert (f[f >= 0] < 3000).all(), "added (filtered-out) row returned"
    # the inverse filter returns ONLY added rows — each query is an added
    # row itself, so its top-1 must be its own id
    v2, f2 = idx.search(db[3000:3050], 5, interpret=True, p_tiles=p_all,
                        where=np.arange(3000, 4000))
    assert (f2[f2 >= 0] >= 3000).all()
    assert (f2[:, 0] == np.arange(3000, 3050)).mean() >= 0.95


def test_filtered_correlated_selectivity_planning(data, resid_index):
    """Correlated filter (all allowed rows in 2 IVF lists — the
    multi-tenant shape): selectivity-aware planning drops zero-allowed
    tiles from the p_tiles budget, so a budget FAR too small for blind
    planning still covers every live tile and hits the restricted-oracle
    ceiling."""
    db, q = data
    idx = resid_index
    cap = np.repeat(np.arange(idx.nlist), np.diff(idx._offsets))
    ids_arr = np.asarray(idx._ids[: idx._n], np.int64)
    keep = np.isin(cap, [3, 11]) & (ids_arr >= 0)
    allowed = ids_arr[keep]
    assert 100 < allowed.size < 1500  # genuinely sparse + correlated
    mask = np.zeros(db.shape[0], bool)
    mask[allowed] = True
    gt_f = _oracle_filtered(db, q, 10, mask)
    n_tiles = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    live_tiles = int(np.ceil(allowed.size / idx.tile_n)) + 2  # + boundary
    p_small = min(n_tiles, max(2, live_tiles))
    assert p_small < n_tiles // 2  # the budget IS too small for blind scan
    v, f = idx.search(q, 10, interpret=True, p_tiles=p_small, where=mask)
    assert mask[f[f >= 0]].all()
    assert recall_at_k(f, gt_f) >= 0.9, recall_at_k(f, gt_f)


def test_filtered_search_device_parity(data, resid_index):
    """search_device(where=) matches search(where=) bit-for-bit (same
    kernels, same filter path on device)."""
    import jax.numpy as jnp

    db, q = data
    idx = resid_index
    rng = np.random.default_rng(1)
    mask = rng.random(db.shape[0]) < 0.3
    flt = idx.make_filter(mask)  # staged once, reused across both paths
    p_all = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    v_h, f_h = idx.search(q, 10, interpret=True, p_tiles=p_all, where=flt)
    v_d, f_d = idx.search_device(jnp.asarray(q), 10, interpret=True,
                                 p_tiles=p_all, where=flt)
    np.testing.assert_allclose(np.asarray(v_d), v_h, rtol=1e-5, atol=1e-5)
    assert (np.asarray(f_d).astype(np.int64) == f_h).all()


def test_filtered_after_remove(data):
    """remove() + filter compose: a filter naming removed ids simply never
    matches (freed ids are never reused), and filtering live ids after a
    remove stays exact."""
    db, q = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", residual=True,
                             kmeans_iters=6, tile_n=256, tile_q=16)
    idx.remove(np.arange(0, 1000))
    p_all = int(np.asarray(idx._payload).shape[0]) // idx.tile_n
    v, f = idx.search(q, 10, interpret=True, p_tiles=p_all,
                      where=np.arange(0, 2000))  # first half removed
    got = f[f >= 0]
    assert got.size and (got >= 1000).all() and (got < 2000).all()


def test_filtered_search_fallback_flat(data):
    """Oversample fallback for families without kernel masking: exact on
    the flat index whenever enough allowed rows land in the oversampled
    set (here: full fetch)."""
    from cloudvectordb_tpu.index.flat import FlatIndex

    db, q = data
    idx = FlatIndex.build(db, dtype="float32")
    rng = np.random.default_rng(2)
    mask = rng.random(db.shape[0]) < 0.4
    gt_f = _oracle_filtered(db, q, 10, mask)
    v, f = filtered_search(idx, q, 10, where=mask, oversample=64)
    assert mask[f[f >= 0]].all()
    assert recall_at_k(f, gt_f) >= 0.97


def test_filter_pq_family_refine_scan(data):
    """BandIVFPQIndex: where= rides BOTH serving forms — the
    serve_from='refine' direct scan and the PQ-code kernel path (masked
    candidate generation + refine rescore of an all-allowed shortlist)."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q = data
    idx = BandIVFPQIndex.build(db, nlist=16, m=8, nbits=6, refine="int8",
                               kmeans_iters=5, pq_train_iters=5,
                               tile_n=256, tile_q=16)
    rng = np.random.default_rng(3)
    mask = rng.random(db.shape[0]) < 0.5
    gt_f = _oracle_filtered(db, q, 10, mask)
    n_tiles = idx._n_pad_rows // idx.tile_n
    v, f = idx.search(q, 10, interpret=True, p_tiles=n_tiles,
                      serve_from="refine", where=mask)
    assert mask[f[f >= 0]].all()
    assert recall_at_k(f, gt_f) >= 0.9
    v2, f2 = idx.search(q, 10, interpret=True, p_tiles=n_tiles,
                        serve_from="pq", refine_factor=16, where=mask)
    assert mask[f2[f2 >= 0]].all(), "PQ kernel path leaked a disallowed id"
    assert recall_at_k(f2, gt_f) >= 0.85


def test_filter_pq_family_bucketed_merge(data):
    """Masked PQ search at a k_cand below tile_n (the op point that once
    meant two rows per bucket): the filter must hold and recall must match
    the oracle restricted to allowed rows."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q = data
    idx = BandIVFPQIndex.build(db, nlist=16, m=8, nbits=6, refine="int8",
                               kmeans_iters=5, pq_train_iters=5,
                               tile_n=256, tile_q=16)
    rng = np.random.default_rng(7)
    mask = rng.random(db.shape[0]) < 0.5
    gt_f = _oracle_filtered(db, q, 10, mask)
    n_tiles = idx._n_pad_rows // idx.tile_n
    # k_cand = 10*10 = 100 -> l_buckets = 128 (floor), R = 256/128 = 2
    assert idx._derive_l_buckets(100, 1) == 128
    v, f = idx.search(q, 10, interpret=True, p_tiles=n_tiles,
                      serve_from="pq", refine_factor=10, n_pools=1,
                      where=mask)
    assert mask[f[f >= 0]].all(), "masked PQ scan leaked an id"
    assert recall_at_k(f, gt_f) >= 0.85
    # unmasked same op point still agrees with the unrestricted oracle
    gt_u = _oracle_filtered(db, q, 10, np.ones(db.shape[0], bool))
    _, fu = idx.search(q, 10, interpret=True, p_tiles=n_tiles,
                       serve_from="pq", refine_factor=10, n_pools=1)
    assert recall_at_k(fu, gt_u) >= 0.8


def test_filter_pq_family_opq_and_pq2(data):
    """Filters survive OPQ rotation (the bitmap is id-keyed, not
    vector-space) and the pq2 two-stage rescore; a low-selectivity filter
    pads (-inf, -1) on the PQ path too."""
    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q = data
    idx = BandIVFPQIndex.build(db, nlist=16, m=8, nbits=6, refine="pq2",
                               m2=16, opq=True, kmeans_iters=5,
                               pq_train_iters=5, tile_n=256, tile_q=16)
    rng = np.random.default_rng(4)
    mask = rng.random(db.shape[0]) < 0.4
    gt_f = _oracle_filtered(db, q, 10, mask)
    n_tiles = idx._n_pad_rows // idx.tile_n
    v, f = idx.search(q, 10, interpret=True, p_tiles=n_tiles,
                      refine_factor=16, where=mask)
    assert mask[f[f >= 0]].all()
    assert recall_at_k(f, gt_f) >= 0.7  # pq2 ranking ceiling on this data
    few = np.array([4, 44, 444])
    v3, f3 = idx.search(q, 10, interpret=True, p_tiles=n_tiles, where=few)
    assert set(f3[f3 >= 0].ravel()) <= set(few.tolist())
    assert (f3[:, 3:] == -1).all() and np.isneginf(v3[:, 3:]).all()
