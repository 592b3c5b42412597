"""range_search (index/range.py): CSR radius queries on every family.

Oracle: numpy brute force over the same stored vectors.
"""

import numpy as np
import pytest

from cloudvectordb_tpu.index.flat import FlatIndex
from cloudvectordb_tpu.index.ivf_flat import IVFFlatIndex
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex


def _oracle_ip(db, q, radius):
    s = q @ db.T
    out = []
    for row in s:
        ids = np.flatnonzero(row >= radius)
        out.append(ids[np.argsort(-row[ids], kind="stable")])
    return out


def _csr_rows(lims, ids):
    return [ids[lims[i]:lims[i + 1]] for i in range(len(lims) - 1)]


def _mkdata(rng, n=800, d=64, nq=16):
    db = rng.standard_normal((n, d)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[rng.choice(n, nq, replace=False)] + 0.05 * rng.standard_normal(
        (nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return db, q


def test_flat_ip_matches_oracle(rng):
    db, q = _mkdata(rng)
    idx = FlatIndex.build(db, metric="ip")
    radius = 0.35
    lims, scores, ids = idx.range_search(q, radius, k_start=8)
    want = _oracle_ip(db, q, radius)
    got = _csr_rows(lims, ids)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g.tolist()) == set(w.tolist())
    # scores sorted descending within each row and all above threshold
    for i in range(len(want)):
        row = scores[lims[i]:lims[i + 1]]
        assert (row >= radius).all()
        assert (np.diff(row) <= 1e-6).all()


def test_flat_l2_squared_distance_convention(rng):
    db, q = _mkdata(rng, n=500)
    idx = FlatIndex.build(db, metric="l2")
    radius = 0.4  # squared L2 distance
    lims, scores, ids = idx.range_search(q, radius, k_start=4)
    d2 = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    for i in range(q.shape[0]):
        want = set(np.flatnonzero(d2[i] <= radius + 1e-5).tolist())
        got = set(ids[lims[i]:lims[i + 1]].tolist())
        assert got == want
        # scores stay in the index convention: -||q-x||^2
        assert (-scores[lims[i]:lims[i + 1]] <= radius + 1e-4).all()


def test_escalation_past_k_start(rng):
    db, q = _mkdata(rng, n=1200, nq=8)
    idx = FlatIndex.build(db, metric="ip")
    radius = -1.0  # everything is a hit: forces escalation to k_max
    with pytest.warns(UserWarning, match="truncated"):
        lims, _, ids = idx.range_search(q, radius, k_start=4, k_max=256)
    counts = np.diff(lims)
    assert (counts == 256).all()  # capped at k_max, per query
    # and with k_max >= ntotal the full set comes back, with no warning
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("error")
        lims, _, ids = idx.range_search(q, radius, k_start=4, k_max=len(db))
    assert (np.diff(lims) == len(db)).all()


def test_ivf_flat_full_probe_matches_oracle(rng):
    db, q = _mkdata(rng, n=600)
    idx = IVFFlatIndex.build(db, nlist=8, kmeans_iters=4, seed=0)
    radius = 0.4
    lims, _, ids = idx.range_search(q, radius, k_start=8, nprobe=8)
    want = _oracle_ip(db, q, radius)
    got = _csr_rows(lims, ids)
    for g, w in zip(got, want):
        assert set(g.tolist()) == set(w.tolist())


def test_band_family_subset_and_self_hit(rng):
    db, q = _mkdata(rng, n=2048, nq=8)
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", residual=True,
                             kmeans_iters=4)
    radius = 0.6
    lims, scores, ids = idx.range_search(q, radius, k_start=8)
    s_full = q @ db.T
    for i in range(q.shape[0]):
        got = ids[lims[i]:lims[i + 1]]
        assert got.size > 0  # near-duplicate query: its source row qualifies
        # int8 scores carry quantization noise; every hit must be a true
        # near neighbor up to that noise
        assert (s_full[i, got] >= radius - 0.05).all()


def test_band_candidate_ceiling_warning(rng):
    """A radius ball denser than the rows the tile plan scans (p_tiles ·
    tile_n) cannot be fully returned; range_search must stop escalating at
    that width and warn, instead of looping on a k the scan clamps."""
    db, q = _mkdata(rng, n=1024, nq=4)
    idx = BandIVFIndex.build(db, nlist=8, dtype="int8", tile_n=64, tile_q=4,
                             kmeans_iters=3)
    with pytest.warns(UserWarning, match="candidate-pool ceiling"):
        lims, _, _ = idx.range_search(q, -1.0, k_start=8,
                                      p_tiles=2)  # every row hits
    assert (np.diff(lims) == 128).all()  # exactly the scanned rows


def test_empty_and_no_hits(rng):
    db, q = _mkdata(rng, n=300)
    idx = FlatIndex.build(db, metric="ip")
    lims, scores, ids = idx.range_search(q, radius=2.0)  # cos <= 1: no hits
    assert lims[-1] == 0 and ids.size == 0 and scores.size == 0
    empty = FlatIndex(db.shape[1])
    lims, scores, ids = empty.range_search(q, radius=0.0)
    assert (lims == 0).all() and ids.size == 0
