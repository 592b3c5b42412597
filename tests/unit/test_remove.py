"""Deletion (remove-by-id) across every index family.

Semantics under test (shared contract):
- remove(ids) returns the number of rows actually removed; unknown ids are
  ignored; freed ids are NEVER reused by later add()s.
- removed ids never appear in search results; survivors keep their original
  ids and their recall.
- the flagship residual-int8 band family removes IN PLACE (O(batch)
  swap-remove against the valid_end mask — no arena rebuild); other
  families compact.
"""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index.flat import FlatIndex
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex, BandIVFPQIndex
from cloudvectordb_tpu.index.ivf_flat import IVFFlatIndex
from cloudvectordb_tpu.index.ivf_pq import IVFPQIndex


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=70, normalize=True)
    q = queries_from(db, 48, seed=71, normalize=True)
    return db, q


def _surviving_gt(db, q, removed, k=10):
    """Exact top-k over the surviving rows, in ORIGINAL id space."""
    keep = np.ones(db.shape[0], bool)
    keep[removed] = False
    kept_ids = np.flatnonzero(keep)
    _, gt_pos = brute_force_topk(db[keep], q, k, metric="ip")
    return kept_ids[gt_pos]


def _assert_no_removed(found, removed):
    assert not np.isin(found, removed).any(), "removed id surfaced in top-k"


# ---------------------------------------------------------------- flat ----


def test_flat_remove_exact(data):
    db, q = data
    idx = FlatIndex.build(db, dtype="float32")
    removed = np.arange(0, 4000, 7)
    assert idx.remove(removed) == removed.size
    assert idx.ntotal == 4000 - removed.size
    gt = _surviving_gt(db, q, removed)
    _, found = idx.search(q, 10)
    _assert_no_removed(found, removed)
    assert recall_at_k(found, gt) == 1.0  # exact index, exact semantics
    # unknown / already-removed ids are ignored
    assert idx.remove(removed[:5]) == 0
    assert idx.remove([10**9]) == 0


def test_flat_remove_then_add_never_reuses_ids(data):
    db, q = data
    idx = FlatIndex.build(db[:100], dtype="float32")
    idx.remove([99, 50])
    idx.add(db[100:110])
    # new rows got ids 100..109 (not 50/99 recycled)
    _, found = idx.search(db[105:106], 1)
    assert found[0, 0] == 105
    r = idx.reconstruct([105])
    np.testing.assert_allclose(r[0], db[105], rtol=1e-5)
    with pytest.raises(AssertionError):
        idx.reconstruct([99])  # removed id is gone


def test_flat_remove_save_load(tmp_path, data):
    db, q = data
    idx = FlatIndex.build(db[:200], dtype="float32")
    idx.remove(np.arange(0, 200, 3))
    idx.save(tmp_path / "flat")
    from cloudvectordb_tpu.index import load_index

    idx2 = load_index(tmp_path / "flat")
    assert idx2.ntotal == idx.ntotal
    _, f1 = idx.search(q, 5)
    _, f2 = idx2.search(q, 5)
    np.testing.assert_array_equal(f1, f2)
    idx2.add(db[200:210])  # allocation resumes past the original ids
    _, found = idx2.search(db[205:206], 1)
    assert found[0, 0] == 205


# ---------------------------------------------------- probe-scan family ----


def test_ivf_flat_remove(data):
    db, q = data
    idx = IVFFlatIndex.build(db, nlist=16, kmeans_iters=4)
    removed = np.arange(0, 4000, 5)
    assert idx.remove(removed) == removed.size
    assert idx.ntotal == 4000 - removed.size
    gt = _surviving_gt(db, q, removed)
    _, found = idx.search(q, 10, nprobe=16)
    _assert_no_removed(found, removed)
    assert recall_at_k(found, gt) >= 0.95


def test_ivf_flat_remove_from_pending(data):
    db, q = data
    idx = IVFFlatIndex(64, nlist=16, kmeans_iters=4)
    idx.train(db[:1000])
    idx.add(db[:2000])
    idx.merge_pending()
    idx.add(db[2000:4000])  # second batch sits in pending (below threshold?)
    # force some rows to stay pending: ids 2000.. are pending or merged —
    # remove across both regions regardless
    removed = np.concatenate([np.arange(100, 200), np.arange(2100, 2200)])
    assert idx.remove(removed) == removed.size
    assert idx.ntotal == 4000 - removed.size
    gt = _surviving_gt(db, q, removed)
    _, found = idx.search(q, 10, nprobe=16)
    _assert_no_removed(found, removed)
    assert recall_at_k(found, gt) >= 0.95


def test_ivf_pq_remove_with_refine(data):
    db, q = data
    idx = IVFPQIndex.build(db, nlist=16, m=8, kmeans_iters=4,
                           pq_train_iters=4, refine="int8")
    removed = np.arange(0, 4000, 9)
    assert idx.remove(removed) == removed.size
    gt = _surviving_gt(db, q, removed)
    _, found = idx.search(q, 10, nprobe=16, refine_factor=16)
    _assert_no_removed(found, removed)
    assert recall_at_k(found, gt) >= 0.9


# --------------------------------------------------------- band family ----


def test_band_resid8_slack_remove_inplace(data):
    """Flagship path: swap-remove leaves the arena IN PLACE (no rebuild —
    offsets and padded extent unchanged), holes are masked exactly."""
    db, q = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", residual=True,
                             slack=0.25, kmeans_iters=6, tile_n=256,
                             tile_q=16)
    offsets_before = idx._offsets
    n_pad_before = int(idx._payload.shape[0])
    removed = np.arange(0, 4000, 6)
    # stage the device state first so the staged-update path is exercised
    idx._device_state()
    assert idx.remove(removed) == removed.size
    assert idx._offsets is offsets_before  # no rebuild
    assert int(idx._payload.shape[0]) == n_pad_before
    assert idx.ntotal == 4000 - removed.size
    gt = _surviving_gt(db, q, removed)
    p_all = int(idx._payload.shape[0]) // idx.tile_n
    _, found = idx.search(q, 10, interpret=True, p_tiles=p_all)
    _assert_no_removed(found, removed)
    assert recall_at_k(found, gt) >= 0.85  # int8-quant floor (family tests)
    # the per-tile valid_end table agrees with the hole-marked id table
    lens_from_ids = np.array([
        (np.asarray(idx._ids[idx._offsets[l]:idx._offsets[l + 1]]) >= 0).sum()
        for l in range(idx.nlist)])
    np.testing.assert_array_equal(lens_from_ids, idx._list_lens)


def test_band_resid8_remove_then_add_refills_slack(data):
    db, q = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", residual=True,
                             slack=0.1, kmeans_iters=6, tile_n=256,
                             tile_q=16)
    removed = np.arange(0, 1000)
    idx.remove(removed)
    pend_before = idx._pending.size
    idx.add(db[removed])  # same geometry: freed slots absorb the re-add
    assert idx.ntotal == 4000
    # the bulk went in place (freed slack), not to the pending buffer
    assert idx._pending.size - pend_before < 200
    # re-added rows are searchable under their NEW (non-recycled) ids
    p_all = int(idx._payload.shape[0]) // idx.tile_n
    _, found = idx.search(db[removed[:16]], 1, interpret=True, p_tiles=p_all)
    assert (found.ravel() >= 4000).all()  # new ids, old ones never reused
    _assert_no_removed(found, removed)


def test_band_resid8_nonslack_remove_inplace(data):
    """Compact residual arenas also remove in place: lens materialize and
    valid_end retreats below the capacity offsets."""
    db, q = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", residual=True,
                             kmeans_iters=6, tile_n=256, tile_q=16)
    assert idx._list_lens is None
    removed = np.arange(1, 4000, 11)
    assert idx.remove(removed) == removed.size
    assert idx._list_lens is not None
    gt = _surviving_gt(db, q, removed)
    p_all = int(idx._payload.shape[0]) // idx.tile_n
    _, found = idx.search(q, 10, interpret=True, p_tiles=p_all)
    _assert_no_removed(found, removed)
    assert recall_at_k(found, gt) >= 0.85
    # merge after in-place removes compacts the holes away
    idx.merge_pending()
    assert idx.ntotal == 4000 - removed.size


def test_band_remove_from_pending_and_annex(data):
    db, q = data
    idx = BandIVFIndex.build(db[:2000], nlist=16, dtype="int8",
                             residual=True, kmeans_iters=6, tile_n=256,
                             tile_q=16)
    idx.add(db[2000:3000])  # → pending (no slack)
    assert idx._pending.size == 1000
    idx._fold_pending()  # device-resident int8 → annex
    assert idx._annex is not None and idx._annex["n"] == 1000
    idx.add(db[3000:4000])  # → pending again
    removed = np.concatenate([
        np.arange(2100, 2200),   # annex region
        np.arange(3100, 3200),   # pending region
        np.arange(100, 200),     # arena region
    ])
    assert idx.remove(removed) == removed.size
    assert idx.ntotal == 4000 - removed.size
    assert idx._annex["n"] == 900
    gt = _surviving_gt(db, q, removed)
    p_all = int(idx._payload.shape[0]) // idx.tile_n
    _, found = idx.search(q, 10, interpret=True, p_tiles=p_all)
    _assert_no_removed(found, removed)
    assert recall_at_k(found, gt) >= 0.85


def test_band_nonresid_remove_compacts(data):
    db, q = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="float32", kmeans_iters=6,
                             tile_n=256, tile_q=16)
    removed = np.arange(0, 4000, 8)
    assert idx.remove(removed) == removed.size
    assert idx.ntotal == 4000 - removed.size
    assert idx._n == 4000 - removed.size  # compacted, no holes
    gt = _surviving_gt(db, q, removed)
    p_all = int(idx._payload.shape[0]) // idx.tile_n
    _, found = idx.search(q, 10, interpret=True, p_tiles=p_all)
    _assert_no_removed(found, removed)
    assert recall_at_k(found, gt) >= 0.9


def test_band_pq_remove_compacts(data):
    db, q = data
    idx = BandIVFPQIndex.build(db, nlist=16, m=8, nbits=4, kmeans_iters=6,
                               pq_train_iters=6, tile_n=256, tile_q=16,
                               train_sample=1500, refine="int8",
                               residual=True)
    removed = np.arange(0, 4000, 6)
    assert idx.remove(removed) == removed.size
    assert idx.ntotal == 4000 - removed.size
    gt = _surviving_gt(db, q, removed)
    p_all = idx._n_pad_rows // idx.tile_n
    # both serving paths honor the deletion
    _, f_pq = idx.search(q, 10, interpret=True, p_tiles=p_all,
                         refine_factor=16)
    _assert_no_removed(f_pq, removed)
    assert recall_at_k(f_pq, gt) >= 0.85
    _, f_ref = idx.search(q, 10, interpret=True, p_tiles=p_all,
                          serve_from="refine")
    _assert_no_removed(f_ref, removed)
    assert recall_at_k(f_ref, gt) >= 0.85


def test_band_pq_remove_pending_rides_codes(data):
    db, q = data
    idx = BandIVFPQIndex.build(db[:3000], nlist=16, m=8, nbits=4,
                               kmeans_iters=6, pq_train_iters=6, tile_n=256,
                               tile_q=16, train_sample=1500, refine="none")
    idx.add(db[3000:4000])  # pending rows + ride-along codes
    assert idx._pending.size == 1000
    removed = np.arange(3200, 3400)
    assert idx.remove(removed) == removed.size
    assert idx._pending.size == 800
    assert sum(c.shape[0] for c in idx._pending_codes) == 800
    idx.merge_pending()  # codes stayed aligned with their rows
    assert idx.ntotal == 3800
    # sharp alignment check: a misaligned merge (codes shifted by the 200
    # removed rows) would decode id i into ≈ row i±200's neighborhood
    for gid in (3000, 3100, 3500, 3900):
        dec = idx.reconstruct([gid])[0]
        dec /= np.linalg.norm(dec)
        assert dec @ db[gid] > dec @ db[gid - 250], gid
    gt = _surviving_gt(db, q, removed)
    p_all = idx._n_pad_rows // idx.tile_n
    _, found = idx.search(q, 10, interpret=True, p_tiles=p_all)
    _assert_no_removed(found, removed)
    assert recall_at_k(found, gt) >= 0.2  # PQ-only floor (cf. test_band_ivf)


def test_band_remove_save_load_roundtrip(tmp_path, data):
    db, q = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", residual=True,
                             slack=0.2, kmeans_iters=6, tile_n=256,
                             tile_q=16)
    removed = np.arange(0, 4000, 10)
    idx.remove(removed)
    idx.save(tmp_path / "band")
    from cloudvectordb_tpu.index import load_index

    idx2 = load_index(tmp_path / "band")
    assert idx2.ntotal == idx.ntotal
    assert idx2._gid_bound() == 4000  # allocator survives the round trip
    p_all = int(idx2._payload.shape[0]) // idx2.tile_n
    _, found = idx2.search(q, 10, interpret=True, p_tiles=p_all)
    _assert_no_removed(found, removed)
    idx2.add(db[:8])
    snap = idx2._pending.snapshot_full()
    ids_new = (snap[1] if snap is not None and snap[1].size
               else np.asarray(idx2._ids)[np.asarray(idx2._ids) >= 0])
    assert ids_new.max() >= 4000  # no id recycling after reload

def test_band_resid8_nonslack_remove_then_add_merge(data):
    """Review regression (r3): after an IN-PLACE remove on a slack=0
    residual arena, a later merge_pending rebuilds a COMPACT arena — the
    lens materialized by the remove are stale and must be dropped, or
    ntotal under-counts and valid_end masks every list's tail (exactly
    the rows the merge just added)."""
    db, q = data
    idx = BandIVFIndex.build(db[:3500], nlist=16, dtype="int8",
                             residual=True, kmeans_iters=6, tile_n=256,
                             tile_q=16)
    removed = np.arange(0, 3500, 13)
    assert idx.remove(removed) == removed.size
    assert idx._list_lens is not None  # in-place remove materialized lens
    idx.add(db[3500:4000])             # slack=0 → pending buffer
    idx.merge_pending()
    # compact again: stale per-list lens are gone, counts are exact
    assert idx._list_lens is None
    assert idx.ntotal == 3500 - removed.size + 500
    assert idx._n == idx.ntotal
    # the merged rows are NOT masked out of search (ids 3500.. live)
    p_all = int(idx._payload.shape[0]) // idx.tile_n
    _, found = idx.search(db[3500:3516], 1, interpret=True, p_tiles=p_all)
    assert (found.ravel() >= 3500).mean() >= 0.9
    _assert_no_removed(found, removed)
    # and persistence carries the compact state
    gt = np.concatenate([np.setdiff1d(np.arange(3500), removed),
                         np.arange(3500, 4000)])
    ids_live = np.asarray(idx._ids)
    np.testing.assert_array_equal(np.sort(ids_live[ids_live >= 0]), gt)


def test_attach_host_refine_after_remove(data):
    """Review regression (r3): the attach guard must check gid COVERAGE
    (_gid_bound), not ntotal — remove() shrinks ntotal but the gid-keyed
    host store stays correct for every surviving row."""
    import jax.numpy as jnp

    from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex

    db, q = data
    chunks = [db[s : s + 1000] for s in range(0, 4000, 1000)]
    idx = BandIVFPQIndex.build_device_streaming(
        lambda i: jnp.asarray(chunks[i]), 4, nlist=16, m=8, nbits=4,
        kmeans_iters=6, pq_train_iters=6, tile_n=256, tile_q=16,
        train_sample=1000, refine="pq2", m2=16)
    removed = np.arange(0, 4000, 17)
    assert idx.remove(removed) == removed.size
    idx.attach_host_refine(lambda i: chunks[i], 4)  # must not refuse
    assert idx.refine == "pq2+host"  # r4: pq2 builds upgrade to the cascade
    gt = _surviving_gt(db, q, removed)
    p_all = idx._n_pad_rows // idx.tile_n
    _, found = idx.search(q, 10, interpret=True, p_tiles=p_all,
                          tile_q=16, refine_factor=16)
    _assert_no_removed(found, removed)
    assert recall_at_k(found, gt) >= 0.85
    # adds AFTER the attach still refuse (gids beyond the store)
    idx.add(db[:16])
    with pytest.raises(AssertionError):
        idx.attach_host_refine(lambda i: chunks[i], 4)
