"""ShardedBandIVFPQIndex — the sharded config-#5 family
on the 8-device simulated mesh: parity vs the single index (shared
quantizers by construction), every refine tier (pq2 in-HBM, host exact,
the pq2+host cascade), save→load→search parity, elastic reshard, adds/
removes/filters, and the segmented-arena staging path."""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index import load_index
from cloudvectordb_tpu.index.ivf_band import BandIVFPQIndex
from cloudvectordb_tpu.parallel.dist_band_pq import ShardedBandIVFPQIndex
from cloudvectordb_tpu.parallel.mesh import make_mesh

KW = dict(nlist=16, m=8, nbits=4, kmeans_iters=6, pq_train_iters=6,
          tile_n=256, tile_q=16, seed=3)


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4096, 64, n_clusters=32, seed=300, normalize=True)
    q = queries_from(db, 32, seed=301, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


def _full_p(idx) -> int:
    return int(idx._device_state()["n_tiles"])


def test_sharded_pq_parity_vs_single(data):
    """Same seed → IDENTICAL quantizers (train_proto is build()'s trainer),
    so the sharded full-coverage search must recall at least what the
    single index does (per-shard candidate pools can only widen)."""
    db, q, gt = data
    single = BandIVFPQIndex.build(db, refine="none", **KW)
    mesh = make_mesh(axis_name="shard")
    sh = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="none", **KW)
    assert sh.ntotal == single.ntotal == db.shape[0]
    np.testing.assert_allclose(np.asarray(single.centroids),
                               np.asarray(sh.proto.centroids), atol=1e-6)
    np.testing.assert_allclose(np.asarray(single.codebooks),
                               np.asarray(sh.proto.codebooks), atol=1e-6)
    _, f1 = single.search(q, 10, p_tiles=single._n_pad_rows // KW["tile_n"])
    _, f8 = sh.search(q, 10, p_tiles=_full_p(sh))
    r1, r8 = recall_at_k(f1, gt), recall_at_k(f8, gt)
    assert r8 >= r1 - 0.02, (r1, r8)


def test_sharded_pq2_and_cascade_tiers(data):
    """Sharded refine tiers: pq2 (arena-ordered tier-2 rescore INSIDE the
    sharded program) beats refine='none'; the host tier (two-dispatch
    exact rescore) ≥ pq2; the pq2+host cascade matches the host tier with
    a narrowed PCIe shortlist."""
    db, q, gt = data
    mesh = make_mesh(axis_name="shard")
    base = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="none", **KW)
    pq2 = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="pq2", m2=16,
                                      **KW)
    host = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="host", **KW)
    casc = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="pq2+host",
                                       m2=16, **KW)
    p = _full_p(pq2)
    skw = dict(p_tiles=p, refine_factor=16)
    _, f0 = base.search(q, 10, p_tiles=p)
    _, f2 = pq2.search(q, 10, **skw)
    _, fh = host.search(q, 10, **skw)
    _, fc = casc.search(q, 10, host_factor=6, **skw)
    r0, r2, rh, rc = (recall_at_k(f, gt) for f in (f0, f2, fh, fc))
    assert r2 >= r0 + 0.02, (r0, r2)   # tier-2 adds real information
    assert rh >= r2 - 0.01, (r2, rh)   # exact host rescore ≥ tier-2 PQ
    assert rc >= r2, (r2, rc)          # cascade: exact tail ≥ tier-2 alone
    assert rc >= rh - 0.02, (rh, rc)   # narrowed shortlist, same recall
    assert rh >= 0.9, rh


def test_sharded_pq2_matches_single_index(data):
    """The sharded pq2 path must recall what the single index's gid-keyed
    pq2 rescore does on the same quantizers (the arena-ordered re-keying
    is pure bookkeeping)."""
    db, q, gt = data
    single = BandIVFPQIndex.build(db, refine="pq2", m2=16, **KW)
    mesh = make_mesh(axis_name="shard")
    sh = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="pq2", m2=16,
                                     **KW)
    skw = dict(refine_factor=16)
    _, f1 = single.search(q, 10,
                          p_tiles=single._n_pad_rows // KW["tile_n"], **skw)
    _, f8 = sh.search(q, 10, p_tiles=_full_p(sh), **skw)
    r1, r8 = recall_at_k(f1, gt), recall_at_k(f8, gt)
    assert r8 >= r1 - 0.02, (r1, r8)


def test_sharded_pq_save_load_reshard(data, tmp_path):
    """save → load (same shard count) is bit-exact; load onto a DIFFERENT
    shard count (elastic reshard: codes verbatim, tier stores re-partition
    by membership) preserves results."""
    db, q, gt = data
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="pq2", m2=16,
                                      **KW)
    p = _full_p(idx)
    skw = dict(p_tiles=p, refine_factor=16)
    v1, i1 = idx.search(q, 10, **skw)
    idx.save(tmp_path / "shpq")

    loaded = load_index(tmp_path / "shpq", mesh=mesh)
    assert isinstance(loaded, ShardedBandIVFPQIndex)
    assert loaded.ntotal == idx.ntotal
    assert loaded.proto.codebooks2 is not None
    v2, i2 = loaded.search(q, 10, **skw)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2, rtol=1e-5)

    # elastic reshard 8 → 4 (and a non-divisor 3)
    for s_new in (4, 3):
        m2 = make_mesh(s_new, axis_name="shard")
        re = ShardedBandIVFPQIndex.load(tmp_path / "shpq", mesh=m2)
        assert re.nshards == s_new and re.ntotal == idx.ntotal
        v3, i3 = re.search(q, 10, p_tiles=_full_p(re), refine_factor=16)
        assert recall_at_k(i3, gt) >= recall_at_k(i1, gt) - 0.02


def test_sharded_pq_cascade_save_load(data, tmp_path):
    """The cascade round-trips: both tier stores (tier-2 codes + host rows)
    and the mode survive save/load."""
    db, q, gt = data
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="pq2+host",
                                      m2=16, **KW)
    skw = dict(p_tiles=_full_p(idx), refine_factor=16, host_factor=6)
    v1, i1 = idx.search(q, 10, **skw)
    idx.save(tmp_path / "shcasc")
    loaded = load_index(tmp_path / "shcasc", mesh=mesh)
    assert loaded.refine == "pq2+host"
    v2, i2 = loaded.search(q, 10, **skw)
    np.testing.assert_array_equal(i1, i2)


def test_sharded_pq_add_remove(data):
    """Wrapper-allocated global ids: adds land on the smallest shard with
    tier payloads in the wrapper stores; removes fan out by gid; freed
    gids are never reused."""
    db, q, gt = data
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIVFPQIndex.build(db[:4000], mesh=mesh, refine="pq2",
                                      m2=16, **KW)
    before = idx.ntotal
    gids = idx.add(db[4000:4096])
    assert idx.ntotal == before + 96
    assert gids.min() >= before
    skw = dict(p_tiles=_full_p(idx), refine_factor=16)
    _, found = idx.search(db[4000:4008], 1, **skw)
    # the added rows retrieve themselves under their wrapper-assigned gids
    self_hit = (found[:, 0] == gids[:8]).mean()
    assert self_hit >= 0.9, found[:, 0]

    n_rem = idx.remove(gids[:50])
    assert n_rem == 50 and idx.ntotal == before + 46
    _, f2 = idx.search(db[4000:4008], 1, **skw)
    assert not np.isin(f2[:, 0], gids[:50]).any()
    # new adds get fresh gids past the removed range
    g3 = idx.add(db[:8])
    assert g3.min() >= gids.max() + 1


def test_sharded_pq_filtered_search(data):
    """where= gid filters: per-shard kernel masks (arena-order allow bits
    staged row-sharded) — no disallowed id may surface, parity with the
    restricted oracle."""
    db, q, gt = data
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="pq2", m2=16,
                                      **KW)
    single = BandIVFPQIndex.build(db, refine="pq2", m2=16, **KW)
    rng = np.random.default_rng(7)
    allow = rng.random(db.shape[0]) < 0.5
    allowed_ids = np.flatnonzero(allow)
    _, gt_f = brute_force_topk(db[allow], q, 10, metric="ip")
    gt_f = allowed_ids[gt_f]
    _, found = idx.search(q, 10, p_tiles=_full_p(idx), refine_factor=16,
                          where=allowed_ids)
    live = found[found >= 0]
    assert np.isin(live, allowed_ids).all()
    # parity with the single index's filtered search (the absolute level is
    # PQ-ranking-limited at these toy codebook sizes — ~0.73 either way)
    _, f1 = single.search(q, 10, p_tiles=single._n_pad_rows // KW["tile_n"],
                          refine_factor=16, where=allowed_ids)
    assert recall_at_k(found, gt_f) >= recall_at_k(f1, gt_f) - 0.03


def test_sharded_pq_l2_metric(data):
    """metric='l2' end-to-end through the sharded program (derived-bias
    kernel keys, s₂ table in the tier-2 rescore, host-side ‖x̂‖²)."""
    db, q, _ = data
    _, gt_l2 = brute_force_topk(db, q, 10, metric="l2")
    mesh = make_mesh(axis_name="shard")
    single = BandIVFPQIndex.build(db, refine="pq2", m2=16, metric="l2",
                                  **KW)
    _, f1 = single.search(q, 10, p_tiles=single._n_pad_rows // KW["tile_n"],
                          refine_factor=16)
    r1 = recall_at_k(f1, gt_l2)  # absolute level is the documented l2
    # serve_from='pq' candidate-key noise at toy codebooks
    for refine, extra in (("pq2", {}), ("pq2+host", {"host_factor": 8})):
        idx = ShardedBandIVFPQIndex.build(
            db, mesh=mesh, refine=refine, m2=16, metric="l2", **KW)
        _, found = idx.search(q, 10, p_tiles=_full_p(idx),
                              refine_factor=16, **extra)
        r = recall_at_k(found, gt_l2)
        assert r >= r1 - 0.02, (refine, r, r1)
        if refine == "pq2+host":  # exact tail beats tier-2 ranking
            assert r >= r1 + 0.02, (r, r1)


def test_sharded_pq_segmented_staging(data, monkeypatch):
    """Arenas past seg_rows_cap stage as common row-major segments across
    shards (each + one masked pad tile); results match the single-segment
    staging on the same build."""
    db, q, gt = data
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="pq2", m2=16,
                                      **KW)
    skw = dict(refine_factor=16)
    v1, i1 = idx.search(q, 10, p_tiles=_full_p(idx), **skw)
    # force segmentation: per-shard n_pad (512) > cap (256 = one tile)
    monkeypatch.setattr(BandIVFPQIndex, "seg_rows_cap", KW["tile_n"])
    idx._dev = None
    assert idx._common_layout()[4] is True  # segmented
    v2, i2 = idx.search(q, 10, p_tiles=_full_p(idx), **skw)
    assert recall_at_k(i2, gt) >= recall_at_k(i1, gt) - 0.02


def test_sharded_pq_2d_mesh(data):
    """('replica', 'shard') mesh: query batch splits across replicas, rows
    across shards — on-chip modes (pq2) only; results match the 1-D mesh."""
    from cloudvectordb_tpu.parallel.mesh import make_2d_mesh

    db, q, gt = data
    one = ShardedBandIVFPQIndex.build(
        db, mesh=make_mesh(4, axis_name="shard"), refine="pq2", m2=16, **KW)
    two = ShardedBandIVFPQIndex.build(
        db, mesh=make_2d_mesh(2, 4), refine="pq2", m2=16, **KW)
    skw = dict(refine_factor=16)
    _, f1 = one.search(q, 10, p_tiles=_full_p(one), **skw)
    _, f2 = two.search(q, 10, p_tiles=_full_p(two), **skw)
    np.testing.assert_array_equal(f1, f2)  # same shards, same quantizers


def test_sharded_pq_tune(data):
    """TunableMixin ladder: tune() picks an op point meeting the target and
    search() serves it by default. The cascade mode can actually reach 0.9
    at these toy codebook sizes (pure pq2 saturates ~0.70 — tier-2 m2=16 on
    64-d is ranking-limited; the exact host tail is not)."""
    db, q, gt = data
    mesh = make_mesh(axis_name="shard")
    idx = ShardedBandIVFPQIndex.build(db, mesh=mesh, refine="pq2+host",
                                      m2=16, **KW)
    report = idx.tune(q, k=10, target_recall=0.9, gt=gt)
    assert report["met"], report
    _, found = idx.search(q, 10)  # tuned op point fills the sentinels
    assert recall_at_k(found, gt) >= 0.88
