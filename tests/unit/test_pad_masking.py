"""Pad rows must never become candidates.

Arena payloads are zero-padded to a tile_n multiple. int8 pads score 0 and
PQ pads decode to the code-0 reconstruction plus the tile's first list
centroid — both plausible scores. The adversarial construction here makes
every REAL score negative, so any unmasked pad row (score ≥ 0) would outrank
all real neighbors and surface (clipped to the last/first real id).
"""

import numpy as np
import pytest

from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex, BandIVFPQIndex


@pytest.fixture(scope="module")
def adversarial():
    """All query·db inner products strictly negative; N % tile_n != 0."""
    rng = np.random.default_rng(7)
    d = 64
    base = rng.normal(size=(1, d))
    base /= np.linalg.norm(base)
    # db points in the -base halfspace, queries in the +base halfspace
    db = -base + 0.15 * rng.normal(size=(777, d))  # 777 % 256 != 0
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = base + 0.15 * rng.normal(size=(20, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    assert (db @ q.T).max() < 0, "construction must make all real scores < 0"
    return db.astype(np.float32), q.astype(np.float32)


def test_int8_tiles_excludes_pad_rows(adversarial):
    db, q = adversarial
    idx = BandIVFIndex.build(db, nlist=8, dtype="int8", kmeans_iters=4,
                             tile_n=256, tile_q=16)
    assert idx._payload.shape[0] > idx.ntotal  # padding actually present
    v, found = idx.search(q, 10, interpret=True,
                          p_tiles=idx._payload.shape[0] // idx.tile_n)
    assert (v < 0).all(), "a non-negative score means a pad row leaked"
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    assert recall_at_k(found, gt) >= 0.85


def test_pq_tiles_excludes_pad_rows_no_refine(adversarial):
    """refine='none' is the documented 1B config — the PQ decode itself must
    mask pads (they decode to centroid-plausible high-IP vectors)."""
    db, q = adversarial
    idx = BandIVFPQIndex.build(db, nlist=8, m=8, nbits=6, refine="none",
                               kmeans_iters=4, pq_train_iters=4,
                               tile_n=256, tile_q=16)
    n_tiles = idx._n_pad_rows // idx.tile_n
    v, found = idx.search(q, 10, p_tiles=n_tiles, interpret=True)
    assert int(found.max()) < idx.ntotal
    # PQ reconstructions of -base-halfspace points stay in that halfspace;
    # pad reconstructions would score near +centroid (positive-ish)
    assert (v < 0).all(), "a non-negative PQ score means a pad row leaked"


def test_pq_tiles_excludes_pad_rows_with_refine(adversarial):
    db, q = adversarial
    idx = BandIVFPQIndex.build(db, nlist=8, m=8, nbits=6, refine="int8",
                               kmeans_iters=4, pq_train_iters=4,
                               tile_n=256, tile_q=16)
    n_tiles = idx._n_pad_rows // idx.tile_n
    v, found = idx.search(q, 10, p_tiles=n_tiles, interpret=True)
    assert (v < 0).all()
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    assert recall_at_k(found, gt) >= 0.85


def test_sharded_band_unequal_shards_exclude_pads(adversarial):
    """Shards pad to the max shard size; short shards' pad rows carried id 0
    before the per-shard n_valid fix."""
    from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex
    from cloudvectordb_tpu.parallel.mesh import make_mesh

    db, q = adversarial  # 777 rows → shards of 98/97 across 8 devices
    mesh = make_mesh(8, axis_name="shard")
    idx = ShardedBandIndex.build(db, nlist=8, mesh=mesh, dtype="int8",
                                 kmeans_iters=4, tile_n=128, tile_q=16)
    v, found = idx.search(q, 10, p_tiles=1)  # each ~97-row shard has 1 tile
    assert (v < 0).all(), "a non-negative score means a pad row leaked"
    assert int(found.max()) < db.shape[0]
