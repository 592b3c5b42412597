"""Op-point auto-tuner (eval/tune.py): tune() finds the
cheapest config meeting the recall target, search() serves it by default,
and the op point survives save/load through the manifest."""

import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index import load_index
from cloudvectordb_tpu.index.ivf_band import BandIVFIndex, BandIVFPQIndex
from cloudvectordb_tpu.index.ivf_flat import IVFFlatIndex
from cloudvectordb_tpu.index.ivf_pq import IVFPQIndex


@pytest.fixture(scope="module")
def data():
    db = clustered_vectors(4000, 64, n_clusters=32, seed=300, normalize=True)
    q = queries_from(db, 64, seed=301, normalize=True)
    _, gt = brute_force_topk(db, q, 10, metric="ip")
    return db, q, gt


def test_ivf_flat_tune_and_default_search(data, tmp_path):
    db, q, gt = data
    idx = IVFFlatIndex.build(db, nlist=32, kmeans_iters=6, seed=1)
    report = idx.tune(q, k=10, target_recall=0.95, gt=gt)
    assert report["met"], report
    assert report["op"]["nprobe"] < idx.nlist  # cheaper than exhaustive
    assert idx._op_point == report["op"]
    # the ladder is cost-ordered → first hit is the cheapest passing config
    passing = [t["nprobe"] for t in report["tried"] if t["recall"] >= 0.95]
    assert report["op"]["nprobe"] == min(passing)
    _, found = idx.search(q, 10)  # no knobs: op point serves
    assert recall_at_k(found, gt) >= 0.95

    idx.save(tmp_path / "tuned")
    loaded = load_index(tmp_path / "tuned")
    assert loaded._op_point == report["op"]
    _, found2 = loaded.search(q, 10)
    assert recall_at_k(found2, gt) >= 0.95


def test_ivf_pq_tune_refine(data):
    db, q, gt = data
    idx = IVFPQIndex.build(db, nlist=16, m=8, nbits=6, metric="ip",
                           kmeans_iters=8, pq_train_iters=8, refine="int8",
                           residual=True)
    report = idx.tune(q, k=10, target_recall=0.9, gt=gt)
    assert report["met"], report
    assert {"nprobe", "refine_factor"} <= set(report["op"])
    _, found = idx.search(q, 10)
    assert recall_at_k(found, gt) >= 0.9


def test_band_tune_self_relative(data):
    """gt=None: the reference is the index's own full-coverage scan, so
    recall is relative to the arena ceiling — tune() must still pick a
    partial-coverage op point that reproduces it."""
    db, q, gt = data
    idx = BandIVFIndex.build(db, nlist=16, dtype="int8", kmeans_iters=6,
                             tile_n=128, tile_q=16, residual=True)
    report = idx.tune(q, k=10, target_recall=0.95)
    assert report["met"], report
    n_tiles = idx._tune_n_tiles()
    assert 0 < report["op"]["p_tiles"] <= n_tiles
    _, found = idx.search(q, 10)
    assert recall_at_k(found, gt) >= 0.85  # absolute floor on this data


def test_band_pq_tune_prefers_refine_scan(data, tmp_path):
    db, q, gt = data
    idx = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=6, refine="int8", kmeans_iters=6,
        pq_train_iters=6, tile_n=128, tile_q=16, residual=True,
    )
    report = idx.tune(q, k=10, target_recall=0.95, gt=gt)
    assert report["met"], report
    assert report["op"]["serve_from"] == "refine"
    _, found = idx.search(q, 10)
    assert recall_at_k(found, gt) >= 0.95

    idx.save(tmp_path / "bandpq")
    loaded = load_index(tmp_path / "bandpq")
    assert loaded._op_point == report["op"]
    _, found2 = loaded.search(q, 10)
    assert recall_at_k(found2, gt) >= 0.95


def test_band_pq2_tune_ladder(data):
    """pq2 tier has no refine arena: the ladder walks the PQ path over
    coverage × refine depth; explicit kwargs still override the op point."""
    db, q, gt = data
    idx = BandIVFPQIndex.build(
        db, nlist=16, m=8, nbits=6, refine="pq2", m2=16, kmeans_iters=6,
        pq_train_iters=6, tile_n=128, tile_q=16,
    )
    report = idx.tune(q, k=10, target_recall=0.9)
    assert all("serve_from" not in t for t in report["tried"])
    assert report["met"], report
    # explicit override beats the op point: full coverage ≥ tuned recall
    n_tiles = idx._tune_n_tiles()
    _, f_full = idx.search(q, 10, p_tiles=n_tiles, refine_factor=102)
    _, f_op = idx.search(q, 10)
    assert recall_at_k(f_full, gt) >= recall_at_k(f_op, gt) - 0.02
