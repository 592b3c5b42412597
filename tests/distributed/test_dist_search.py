"""Distributed query fan-out/merge on the 8-device simulated mesh (SURVEY §4.2).

The same shard_map code runs on real cards; only the devices differ.
"""

import jax
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.parallel import DistributedFlatIndex, make_mesh


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 simulated devices"
    return make_mesh(axis_name="shard")


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_dist_flat_exact(mesh, metric):
    db = clustered_vectors(4000, 32, seed=40)  # not divisible by 8 → padding path
    q = queries_from(db, 16, seed=41)
    idx = DistributedFlatIndex.build(db, mesh=mesh, metric=metric)
    s, i = idx.search(q, 10)
    _, gt = brute_force_topk(db, q, 10, metric=metric)
    assert recall_at_k(i, gt) == 1.0


def test_dist_flat_incremental_add(mesh):
    db = clustered_vectors(3001, 16, seed=42)  # odd size exercises padding
    q = queries_from(db, 8, seed=43)
    idx = DistributedFlatIndex(mesh=mesh, metric="ip")
    idx.add(db[:1000])
    idx.add(db[1000:])
    assert idx.ntotal == 3001
    _, i = idx.search(q, 5)
    _, gt = brute_force_topk(db, q, 5, metric="ip")
    assert recall_at_k(i, gt) == 1.0


def test_padding_rows_never_returned(mesh):
    db = clustered_vectors(17, 16, seed=44)  # tiny: heavy padding per shard
    q = queries_from(db, 4, seed=45)
    idx = DistributedFlatIndex.build(db, mesh=mesh, metric="ip")
    _, i = idx.search(q, 10)
    assert i.max() < 17
