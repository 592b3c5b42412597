"""ops.topk (XLA scan) vs the numpy oracle."""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.ops.topk import tiled_topk


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("n,tile", [(1000, 256), (512, 512), (300, 512)])
def test_tiled_topk_exact(metric, n, tile):
    db = clustered_vectors(n, 64, seed=4)
    q = queries_from(db, 16, seed=5)
    s, i = tiled_topk(db, q, 10, metric=metric, tile=tile)
    s_true, i_true = brute_force_topk(db, q, 10, metric=metric)
    assert recall_at_k(np.asarray(i), i_true) == 1.0
    np.testing.assert_allclose(np.asarray(s), s_true, rtol=1e-4, atol=1e-4)


def test_tiled_topk_approx_high_recall():
    db = clustered_vectors(4096, 64, seed=6)
    q = queries_from(db, 32, seed=7)
    s, i = tiled_topk(db, q, 10, metric="ip", tile=1024, approx=True)
    _, i_true = brute_force_topk(db, q, 10, metric="ip")
    assert recall_at_k(np.asarray(i), i_true) >= 0.9
