"""Int8 FlatIndex: exact top-k over the dequantized store, scored one tile
at a time (the store is never widened as a whole)."""

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.index.flat import FlatIndex


@pytest.mark.parametrize("n,tile", [(3000, 512), (700, 256)])
def test_int8_flat_matches_numpy(n, tile):
    db = clustered_vectors(n, 48, seed=120, normalize=True)
    q = queries_from(db, 16, seed=121, normalize=True)
    idx = FlatIndex.build(db, metric="ip", dtype="int8")
    s, i = idx.search(q, 10, tile=tile)
    deq = np.asarray(idx._vecs).astype(np.float64) * idx._scale
    ref = q.astype(np.float64) @ deq.T
    top = np.argsort(-ref, axis=1, kind="stable")[:, :10]
    np.testing.assert_allclose(s, np.take_along_axis(ref, top, 1), atol=1e-5)
    # ids agree except among exact int8 score ties
    for r in range(q.shape[0]):
        cut = ref[r, top[r, -1]]
        sure = set(top[r][ref[r, top[r]] > cut + 1e-6])
        assert sure <= set(i[r])
