"""ops/pq_scan.py (the plain tile-pruned PQ scan) against a numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from cloudvectordb_tpu.ops.pq_scan import pq_tiles_topk


def _case(residual, seed=0, m=8, ncode=16, dsub=8, tile_n=64, n_tiles=6,
          w=3, nq=32, tile_q=16, p=3):
    rng = np.random.default_rng(seed)
    n = tile_n * n_tiles
    codes = rng.integers(0, ncode, (n, m)).astype(np.uint8)
    cb = rng.standard_normal((m, ncode, dsub)).astype(np.float32)
    local = rng.integers(0, w, (1, n)).astype(np.uint8)
    ct = (rng.standard_normal((n_tiles, w, m * dsub)).astype(np.float32)
          if residual else None)
    q = rng.standard_normal((nq, m * dsub)).astype(np.float32)
    tt = np.stack([rng.choice(n_tiles, p, replace=False)
                   for _ in range(nq // tile_q)]).astype(np.int32)
    mask = (rng.random((1, n)) < 0.6).astype(np.int8)
    return dict(codes=codes, cb=cb, local=local, ct=ct, q=q, tt=tt,
                mask=mask, tile_n=tile_n, tile_q=tile_q)


def _oracle(c, k, n_valid, l2=False, masked=False):
    """Decode every planned row, score in float64, exact top-k."""
    m = c["cb"].shape[0]
    x_all = np.concatenate([c["cb"][j][c["codes"][:, j]] for j in range(m)],
                           axis=1).astype(np.float64)
    if c["ct"] is not None:
        tiles = np.arange(x_all.shape[0]) // c["tile_n"]
        x_all = x_all + c["ct"][tiles, c["local"][0]]
    out_v, out_i = [], []
    for r, qr in enumerate(c["q"].astype(np.float64)):
        rows = (c["tt"][r // c["tile_q"]][:, None] * c["tile_n"]
                + np.arange(c["tile_n"])[None]).reshape(-1)
        s = x_all[rows] @ qr
        if l2:
            s = s - 0.5 * (x_all[rows] ** 2).sum(1)
        live = rows < n_valid
        if masked:
            live &= c["mask"][0, rows] != 0
        s = np.where(live, s, -np.inf)
        top = np.argsort(-s, kind="stable")[:k]
        out_v.append(s[top])
        out_i.append(rows[top])
    return np.array(out_v), np.array(out_i)


def _check(v, i, ov, oi, tol):
    v, i = np.asarray(v), np.asarray(i)
    np.testing.assert_allclose(v, ov, rtol=tol, atol=tol)
    overlap = np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(i, oi)])
    assert overlap >= 0.97, overlap  # bf16 operands may swap near-ties


@pytest.mark.parametrize("residual,row_major", [(False, False), (True, False),
                                                (True, True)])
def test_pq_scan_matches_numpy_oracle(residual, row_major):
    c = _case(residual, seed=int(residual) + 2 * int(row_major))
    n_valid = c["codes"].shape[0] - 30
    if row_major:
        codes = jnp.asarray(c["codes"])
    else:
        rows = [c["codes"].T] + ([c["local"]] if residual else [])
        codes = jnp.asarray(np.concatenate(rows, axis=0))
    v, i = pq_tiles_topk(
        codes, jnp.asarray(c["cb"]), jnp.asarray(c["q"]), jnp.asarray(c["tt"]),
        10, tile_n=c["tile_n"], tile_q=c["tile_q"],
        centroid_tiles=None if c["ct"] is None else jnp.asarray(c["ct"]),
        n_valid=n_valid, row_major=row_major,
        local_ids=jnp.asarray(c["local"]) if row_major else None)
    ov, oi = _oracle(c, 10, n_valid)
    _check(v, i, ov, oi, tol=0.05)


def test_pq_scan_l2_and_filter():
    c = _case(True, seed=7)
    codes = jnp.asarray(np.concatenate([c["codes"].T, c["local"]], axis=0))
    n_valid = c["codes"].shape[0]
    v, i = pq_tiles_topk(
        codes, jnp.asarray(c["cb"]), jnp.asarray(c["q"]), jnp.asarray(c["tt"]),
        10, tile_n=c["tile_n"], tile_q=c["tile_q"],
        centroid_tiles=jnp.asarray(c["ct"]), n_valid=n_valid,
        row_mask=jnp.asarray(c["mask"]), l2=True)
    ov, oi = _oracle(c, 10, n_valid, l2=True, masked=True)
    _check(v, i, ov, oi, tol=0.25)
    assert (c["mask"][0, np.asarray(i)] != 0).all()


def test_pq_scan_segments_merge():
    """Two row-major segments (each with its zero pad tile) give the same
    result as one arena."""
    c = _case(False, seed=9, n_tiles=6)
    tn = c["tile_n"]
    codes = c["codes"]
    pad = np.zeros((tn, codes.shape[1]), np.uint8)
    segs = (jnp.asarray(np.concatenate([codes[: 3 * tn], pad])),
            jnp.asarray(np.concatenate([codes[3 * tn:], pad])))
    kw = dict(tile_n=tn, tile_q=c["tile_q"], row_major=True)
    args = (jnp.asarray(c["cb"]), jnp.asarray(c["q"]), jnp.asarray(c["tt"]), 10)
    v1, i1 = pq_tiles_topk(jnp.asarray(codes), *args,
                           n_valid=codes.shape[0], **kw)
    v2, i2 = pq_tiles_topk(segs, *args, n_valid=(3 * tn, 3 * tn), **kw)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-5)
    assert (np.sort(np.asarray(i1), 1) == np.sort(np.asarray(i2), 1)).mean() > 0.99
