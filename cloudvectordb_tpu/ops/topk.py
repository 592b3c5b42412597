"""Tiled exact/approx top-k over a vector matrix — XLA path.

Streams the DB in tiles through a ``lax.scan`` so the full (Q, N) score matrix
is never materialized; per tile the score block is one matmul and the merge
is ``lax.top_k`` (exact) or ``lax.approx_max_k``.

Scores are uniformly "larger is better": inner product for metric='ip',
-(||q-x||²) for metric='l2'.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

# a PYTHON float, not jnp.float32(-inf): a module-level jax array would
# initialize the XLA backend at import time, which breaks
# jax.distributed.initialize (multi-host must run before ANY backend use);
# every use site is inside a traced function where it weakly types to f32
NEG_INF = float("-inf")


def _score_block(q, tile, metric: str, tile_sqnorm=None):
    """(Q, D) x (T, D) -> (Q, T) scores in true f32.

    Precision.HIGHEST matters: a GPU f32 matmul defaults to TF32 inputs,
    which reorders near-ties — this is the EXACT/ground-truth path. Integer
    (int8) tiles widen to f32 here, one tile at a time."""
    if jnp.issubdtype(tile.dtype, jnp.integer):
        tile = tile.astype(jnp.float32)
    dots = lax.dot_general(
        q, tile, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    if metric == "ip":
        return dots
    if metric == "l2":
        if tile_sqnorm is None:
            tile_sqnorm = jnp.sum(
                tile.astype(jnp.float32) * tile.astype(jnp.float32), axis=1
            )
        # -(||q||² - 2q·x + ||x||²); the ||q||² term is a per-query constant
        # and does not change ordering, but we keep it so returned scores are
        # true negative squared distances.
        q_sqnorm = jnp.sum(q.astype(jnp.float32) * q.astype(jnp.float32), axis=1)
        return 2.0 * dots - tile_sqnorm[None, :] - q_sqnorm[:, None]
    raise ValueError(f"unknown metric {metric!r}")


def merge_topk(values_a, idx_a, values_b, idx_b, k: int):
    """Exact top-k of the union of two candidate sets (per row)."""
    vals = jnp.concatenate([values_a, values_b], axis=1)
    idxs = jnp.concatenate([idx_a, idx_b], axis=1)
    top_v, pos = lax.top_k(vals, k)
    top_i = jnp.take_along_axis(idxs, pos, axis=1)
    return top_v, top_i


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "tile", "approx", "approx_oversample")
)
def tiled_topk(
    db,
    queries,
    k: int,
    metric: str = "ip",
    tile: int = 8192,
    db_sqnorms=None,
    approx: bool = False,
    approx_oversample: int = 2,
):
    """Exact (or tile-approx) top-k of ``queries`` against ``db``.

    Returns (scores (Q, k) f32, indices (Q, k) i32). Rows beyond the true DB
    length (padding) can never win: their scores are forced to -inf.
    """
    n, d = db.shape
    nq = queries.shape[0]
    k = min(k, n)
    n_pad = (-n) % tile
    if n_pad:
        db = jnp.concatenate([db, jnp.zeros((n_pad, d), db.dtype)], axis=0)
        if db_sqnorms is not None:
            db_sqnorms = jnp.concatenate(
                [db_sqnorms, jnp.zeros((n_pad,), db_sqnorms.dtype)]
            )
    num_tiles = db.shape[0] // tile
    db_tiles = db.reshape(num_tiles, tile, d)
    norm_tiles = (
        db_sqnorms.reshape(num_tiles, tile).astype(jnp.float32)
        if db_sqnorms is not None
        else None
    )

    q = queries
    init = (
        jnp.full((nq, k), NEG_INF, jnp.float32),
        jnp.zeros((nq, k), jnp.int32),
    )
    col = lax.broadcasted_iota(jnp.int32, (1, tile), 1)
    kk = min(max(k * approx_oversample, k), tile) if approx else k

    def step(carry, inp):
        if norm_tiles is not None:
            t, tile_x, tile_n = inp
            scores = _score_block(q, tile_x, metric, tile_n)
        else:
            t, tile_x = inp
            scores = _score_block(q, tile_x, metric)
        idx = col + t * tile
        scores = jnp.where(idx < n, scores, NEG_INF)  # mask padding rows
        if approx:
            tv, tp = lax.approx_max_k(scores, kk)
        else:
            tv, tp = lax.top_k(scores, kk)
        ti = (tp + t * tile).astype(jnp.int32)
        best_v, best_i = merge_topk(carry[0], carry[1], tv, ti, k)
        return (best_v, best_i), None

    ts = jnp.arange(num_tiles, dtype=jnp.int32)
    xs = (ts, db_tiles, norm_tiles) if norm_tiles is not None else (ts, db_tiles)
    (best_v, best_i), _ = lax.scan(step, init, xs)
    return best_v, best_i
