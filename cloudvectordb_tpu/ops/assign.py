"""k-means / coarse-quantizer assignment: argmin_c ||x - c||² as tiled matmuls.

Used by the k-means trainer (Lloyd's iterations), IVF list assignment at build
time, and coarse probing at query time (SURVEY.md §2.4 item 3). Distances are
expanded so the N×C interaction is a single matmul per tile; the full
(N, C) matrix is never materialized for large N.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def _assign_block(x, centroids, c_sqnorm):
    """(T, D) x (C, D) -> (assignment (T,), neg_half_dist (T,))."""
    dots = lax.dot_general(
        x, centroids, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    # argmin ||x-c||² == argmax (x·c - ||c||²/2); the ||x||² term is constant.
    score = dots - 0.5 * c_sqnorm[None, :]
    a = jnp.argmax(score, axis=1).astype(jnp.int32)
    best = jnp.max(score, axis=1)
    return a, best


@functools.partial(jax.jit, static_argnames=("tile",))
def assign_clusters(x, centroids, tile: int = 8192):
    """Nearest-centroid id and true squared distance for every row of x.

    Returns (assign (N,) i32, sqdist (N,) f32). Tiled with lax.map so peak
    memory is O(tile × C) regardless of N.
    """
    n, d = x.shape
    c_sqnorm = jnp.sum(
        centroids.astype(jnp.float32) * centroids.astype(jnp.float32), axis=1
    )
    n_pad = (-n) % tile
    xp = jnp.concatenate([x, jnp.zeros((n_pad, d), x.dtype)], axis=0) if n_pad else x
    tiles = xp.reshape(-1, tile, d)

    def one(tile_x):
        return _assign_block(tile_x, centroids, c_sqnorm)

    a, best = lax.map(one, tiles)
    a = a.reshape(-1)[:n]
    best = best.reshape(-1)[:n]
    x_sqnorm = jnp.sum(x.astype(jnp.float32) * x.astype(jnp.float32), axis=1)
    sqdist = x_sqnorm - 2.0 * best  # ||x||² - 2(x·c - ||c||²/2) = ||x-c||²
    return a, jnp.maximum(sqdist, 0.0)
