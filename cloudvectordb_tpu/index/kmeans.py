"""Lloyd's k-means as an XLA-compiled device loop (SURVEY.md §2.2, §7.3 item 5).

Per iteration: tiled nearest-centroid assignment (matmuls via
ops.assign), centroid update by segment-sum (on-device scatter-add), and
empty-cluster repair by re-seeding dead centroids onto perturbed copies of the
centroids owning the most points. The whole optimization is one jitted
``lax.fori_loop`` — zero host round-trips between iterations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from cloudvectordb_tpu.ops.assign import _assign_block


def _assign_scan(x_tiles, centroids):
    """Tiled assignment inside the training loop (no re-jit per iteration)."""
    c_sqnorm = jnp.sum(
        centroids.astype(jnp.float32) * centroids.astype(jnp.float32), axis=1
    )

    def one(tile_x):
        a, _ = _assign_block(tile_x, centroids, c_sqnorm)
        return a

    return lax.map(one, x_tiles).reshape(-1)


@functools.partial(jax.jit, static_argnames=("k", "iters", "tile"))
def train_kmeans(
    x,
    k: int,
    iters: int = 20,
    seed: int = 0,
    tile: int = 4096,
    weights=None,
):
    """k-means on (N, D) → (centroids (k, D) f32, assignments (N,) i32).

    Init: random distinct-ish sample (shuffled rows); when k > N the init
    cycles jittered copies of the rows (tiny corpora with large codebooks —
    e.g. a 200-vector smoke run training 2^8 PQ codewords — must not crash;
    duplicate seeds separate via the empty-cluster repair).
    """
    n, d = x.shape
    key = jax.random.PRNGKey(seed)
    perm = jax.random.permutation(key, n)
    if k <= n:
        init_c = x[perm[:k]].astype(jnp.float32)
    else:
        init_c = x[perm[jnp.arange(k) % n]].astype(jnp.float32)
        init_c = init_c + 1e-4 * jax.random.normal(key, (k, d), jnp.float32)

    n_pad = (-n) % tile
    xp = jnp.concatenate([x, jnp.zeros((n_pad, d), x.dtype)], axis=0) if n_pad else x
    x_tiles = xp.reshape(-1, tile, d)
    xf = x.astype(jnp.float32)
    if weights is None:
        w = jnp.ones((n,), jnp.float32)
    else:
        w = weights.astype(jnp.float32)

    def body(i, carry):
        centroids, _ = carry
        a_full = _assign_scan(x_tiles, centroids)[:n]
        sums = jax.ops.segment_sum(xf * w[:, None], a_full, num_segments=k)
        counts = jax.ops.segment_sum(w, a_full, num_segments=k)
        new_c = sums / jnp.maximum(counts, 1.0)[:, None]
        # empty-cluster repair: re-seed dead centroids as jittered copies of
        # the heaviest centroid (deterministic jitter from the iteration id).
        heavy = jnp.argmax(counts)
        jit_key = jax.random.fold_in(key, i)
        noise = 1e-3 * jax.random.normal(jit_key, (k, d), jnp.float32)
        respawn = new_c[heavy][None, :] + noise
        new_c = jnp.where((counts > 0.0)[:, None], new_c, respawn)
        return (new_c, a_full)

    a0 = jnp.zeros((n,), jnp.int32)
    centroids, _ = lax.fori_loop(0, iters, body, (init_c, a0))
    a_final = _assign_scan(x_tiles, centroids)[:n]
    return centroids, a_final


def kmeans_objective(x, centroids, assignments) -> jnp.ndarray:
    """Mean squared distance to assigned centroid (for tests/metrics)."""
    diffs = x.astype(jnp.float32) - centroids[assignments]
    return jnp.mean(jnp.sum(diffs * diffs, axis=1))
