"""ADC scan — asymmetric distance computation over PQ codes (SURVEY.md §1.2
L0: ``adc_scan(codes, lut, k)``; §2.2 "THE hot kernel at 100M scale").

The per-element LUT lookup is expressed as a per-subspace one-hot matmul,
scores += OHⱼ · LUTⱼᵀ — cost m·2ᵇ per (code, query); exact ADC scores
(identical to gather-based ADC up to fp rounding). The form was chosen
for hardware without a fast gather; whether a LUT gather wins on the H100
is not measured (ROADMAP A3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, static_argnames=("k", "tile"))
def adc_scan(codes, luts, k: int, tile: int = 16384):
    """Top-k by ADC score. codes (N, m) uint8; luts (B, m, C) f32
    (lut[b, j, c] = contribution of codeword c in subspace j to query b's
    score — build with index.ivf_pq._build_luts). Returns (scores (B, k) f32,
    idx (B, k) i32); larger is better.

    One-hot matmul formulation tiled over N: per tile, per subspace,
    OHⱼ (T, C) = [codes==c] and scores += OHⱼ @ LUTⱼᵀ (C, B).
    """
    n, m = codes.shape
    b, m2, c = luts.shape
    assert m == m2
    k = min(k, n)
    n_pad = (-n) % tile
    if n_pad:
        codes = jnp.concatenate([codes, jnp.zeros((n_pad, m), codes.dtype)])
    tiles = codes.reshape(-1, tile, m)
    luts_t = jnp.transpose(luts, (1, 2, 0)).astype(jnp.bfloat16)  # (m, C, B)
    code_iota = lax.broadcasted_iota(jnp.int32, (tile, c), 1)

    def step(carry, inp):
        best_v, best_i = carry
        t, ctile = inp

        def sub(j, acc):
            oh = (ctile[:, j].astype(jnp.int32)[:, None] == code_iota).astype(
                jnp.bfloat16
            )  # (T, C)
            return acc + lax.dot_general(
                oh, luts_t[j], (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )  # (T, B)

        scores = lax.fori_loop(0, m, sub, jnp.zeros((tile, b), jnp.float32))
        scores = scores.T  # (B, T)
        idx = lax.broadcasted_iota(jnp.int32, (1, tile), 1) + t * tile
        scores = jnp.where(idx < n, scores, -jnp.inf)
        tv, tp = lax.top_k(scores, k)
        ti = (tp + t * tile).astype(jnp.int32)
        cand_v = jnp.concatenate([best_v, tv], axis=1)
        cand_i = jnp.concatenate([best_i, ti], axis=1)
        nv, pos = lax.top_k(cand_v, k)
        ni = jnp.take_along_axis(cand_i, pos, axis=1)
        return (nv, ni), None

    init = (
        jnp.full((b, k), -jnp.inf, jnp.float32),
        jnp.zeros((b, k), jnp.int32),
    )
    ts = jnp.arange(tiles.shape[0], dtype=jnp.int32)
    (best_v, best_i), _ = lax.scan(step, init, (ts, tiles))
    return best_v, best_i
