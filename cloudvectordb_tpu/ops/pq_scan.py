"""Tile-pruned PQ scan in plain jnp/lax (the BandIVFPQIndex query path).

Each query group scores the rows of its ``p_tiles`` planned arena tiles:
rows are decoded by a codebook gather (``cb[j][codes[:, j]]``, plus the
row's list centroid in residual mode), scored by one bf16 matmul with f32
accumulation, masked (padding, filter) and reduced by an exact
``lax.top_k``. ``lax.map`` over the groups bounds the temporaries to one
group's decoded tiles. PQ noise (a few per cent of a row's norm) dwarfs
the bf16 rounding of the decoded rows.

Codes arrive code-major ``(m[+1], N_pad)`` (row m: each row's local list
index within its tile) or row-major ``(N_pad, m)`` with the local index in
a separate ``(1, N_pad)`` array; row-major arenas past the segment cap are
a tuple of segments, each with one trailing zero pad tile.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

NEG_INF = float("-inf")


def _decode(codes_g, codebooks):
    """(R, m) uint8 codes → (R, m·dsub) f32 reconstructions."""
    m, ncode, dsub = codebooks.shape
    flat = codebooks.reshape(m * ncode, dsub)
    idx = codes_g.astype(jnp.int32) + (jnp.arange(m, dtype=jnp.int32)
                                       * ncode)[None, :]
    return flat[idx].reshape(codes_g.shape[0], m * dsub)


def _scan_one(codes, codebooks, q, tile_table, k, *, tile_n, tile_q, n_valid,
              row_major, local_ids, centroid_tiles, row_mask, l2,
              n_live_tiles=None):
    m = codebooks.shape[0]
    n_qt = tile_table.shape[0]
    residual = centroid_tiles is not None
    cb = codebooks.astype(jnp.float32)

    def body(args):
        qg, tt_row = args
        rows = (tt_row[:, None] * tile_n
                + jnp.arange(tile_n, dtype=jnp.int32)[None, :]).reshape(-1)
        if row_major:
            codes_g = codes[rows][:, :m]
        else:
            codes_g = codes[:m, rows].T
        x = _decode(codes_g, cb)
        if residual:
            loc = (local_ids[0, rows] if row_major else codes[m, rows])
            x = x + centroid_tiles[rows // tile_n,
                                   loc.astype(jnp.int32)].astype(jnp.float32)
        s = lax.dot_general(
            qg, x.astype(jnp.bfloat16), (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        if l2:  # ranking key q·x̂ − ‖x̂‖²/2
            s = s - 0.5 * jnp.sum(x * x, axis=1)[None, :]
        live = rows < n_valid
        if n_live_tiles is not None:  # segment dispatch: skip the pad tile
            live = jnp.logical_and(live, rows // tile_n < n_live_tiles)
        if row_mask is not None:
            live = jnp.logical_and(live, row_mask[0, rows] != 0)
        s = jnp.where(live[None, :], s, NEG_INF)
        v, pos = lax.top_k(s, min(k, s.shape[1]))
        return v, rows[pos]

    v, i = lax.map(body, (q.reshape(n_qt, tile_q, q.shape[1]), tile_table))
    return v.reshape(n_qt * tile_q, -1), i.reshape(n_qt * tile_q, -1)


@functools.partial(
    jax.jit, static_argnames=("k", "tile_n", "tile_q", "row_major", "l2"))
def pq_tiles_topk(
    codes,
    codebooks,       # (m, 2ᵇ, dsub) f32
    queries_sorted,  # (Q_pad, D) pre-sorted, pre-padded
    tile_table,      # (n_qt, P) i32
    k: int,
    *,
    tile_n: int,
    tile_q: int,
    centroid_tiles=None,  # (n_tiles, W, D) per-tile list centroids (residual)
    n_valid=None,    # true row count (traced); pad rows never become
                     # candidates — they decode to plausible vectors
    row_major: bool = False,
    local_ids=None,  # (1, N_pad) uint8, row-major residual arenas
    row_mask=None,   # (1, N_pad) int8 arena-order allow bits (filtered)
    l2: bool = False,  # rank by q·x̂ − ‖x̂‖²/2; callers convert
):
    """Exact top-k over each query group's decoded tiles.

    Returns (scores (Q, k) f32 on the reconstructions, arena rows (Q, k)
    i32). Segmented arenas pass tuples for ``codes``, ``centroid_tiles``,
    ``local_ids``, ``n_valid`` and ``row_mask``; out-of-segment tile-table
    entries are remapped to the segment's pad tile (masked), each segment
    is scanned, and the candidates merge with global row offsets."""
    q = queries_sorted.astype(jnp.bfloat16)
    if not isinstance(codes, (list, tuple)):
        n = codes.shape[0] if row_major else codes.shape[1]
        nv = jnp.asarray(n if n_valid is None else n_valid, jnp.int32)
        return _scan_one(codes, codebooks, q, tile_table, k, tile_n=tile_n,
                         tile_q=tile_q, n_valid=nv, row_major=row_major,
                         local_ids=local_ids, centroid_tiles=centroid_tiles,
                         row_mask=row_mask, l2=l2)
    assert row_major, "segmentation is a row-major-arena feature"
    outs_v, outs_i = [], []
    t_off = 0
    for si, seg in enumerate(codes):
        seg_tiles = seg.shape[0] // tile_n - 1  # minus the pad tile
        in_seg = (tile_table >= t_off) & (tile_table < t_off + seg_tiles)
        tt_seg = jnp.where(in_seg, tile_table - t_off, seg_tiles)
        v, i = _scan_one(
            seg, codebooks, q, tt_seg.astype(jnp.int32), k, tile_n=tile_n,
            tile_q=tile_q, n_valid=jnp.asarray(n_valid[si], jnp.int32),
            row_major=True,
            local_ids=local_ids[si] if local_ids is not None else None,
            centroid_tiles=(centroid_tiles[si]
                            if centroid_tiles is not None else None),
            row_mask=row_mask[si] if row_mask is not None else None, l2=l2,
            n_live_tiles=seg_tiles)
        outs_v.append(v)
        outs_i.append(i + t_off * tile_n)
        t_off += seg_tiles
    cand_v = jnp.concatenate(outs_v, axis=1)
    cand_i = jnp.concatenate(outs_i, axis=1)
    top_v, pos = lax.top_k(cand_v, min(k, cand_v.shape[1]))
    return top_v, jnp.take_along_axis(cand_i, pos, axis=1)
