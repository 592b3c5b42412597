"""Tile-pruned IVF over raw (int8/bf16) vectors — the large-scale serving
index (see ops/pallas_band.py for the scheme).

BASELINE config #4's per-card share, 12.5M×768 int8, is 9.6 GB of device
memory; tile pruning cuts the scan per query group to p_tiles of the
arena's tiles while keeping every shape static. Metric: inner product (the
pipeline produces L2-normalized embeddings) or, on residual-int8 arenas,
L2.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

import functools

from cloudvectordb_tpu.index.base import Index
from cloudvectordb_tpu.index.kmeans import train_kmeans
from cloudvectordb_tpu.ops.assign import assign_clusters
from cloudvectordb_tpu.ops.backend import scan_impl
from cloudvectordb_tpu.ops.pallas_band import (
    order_centroids,
    tiles_topk,
    tiles_topk_resid,
)

#: max list indices one arena tile may span (residual arenas): bounds the
#: per-tile window W that sizes centroid_tiles (n_tiles, W, D) and the
#: uint8 per-row local index (< 256). Enforced by _capacity_layout via
#: tile-boundary hole padding; healthy data never triggers it.
_W_CAP = 128


def _assert_w_fits(tile_window: np.ndarray, family: str) -> None:
    """Loud failure where a residual layout cannot carry its per-row local
    list index in uint8: W > 256 means the data's cluster-size skew packs
    >256 lists into one arena tile (anisotropic/cone data — real encoder
    output measured at mean-cos 0.99 does this at nlist ≥ 4k)."""
    w = int(tile_window.shape[1])
    assert w <= 256, (
        f"per-tile window W={w} overflows the uint8 local index "
        f"({family}): even at the tile_n floor this data packs >256 "
        "lists into one tile — rebuild with a smaller nlist, or use "
        "BandIVFIndex (its tile-span cap pads skew away natively)")


def _plan_tiles(q, centroids, tile_window, tile_q: int, p_tiles: int,
                tile_live=None):
    """Shared device-side planning prologue for every tiles search.

    Sorts queries by their top-1 coarse centroid (L2 ranking — the
    assignment metric), then scores arena tiles per QUERY GROUP: group-max
    over queries FIRST, THEN the tile-window gather (the maxes commute and
    the gather shrinks from (B, n_tiles, W) — 4 GB at B=4096/122k tiles —
    to (n_qt, n_tiles, W)). Returns (q_s, order, dots, tile_table) where
    dots is the raw q·centroids IP matrix in CALLER query order.

    tile_live (n_tiles,) bool (filtered search): tiles holding ZERO
    allowed rows score -inf so the p_tiles budget goes only to tiles the
    filter can hit — the selectivity-aware lever for CORRELATED filters
    (a tenant clustered into few lists), where selectivity-blind planning
    would spend most probes on dead tiles.
    """
    n_qt = q.shape[0] // tile_q
    # HIGHEST: the residual scan takes its ~1.0-scale centroid term from
    # these dots, so a TF32 pass here would land on every score
    dots = jax.lax.dot_general(
        q, centroids, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    c_sq = jnp.sum(centroids.astype(jnp.float32) ** 2, axis=1)
    coarse = dots - 0.5 * c_sq[None, :]
    top1 = jnp.argmax(coarse, axis=1)
    order = jnp.argsort(top1)
    q_s = q[order]
    g_max = coarse[order].reshape(n_qt, tile_q, -1).max(axis=1)
    # gather with n_tiles as the minor dim: (n_qt, W, n_tiles)
    ts = jnp.max(g_max[:, tile_window.T], axis=1)  # (n_qt, n_tiles)
    if tile_live is not None:
        ts = jnp.where(tile_live[None, :], ts, -jnp.inf)
    _, tile_table = jax.lax.top_k(ts, p_tiles)
    return q_s, order, dots, tile_table


def _pq_tiles_core(
    q, centroids, codes_cm, codebooks, refine_rows, tile_window,
    centroid_tiles=None, n_valid=None, local_rm=None, row_mask=None,
    *, k, k_cand, p_tiles, tile_n, tile_q, refine_scale: float,
    row_major: bool = False, refine_residual: bool = False, l2: bool = False,
):
    """Traceable body of the PQ-tiles search (planning + scan + int8
    refine + unsort + l2 key conversion), WITHOUT the arena-row → global-id
    map: returns (v, rows) in CALLER query order, where ``rows`` are arena
    row indices. Shared by the single-index jit wrapper below and the
    per-shard local function of the sharded program
    (parallel/dist_band_pq.py), whose tier-2 tables are staged in ARENA
    order and therefore rescore by row before ids exist."""
    from cloudvectordb_tpu.ops.pq_scan import pq_tiles_topk

    NEG_INF = float("-inf")
    b = q.shape[0]
    # row_mask: kernel-ready arena-order allow bits — the index layer's
    # CACHED form (_arena_row_mask; per-segment tuple on segmented arenas)
    tile_live = None
    if row_mask is not None:  # selectivity-aware planning (_plan_tiles doc)
        flat = (jnp.concatenate([p[0][: -tile_n] for p in row_mask])
                if isinstance(row_mask, (list, tuple)) else row_mask[0])
        tile_live = flat.reshape(-1, tile_n).max(axis=1) > 0
    q_s, order, dots, tile_table = _plan_tiles(
        q, centroids, tile_window, tile_q, p_tiles, tile_live=tile_live)

    v, rows = pq_tiles_topk(
        codes_cm, codebooks, q_s, tile_table, k_cand,
        centroid_tiles=centroid_tiles, tile_n=tile_n, tile_q=tile_q,
        n_valid=n_valid, row_major=row_major, local_ids=local_rm,
        row_mask=row_mask, l2=l2,
    )
    if refine_scale > 0:
        # probed lists can hold < k_cand real rows: unfilled merge slots sit
        # at (NEG_INF, row 0) and must not be exactly rescored into results.
        valid = v > NEG_INF
        rows = jnp.clip(rows, 0, refine_rows.shape[0] - 1)
        lists = jnp.zeros_like(rows)
        if refine_residual:
            # row → local-list byte → global list id (tile_window gather);
            # feeds the exact post-map centroid IP AND (l2) the in-map
            # centroid gather for the refine reconstruction's norm
            assert not isinstance(codes_cm, (list, tuple)), (
                "residual refine is bounded to one arena segment "
                "(guarded at build/merge)"
            )
            loc = (local_rm[0, rows] if row_major
                   else codes_cm[-1, rows]).astype(jnp.int32)
            lists = tile_window[rows // tile_n, loc]

        # rescore in query sub-batches: materializing the full gathered
        # (B, k_cand, D) f32 candidate tensor is 12.9 GB at B=4096,
        # k_cand=1024, D=768 — lax.map keeps the peak at one sub-batch.
        # Residual path: int8→bf16 is EXACT (values in ±127); bf16 operands
        # + f32 accumulation halve the gather temp and run on the tensor cores,
        # and the dominant (centroid) term is added back in exact f32.
        def rescore(args):
            qb, rb, lb = args
            if refine_residual:
                cand = refine_rows[rb].astype(jnp.bfloat16)
                ex = refine_scale * jnp.einsum(
                    "bd,brd->br", qb.astype(jnp.bfloat16), cand,
                    preferred_element_type=jnp.float32)
                if l2:
                    # −‖x̂‖²/2 of the refine reconstruction x̂ = c + s·r:
                    # the c·r cross term needs the candidates' centroid
                    # ROWS — the one l2 cost the derived biases elsewhere
                    # avoid; chunked by the same cap as the row gather
                    ca = centroids[lb]
                    c32 = cand.astype(jnp.float32)
                    ex = ex - 0.5 * (
                        jnp.sum(ca * ca, axis=2)
                        + (2.0 * refine_scale) * jnp.sum(ca * c32, axis=2)
                        + (refine_scale * refine_scale)
                        * jnp.sum(c32 * c32, axis=2))
                return ex
            cand = refine_rows[rb].astype(jnp.float32) * refine_scale
            ex = jnp.einsum("bd,brd->br", qb, cand)
            if l2:
                ex = ex - 0.5 * jnp.sum(cand * cand, axis=2)
            return ex

        # largest divisor of b ≤ cap (a non-divisible fallback to ONE batch
        # would re-create the 12.9 GB gather this chunking exists to avoid);
        # cap scales inversely with k_cand so the gathered (sub, k_cand, D)
        # temp stays ≲1.6 GB next to a resident refined index
        cap = max(1, min(512, (1 << 20) // max(k_cand, 1)))
        if l2 and refine_residual:
            cap = max(1, cap // 2)  # the f32 centroid gather doubles temps
        sub = max(d for d in range(1, min(cap, b) + 1) if b % d == 0)
        nb = b // sub
        ex = jax.lax.map(rescore, (
            q_s.reshape(nb, b // nb, q_s.shape[1]),
            rows.reshape(nb, b // nb, rows.shape[1]),
            lists.reshape(nb, b // nb, rows.shape[1]),
        )).reshape(rows.shape)
        if refine_residual:
            # exact centroid IP term via a dots scalar gather
            ex = ex + jnp.take_along_axis(dots[order], lists, axis=1)
        ex = jnp.where(valid, ex, NEG_INF)
        v, pos = jax.lax.top_k(ex, k)
        rows = jnp.take_along_axis(rows, pos, axis=1)
    else:
        v = v[:, :k]
        rows = rows[:, :k]
    inv = jnp.argsort(order)
    v = v[inv]
    if l2:
        # ranking key q·x̂ − ‖x̂‖²/2 → −‖q − x̂‖² (the l2 score convention);
        # two-stage callers (pq2/host) receive k_cand candidates in this
        # form and must keep their corrections in the same units
        v = 2.0 * v - jnp.sum(q * q, axis=1, keepdims=True)
    return v, rows[inv]


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "k_cand", "p_tiles", "tile_n", "tile_q", "refine_scale",
        "row_major", "refine_residual", "l2",
    ),
)
def _pq_tiles_plan_search(
    q, centroids, codes_cm, codebooks, refine_rows, ids, tile_window,
    centroid_tiles=None, n_valid=None, local_rm=None, row_mask=None,
    *, k, k_cand, p_tiles, tile_n, tile_q, refine_scale: float,
    row_major: bool = False, refine_residual: bool = False, l2: bool = False,
):
    """One-dispatch PQ-tiles search + int8 refine (the 1B-scale query path).

    codes_cm (m, N_pad) arena-ordered; refine_rows (N_pad, D) int8 arena-
    ordered (pass a (1, D) dummy + refine_scale 0 to disable refinement).
    n_valid (traced scalar): TRUE row count — pad rows are masked.

    refine_residual: refine_rows hold int8 RESIDUALS (row − list centroid),
    ~4× finer than whole-row int8 at the same byte cost; the exact centroid
    term is recovered per candidate from the planner's q·centroids matrix
    via the row's local-list byte — a scalar gather, no extra matmul.
    (Measured at 10M×768: whole-row int8 refine ceilings at 0.860 recall —
    the quantization noise of the rescore itself — where the residual-int8
    tiles index reaches 0.97 with the same bytes.)
    """
    v, rows = _pq_tiles_core(
        q, centroids, codes_cm, codebooks, refine_rows, tile_window,
        centroid_tiles, n_valid, local_rm, row_mask,
        k=k, k_cand=k_cand, p_tiles=p_tiles, tile_n=tile_n, tile_q=tile_q,
        refine_scale=refine_scale, row_major=row_major,
        refine_residual=refine_residual, l2=l2,
    )
    gids = ids[jnp.clip(rows, 0, ids.shape[0] - 1)]
    if row_mask is not None:  # unfilled slots keep the (-inf, -1) convention
        gids = jnp.where(v > float("-inf"), gids, -1)
    return v, gids


@functools.partial(
    jax.jit,
    static_argnames=("k", "p_tiles", "tile_n", "tile_q", "int8", "impl"),
)
def _tiles_plan_search(
    q, centroids, payload, ids, tile_window, db_scale, n_valid=None,
    *, k, p_tiles, tile_n, tile_q, int8, impl,
):
    """One-dispatch search: device-side planning + tile-table kernel + unsort.

    q (B, D) f32, B % tile_q == 0. tile_window (n_tiles, W) i32: the list ids
    intersecting each arena tile (rows padded by repeating the last list).
    """
    b = q.shape[0]
    q_s, order, _, tile_table = _plan_tiles(
        q, centroids, tile_window, tile_q, p_tiles)

    if int8 == "hybrid":  # bf16 queries × int8 rows
        q_scale = jnp.ones((b, 1), jnp.float32)
        q_dev = q_s.astype(jnp.bfloat16)
    elif int8:
        q_amax = jnp.maximum(jnp.max(jnp.abs(q_s), axis=1, keepdims=True), 1e-12)
        q_scale = q_amax / 127.0
        q_dev = jnp.clip(jnp.round(q_s / q_scale), -127, 127).astype(jnp.int8)
    else:
        q_scale = jnp.ones((b, 1), jnp.float32)
        q_dev = q_s.astype(payload.dtype)

    v, rows = tiles_topk(
        payload, q_dev, tile_table, k, tile_n=tile_n, tile_q=tile_q,
        int8=int8, impl=impl, n_valid=n_valid,
    )
    v = v * (q_scale * db_scale)
    gids = ids[jnp.clip(rows, 0, ids.shape[0] - 1)]
    inv = jnp.argsort(order)  # unsort to caller's query order
    return v[inv], gids[inv]


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _arena_mask_from_ids(ids, allowed, n_pad=None):
    """(1, n_pad) int8 arena-order allow bits: allow bitmap (by GLOBAL id,
    index/filters.py) gathered through the live id table. A random-access
    (N,) gather over the whole arena — so the index layer
    CACHES the result per (filter, id-table object): every mutation path
    rebinds the device ids array (donated scatters return new objects),
    making object identity a sound invalidation key.

    n_pad: the PADDED arena row count (a tile_n multiple). The id table
    may be shorter than the arena (compact builds don't pad it); the mask
    MUST cover every arena row or the tail tile's kernel block reads out
    of bounds. Pad rows are 0 (disallowed) — they are pad by definition."""
    ok = allowed[jnp.clip(ids, 0, allowed.shape[0] - 1)]
    ok = jnp.where(ids >= 0, ok, 0).astype(jnp.int8)
    if n_pad is not None and n_pad != ok.shape[0]:
        ok = jnp.zeros((n_pad,), jnp.int8).at[: ok.shape[0]].set(ok)
    return ok[None, :]


@functools.partial(
    jax.jit,
    static_argnames=("k", "p_tiles", "tile_n", "tile_q", "impl",
                     "int8_q", "l2"),
)
def _tiles_resid_plan_search(
    q, centroids, payload, local_ids, resid_scale, ids,
    tile_window, valid_end, allowed=None, row_mask=None,
    *, k, p_tiles, tile_n, tile_q, impl, int8_q: bool = True,
    l2: bool = False,
):
    """One-dispatch residual-int8 search: identical planning to
    _tiles_plan_search, residual scan for scoring (int8 residual rows +
    the centroid term gathered from the planner's q·centroid dots — see
    ops/pallas_band.py). valid_end (n_tiles, W) i32 masks tail padding
    and slack holes per tile-list.

    Filtered search: pass row_mask ((1, N_pad) arena-order allow bits —
    the index layer's cached form, _arena_mask_from_ids) or allowed
    (gid-keyed bitmap, gathered per call — the sharded path, where each
    shard owns a different id table). Filtered unfilled slots return
    (-inf, -1)."""
    if row_mask is None and allowed is not None:
        row_mask = _arena_mask_from_ids(ids, allowed,
                                        n_pad=payload.shape[0])
    tile_live = None
    if row_mask is not None:
        # selectivity-aware planning: tiles with zero allowed rows drop
        # out of the p_tiles budget (_plan_tiles doc) — one (N,) reduce,
        # fused into the planning dispatch
        tile_live = row_mask[0].reshape(-1, tile_n).max(axis=1) > 0
    q_s, order, dots, tile_table = _plan_tiles(
        q, centroids, tile_window, tile_q, p_tiles, tile_live=tile_live)

    v, rows = tiles_topk_resid(
        payload, local_ids, tile_window, valid_end, dots[order],
        resid_scale, q_s, tile_table, k, tile_n=tile_n, tile_q=tile_q,
        impl=impl, int8_q=int8_q, row_mask=row_mask, l2=l2,
        centroids=centroids,
    )
    gids = ids[jnp.clip(rows, 0, ids.shape[0] - 1)]
    if row_mask is not None:
        gids = jnp.where(v > -jnp.inf, gids, -1)
    inv = jnp.argsort(order)
    v = v[inv]
    if l2:
        # kernel key q·x̂ − ‖x̂‖²/2 → −‖q − x̂‖² (FlatIndex/IVFFlat's l2
        # convention); −inf unfilled slots stay −inf
        v = 2.0 * v - jnp.sum(q * q, axis=1, keepdims=True)
    return v, gids[inv]


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _rescore_nsub(b: int, kc: int, m2: int, budget: int = 1 << 25) -> int:
    """Query-chunk count bounding _pq2_rescore's (b/nsub, kc, m2) gather
    temps to ~`budget` elements (int32+f32 ≈ 8 B/elt → 256 MB default)."""
    nsub = 1
    while b % (nsub * 2) == 0 and (b // nsub) * kc * m2 > budget:
        nsub *= 2
    return nsub


@functools.partial(jax.jit, static_argnames=("k", "l2"))
def _pq2_rescore(q, v, gids, codes2, codebooks2, s2=None, *, k,
                 l2: bool = False):
    """Tier-2 ADC correction (refine='pq2'): candidates' tier-1 kernel score
    v already contains centroid + tier-1 decode; the tier-2 codebooks encode
    the tier-1 reconstruction ERROR, so the refined score is simply
    v + q·decode2(code2) — one (B, k_cand, m2) uint8 gather + LUT take, no
    dim-byte row traffic. codes2 is keyed by GLOBAL id (merge-invariant).
    The batch is sub-chunked (lax.map) so the (b, k_cand, m2) int32 gather
    + f32 take temps stay ≲0.5 GB — at B=4096/k_cand=2048/m2=32 the fused
    form needs >2 GB of temps next to the resident code tables."""
    NEG = float("-inf")
    b = q.shape[0]
    kc = v.shape[1]
    m2, c2n, dsub2 = codebooks2.shape

    def body(args):
        qb, vb, gb = args
        valid = vb > NEG
        g = jnp.clip(gb, 0, codes2.shape[0] - 1)
        c2 = codes2[g].astype(jnp.int32)  # (bs, kc, m2)
        lut = jnp.einsum(
            "bmd,mcd->bmc", qb.reshape(qb.shape[0], m2, dsub2), codebooks2,
            preferred_element_type=jnp.float32)  # (bs, m2, C)
        corr = jnp.sum(
            jnp.take_along_axis(jnp.transpose(lut, (0, 2, 1)), c2, axis=1),
            axis=2)
        if l2:
            # tier-1 keys arrive as −‖q−x̂₁‖²; −‖q−x̂₂‖² = that + 2q·d₂
            # − (2x̂₁·d₂ + ‖d₂‖²). The bracket is the per-ROW scalar s₂
            # stored gid-keyed beside the tier-2 codes (_encode_tier2) —
            # EXACT, one extra f32 gather per candidate. (A norm-LUT
            # ‖d₂‖²-only form was measured 0.04 recall BELOW tier-1-only
            # at small scale: the dropped cross term dominates when
            # tier-2 errors are large relative to the recon.)
            corr = 2.0 * corr - s2[g]
        ex = jnp.where(valid, vb + corr, NEG)
        v2, pos = jax.lax.top_k(ex, k)
        return v2, jnp.take_along_axis(gb, pos, axis=1)

    nsub = _rescore_nsub(b, kc, m2)
    if nsub == 1:
        return body((q, v, gids))
    v2, g2 = jax.lax.map(body, (q.reshape(nsub, b // nsub, -1),
                                v.reshape(nsub, b // nsub, kc),
                                gids.reshape(nsub, b // nsub, kc)))
    return v2.reshape(b, k), g2.reshape(b, k)


@functools.partial(jax.jit, static_argnames=("k", "resid", "l2"))
def _host_rescore(q, v, gids, r8, assign, centroids, scale, x_sq=None, *, k,
                  resid: bool = True, l2: bool = False):
    """Exact rescore of host-gathered int8 rows (refine='host'): r8
    (B, k_cand, D) int8 shipped from host RAM for just the shortlist.
    resid=True (residual PQ): rows store residuals and the centroid term
    is recovered from q·centroids via each candidate's list; resid=False:
    rows store WHOLE rows and no centroid term may be added (adding it
    inflated non-residual scores by q·c — review finding, r3).
    l2: exact −‖q − x̂‖² keys (x̂ = [c +] scale·r). Residual mode needs
    x_sq (B, k_cand) ‖x̂‖² per candidate — gathered HOST-side from the
    store's lazy per-row norm table (an on-device centroid gather would
    be a (B, k_cand, D) f32 temp: 6.4 GB at the 125M op point);
    non-residual derives it from r8 directly."""
    NEG = float("-inf")
    valid = v > NEG
    ex = scale * jnp.einsum(
        "bd,brd->br", q.astype(jnp.bfloat16), r8.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32)
    if resid:
        dots = jax.lax.dot_general(
            q, centroids, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        ex = ex + jnp.take_along_axis(dots, assign, axis=1)
    if l2:
        if not resid:
            r32 = r8.astype(jnp.float32)
            x_sq = (scale * scale) * jnp.sum(r32 * r32, axis=2)
        ex = 2.0 * ex - x_sq - jnp.sum(q * q, axis=1, keepdims=True)
    ex = jnp.where(valid, ex, NEG)
    v2, pos = jax.lax.top_k(ex, k)
    return v2, jnp.take_along_axis(gids, pos, axis=1)


def _fetch_chunked(payload, chunk_bytes: int = 1 << 30):
    """Device→host fetch of a large arena in bounded slices:
    ``np.asarray(device_arena)`` stages the WHOLE transfer in
    one buffer — at 12.5M×768 that is a second 9.6 GB host allocation next
    to the .npy writer's own copy. Slicing along the LARGEST axis (the
    col-major code matrix is (m+1, N_pad) — axis-0 slicing would see ~65
    rows and degenerate to one full fetch) bounds the extra footprint to
    ~1 GB per slice. Host arrays pass through untouched. Save remains the
    one remaining full PCIe copy of the payload (the compact in-place
    merge no longer round-trips it — _try_merge_inplace_device)."""
    if not isinstance(payload, jax.Array):
        return np.asarray(payload)
    if payload.size * payload.dtype.itemsize <= chunk_bytes:
        return np.asarray(payload)
    ax = int(np.argmax(payload.shape))
    n = int(payload.shape[ax])
    step = max(1, chunk_bytes // max(
        1, payload.size * payload.dtype.itemsize // n))
    out = np.empty(payload.shape, payload.dtype)
    sl = [slice(None)] * payload.ndim
    for lo in range(0, n, step):
        sl[ax] = slice(lo, min(n, lo + step))
        out[tuple(sl)] = np.asarray(payload[tuple(sl)])
    return out


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("c",))
def _move_rows(b, dmap, s, c):
    """One donated in-place block move of the compact fold
    (_try_merge_inplace_device): rows [s, s+c) of ``b`` written to their
    per-row destinations dmap[s:s+c]. The gather materializes before the
    aliased scatter, so self-overlap is safe. Module-level so repeated
    folds reuse the compiled executable (a per-call closure would retrace
    every merge — review finding, r4)."""
    rows = jax.lax.dynamic_slice(b, (s, 0), (c, b.shape[1]))
    d = jax.lax.dynamic_slice(dmap, (s,), (c,))
    return b.at[d].set(rows)


def host_rows_sq(rows, assign, centroids, scale) -> np.ndarray:
    """(N,) f32 ‖x̂‖² per host-store row (x̂ = c[assign] + scale·r) — the
    metric='l2' host-rescore bias, computed HOST-side in 1M-row chunks
    (a device-side per-candidate centroid gather would be a (B, k_cand, D)
    f32 temp — 6.4 GB at the 125M op point). Shared by the single index
    (_host_row_sq) and the sharded wrapper (dist_band_pq)."""
    cents = np.asarray(centroids, np.float32)
    s = np.float32(scale)
    n = rows.shape[0]
    out = np.empty(n, np.float32)
    for lo in range(0, n, 1 << 20):
        hi = min(n, lo + (1 << 20))
        x = cents[assign[lo:hi]] + rows[lo:hi].astype(np.float32) * s
        out[lo:hi] = np.einsum("nd,nd->n", x, x)
    return out


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_set(buf, dest, rows):
    """In-place (donated) device scatter — the O(batch) slack-insert path:
    the arena buffer is aliased, so a 9.6 GB payload at config-#4 scale is
    never copied or shipped to the host on add()."""
    return buf.at[dest].set(rows)


def _pad_moves(*arrs):
    """Pad swap-remove plan arrays (equal-length src/dst pairs, or a freed
    list) to the next power of two by repeating their first element.
    Duplicated scatter slots receive identical values, so the result is
    unchanged — while the jitted scatter executables are reused across
    calls (one compile per pow2 bucket) instead of retracing for every
    distinct delete-batch shape."""
    n = int(arrs[0].shape[0])
    m = _next_pow2(max(n, 1))
    if m == n:
        return arrs
    return tuple(np.concatenate([a, np.repeat(a[:1], m - n)]) for a in arrs)


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_move(buf, src, dst):
    """Donated in-place self-move: rows at ``src`` copied onto ``dst``
    (disjoint sets) — the O(batch) swap-remove path. The gather reads
    before the aliased scatter writes, so donation is safe."""
    return buf.at[dst].set(buf[src])


@functools.partial(jax.jit, donate_argnums=(0,))
def _ids_swap_free(ids, src, dst, freed):
    """Device id-table update mirroring a swap-remove: survivors move
    src→dst, freed tail slots become holes (-1)."""
    if src.shape[0]:
        ids = ids.at[dst].set(ids[src])
    return ids.at[freed].set(-1)


@functools.partial(jax.jit, static_argnames=("k", "l2"))
def _pending_scan(q, rows, scale, n_valid, *, k, l2: bool = False):
    """Exact top-k over the (small) pending buffer: one dense matmul.

    rows (P_pad, D) int8/f32 (padded to bucket compiles), n_valid real rows.
    Scores are dequantized IP — same scale as the arena path, so the two
    top-k sets merge comparably. l2: scores are −‖q − scale·row‖² instead,
    matching the arena paths' converted keys."""
    r32 = rows.astype(jnp.float32)
    s = jax.lax.dot_general(
        q, r32, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ) * scale
    if l2:
        x_sq = (scale * scale) * jnp.sum(r32 * r32, axis=1)
        s = 2.0 * s - x_sq[None, :] - jnp.sum(q * q, axis=1)[:, None]
    mask = jnp.arange(rows.shape[0]) < n_valid
    s = jnp.where(mask[None, :], s, -jnp.inf)
    return jax.lax.top_k(s, k)


@functools.partial(jax.jit, static_argnames=("k", "resid", "l2"))
def _annex_scan(q, rows8, assign, centroids, scale, n_valid, *, k, resid,
                l2: bool = False):
    """Exact top-k over the device ANNEX arena (int8 rows folded from
    pending — see _fold_pending): one bf16 matmul over the annex + the
    exact centroid term for residual rows. Scores are dequantized IP,
    merge-comparable with both the arena kernel and the pending scan.
    l2: −‖q − x̂‖² keys (x̂ = c[assign] + scale·r for residual rows); the
    annex is small, so the per-row centroid gather is cheap."""
    r32 = rows8.astype(jnp.float32)
    ex = jax.lax.dot_general(
        q.astype(jnp.bfloat16), rows8.astype(jnp.bfloat16),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
    ) * scale
    if resid:
        dots = jax.lax.dot_general(
            q, centroids, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        ex = ex + dots[:, assign]
    if l2:
        x_sq = (scale * scale) * jnp.sum(r32 * r32, axis=1)
        if resid:
            ca = centroids[assign]  # (cap, D) — annex caps are small
            x_sq = x_sq + (2.0 * scale) * jnp.sum(ca * r32, axis=1) \
                + jnp.sum(ca * ca, axis=1)
        ex = 2.0 * ex - x_sq[None, :] - jnp.sum(q * q, axis=1)[:, None]
    mask = jnp.arange(rows8.shape[0]) < n_valid
    ex = jnp.where(mask[None, :], ex, -jnp.inf)
    return jax.lax.top_k(ex, k)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _annex_append(rows, assign, new_rows, new_assign, start):
    """Donated in-place append into the annex capacity buffers. new_rows is
    padded to a power-of-2 row count so repeat folds reuse the executable;
    callers guarantee start + new_rows.shape[0] <= capacity (no clamp)."""
    rows = jax.lax.dynamic_update_slice(rows, new_rows, (start, 0))
    assign = jax.lax.dynamic_update_slice(assign, new_assign, (start,))
    return rows, assign


class BandIVFIndex(Index):
    kind = "band_ivf"

    def __init__(
        self,
        dim: int,
        nlist: int,
        dtype: str = "int8",
        kmeans_iters: int = 15,
        seed: int = 0,
        # chosen for the H100 (PERF.md): tile_n is 16 of the scan kernel's
        # 128-row chunks; tile_q=64 is one kernel block per query group.
        # At 12.5M×768, B=4096 (700 W card) tile_q 64 / 128 / 256 needed
        # p_tiles 192 / 384 / 768 for recall@10 ≥ 0.95 and took 20.5 /
        # 33.1 / 57.4 ms per batch
        tile_n: int = 2048,
        tile_q: int = 64,
        residual: bool = False,
        slack: float = 0.0,
        metric: str = "ip",
    ):
        """residual=True (int8 only): the arena stores int8 RESIDUALS
        (row − its list centroid) and the kernel adds the centroid term back
        exactly — same HBM footprint, ~3–4× less quantization noise
        (measured 1M×768 ceiling: recall 0.981 vs 0.956 whole-row int8).

        slack>0 (residual mode only): each list's arena segment is allocated
        with `ceil(count·slack)+8` empty SLACK slots so that `add()` becomes
        an O(batch) in-place device scatter (donated buffer — no host round
        trip, no re-sort) until a list's slack fills; overflow rows spill to
        the pending buffer as before. Holes are masked exactly in-kernel via
        the per-tile-list valid_end table (ops/pallas_band.py)."""
        assert dtype in ("int8", "bfloat16", "float32")
        assert not (residual and dtype != "int8"), "residual is the int8 path"
        assert slack == 0.0 or (residual and dtype == "int8"), (
            "slack slots require the residual-int8 arena (the valid_end "
            "masking lives in the residual kernel)"
        )
        assert metric in ("ip", "l2")
        if metric == "l2" and type(self) is BandIVFIndex:
            # l2 rides the residual kernel's in-kernel derived bias
            # (ops/pallas_band.py); the whole-row band arenas don't carry
            # it — IVFFlat/FlatIndex serve l2 at those shapes
            assert residual and dtype == "int8", (
                "BandIVFIndex metric='l2' requires the residual-int8 arena "
                "(residual=True, dtype='int8'); use IVFFlatIndex for "
                "whole-row l2 serving")
        self.dim = dim
        self.metric = metric
        self.nlist = nlist
        self.dtype = dtype
        self.residual = residual
        self.slack = slack
        # private flag for base-class branches: the PQ subclass REUSES the
        # name `residual` for residual-PQ semantics, but its payload is a
        # code matrix, never residual-int8 rows
        self._resid8 = residual and dtype == "int8"
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.tile_n = tile_n
        self.tile_q = tile_q
        self._local = None  # (1, N_pad) uint8 per-row local list idx (resid)
        self._list_lens = None  # (nlist,) VALID rows per list (resid)
        self._valid_end = None  # (n_tiles, W) i32 per-tile-list valid end
        self.centroids: np.ndarray | None = None  # locality-ordered
        self._payload: np.ndarray | None = None  # padded arena (N_pad, D)
        self._ids: np.ndarray | None = None
        self._offsets: np.ndarray | None = None  # (nlist+1,) row offsets
        self._scale = 1.0
        self._n = 0
        self._dev = None
        # LSM pending buffer (BASELINE config #5 "incremental index updates"):
        # adds append here and are scanned exactly at query time; a merge
        # re-sorts the union into the arena once pending outgrows the
        # threshold, keeping add O(batch) amortized.
        from cloudvectordb_tpu.index.arena import PendingBuffer

        np_dt = {"int8": np.int8, "bfloat16": np.float32, "float32": np.float32}[
            self.dtype
        ]
        self._pending = PendingBuffer(dim, np_dt)
        self._pending_dev = None
        self.merge_threshold = 0.05  # merge when pending > 5% of arena
        # device ANNEX arena: pending folds here when the MAIN arena is
        # device-resident (r3 — _fold_pending; rows/assign jnp, ids host np)
        self._annex: dict | None = None
        self._annex_ver = 0  # bumped on every annex mutation (id-map cache)
        # monotonic global-id allocator: 0 = not yet materialized (every
        # build path assigns ids contiguously from 0, so _gid_bound derives
        # it lazily); remove() leaves gaps — ids are never reused
        self._next_id = 0

    @property
    def _n_valid(self) -> int:
        """Valid arena rows. `_n` is the arena EXTENT (capacity offsets[-1]);
        with slack>0 the extent includes unfilled hole slots."""
        if self._list_lens is not None:
            return int(self._list_lens.sum())
        return self._n

    @property
    def ntotal(self) -> int:
        ax = self._annex["n"] if self._annex is not None else 0
        return self._n_valid + self._pending.size + ax

    def _gid_bound(self) -> int:
        """1 + the largest global id ever allocated. Equals ntotal until the
        first remove(); after removals the id space has gaps, so THIS — not
        ntotal — sizes gid-keyed lookup tables and seeds new-id allocation.
        Lazily derived from the id stores on first use (every build path
        assigns ids contiguously from 0), then maintained incrementally."""
        if self._next_id == 0:
            hi = 0
            if self._ids is not None and len(self._ids):
                hi = int(np.asarray(self._ids).max(initial=-1)) + 1
            snap = self._pending.snapshot_full()
            if snap is not None and snap[1].size:
                hi = max(hi, int(snap[1].max()) + 1)
            if self._annex is not None and self._annex["n"]:
                hi = max(hi, int(self._annex["ids"][: self._annex["n"]]
                                 .max()) + 1)
            self._next_id = hi
        return self._next_id

    def _alloc_ids(self, b: int) -> np.ndarray:
        nid = self._gid_bound()
        self._next_id = nid + b
        return np.arange(nid, nid + b, dtype=np.int64)

    @classmethod
    def build(
        cls, vectors, nlist: int, train_sample: int = 262_144, **kw
    ) -> "BandIVFIndex":
        """vectors may be numpy OR a device array — the build runs on device
        and only small metadata (assignments, offsets) touches the host, so
        GB-scale corpora never cross the (slow) host↔device link."""
        vectors = jnp.asarray(vectors, jnp.float32)
        idx = cls(int(vectors.shape[1]), nlist, **kw)
        ns = min(train_sample, vectors.shape[0])
        sel = np.random.default_rng(idx.seed).choice(vectors.shape[0], ns, replace=False)
        c, _ = train_kmeans(
            vectors[jnp.asarray(np.sort(sel))], nlist, iters=idx.kmeans_iters,
            seed=idx.seed,
        )
        c = np.asarray(c)
        idx.centroids = c[order_centroids(c)]  # relabel along locality order
        idx._populate(vectors)
        return idx

    @classmethod
    def build_streaming(
        cls, chunks, nlist: int, train_sample: int = 262_144, **kw
    ) -> "BandIVFIndex":
        """Streaming encode→insert build (BASELINE config #5 path): consume
        device-resident embedding chunks (e.g. straight from encode_corpus's
        megabatches), quantize+assign each on device, accumulate the compact
        int8 payload on the host, and assemble the arena once with the native
        parallel sort — the full-precision corpus never exists in one piece.
        """
        from cloudvectordb_tpu.utils.native import arena_sort, gather_rows

        idx = None
        payload_chunks: list[np.ndarray] = []
        assign_chunks: list[np.ndarray] = []
        scale = 1e-12
        for chunk in chunks:
            chunk = jnp.asarray(chunk, jnp.float32)
            if idx is None:
                idx = cls(int(chunk.shape[1]), nlist, **kw)
                assert idx.dtype == "int8", "streaming build is the int8 path"
                ns = min(train_sample, chunk.shape[0])
                c, _ = train_kmeans(chunk[:ns], nlist, iters=idx.kmeans_iters,
                                    seed=idx.seed)
                c = np.asarray(c)
                idx.centroids = c[order_centroids(c)]
            a, _ = assign_clusters(chunk, jnp.asarray(idx.centroids))
            if idx._resid8:
                chunk = chunk - jnp.asarray(idx.centroids)[a]
            if scale == 1e-12:  # first chunk sets the (residual-aware) scale
                rms = float(jnp.sqrt(jnp.mean(chunk * chunk)))
                amax = float(jnp.max(jnp.abs(chunk)))
                scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
            q8 = jnp.clip(jnp.round(chunk / scale), -127, 127).astype(jnp.int8)
            payload_chunks.append(np.asarray(q8))   # m-byte-scale host copy
            assign_chunks.append(np.asarray(a))
        assert idx is not None, "empty stream"
        payload = np.concatenate(payload_chunks)
        assigns = np.concatenate(assign_chunks)
        idx._scale = scale
        idx._assemble_compact(
            payload, np.arange(payload.shape[0], dtype=np.int64), assigns
        )
        return idx

    @classmethod
    def build_device_streaming(
        cls, chunk_fn, n_chunks: int, nlist: int,
        train_sample: int = 262_144, merge_headroom: float = 0.0, **kw,
    ) -> "BandIVFIndex":
        """Device-RESIDENT streaming build for corpora larger than host
        transfer budgets allow (config #4's 12.5M×768/card share: 9.6 GB of
        int8; here only the (N,) int32 assignments ever reach the host).

        chunk_fn(i) -> (n_i, D) f32 device array must be DETERMINISTIC —
        chunks are produced twice (pass 1: train+assign; pass 2: quantize+
        scatter into the HBM arena at positions from the host-side native
        counting sort). Re-reading from disk or regenerating from a fixed
        PRNG key both qualify. Peak HBM ≈ int8 arena + one f32 chunk.

        merge_headroom > 0 over-allocates the arena by
        that fraction (tail capacity, masked like tile padding) so later
        ``merge_pending`` calls can compact IN PLACE on device — zero
        payload fetch, bounded chunk temps (``_try_merge_inplace_device``).
        HBM cannot hold TWO 9.6 GB arenas at 12.5M×768, so pre-paid
        headroom is the only way a compact merge stays device-side at that
        scale; adds beyond the headroom fall back to the host merge.
        """
        import jax

        idx = None
        assigns: list[np.ndarray] = []
        sizes: list[int] = []
        scale = 0.0
        for ci in range(n_chunks):
            chunk = chunk_fn(ci)
            if idx is None:
                idx = cls(int(chunk.shape[1]), nlist, **kw)
                assert idx.dtype == "int8", "device-streaming is the int8 path"
                ns = min(train_sample, chunk.shape[0])
                c, _ = train_kmeans(chunk[:ns], nlist,
                                    iters=idx.kmeans_iters, seed=idx.seed)
                c = np.asarray(c)
                idx.centroids = c[order_centroids(c)]
                cdev = jnp.asarray(idx.centroids)
            a, _ = assign_clusters(chunk, cdev)
            if scale == 0.0:  # first chunk sets the (residual-aware) scale
                enc = chunk - cdev[a] if idx._resid8 else chunk
                rms = float(jnp.sqrt(jnp.mean(enc * enc)))
                amax = float(jnp.max(jnp.abs(enc)))
                scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
                idx._scale = scale
            assigns.append(np.asarray(a))
            sizes.append(int(chunk.shape[0]))
        assert idx is not None, "empty stream"
        from cloudvectordb_tpu.utils.native import arena_sort

        assign_all = np.concatenate(assigns)
        n = assign_all.shape[0]
        order, offsets = arena_sort(assign_all.astype(np.int32), nlist)
        dest = np.empty(n, np.int64)
        dest[order] = np.arange(n)  # source row -> arena position (compact)
        counts = np.diff(offsets)
        cap_layout = None
        if idx.slack > 0:
            cap_layout = idx._slack_layout(counts)
        elif idx._resid8:
            off_c, dest_c = idx._capacity_layout(counts, counts)
            if int(off_c[-1]) != n:  # tile-span cap forced hole padding
                cap_layout = (off_c, dest_c)
        if cap_layout is not None:
            offsets, cap_dest = cap_layout
            dest = cap_dest[dest]  # source row -> capacity arena position
            extent = int(offsets[-1])
            cap = int(np.ceil(extent * (1.0 + merge_headroom)))
            n_pad = -(-cap // idx.tile_n) * idx.tile_n
            idx._list_lens = counts.astype(np.int64)
        else:
            extent = n
            cap = int(np.ceil(n * (1.0 + merge_headroom)))
            n_pad = -(-cap // idx.tile_n) * idx.tile_n
        arena = jnp.zeros((n_pad, idx.dim), jnp.int8)
        resid8 = idx._resid8

        # centroids ride as an ARGUMENT: closing over the device array would
        # inline it as an MLIR constant (host round-trip + an extra device
        # copy per compile)
        @functools.partial(jax.jit, donate_argnums=(0,))
        def quant_scatter(ar, rows, d, a, c):
            if resid8:
                rows = rows - c[a]
            q8 = jnp.clip(jnp.round(rows / scale), -127, 127).astype(jnp.int8)
            return ar.at[d].set(q8)

        base = 0
        for ci in range(n_chunks):
            chunk = chunk_fn(ci)
            d = jnp.asarray(dest[base : base + sizes[ci]].astype(np.int32))
            a_dev = jnp.asarray(assigns[ci].astype(np.int32))
            arena = quant_scatter(arena, chunk, d, a_dev, cdev)
            base += sizes[ci]
        idx._payload = arena  # stays in HBM; never visits the host
        if cap_layout is not None:
            ids_full = np.full(n_pad, -1, np.int64)
            ids_full[dest] = np.arange(n, dtype=np.int64)  # global id = src row
            idx._ids = ids_full
        else:
            idx._ids = order.astype(np.int64)
        idx._offsets = offsets
        idx._n = extent
        idx._tile_window = idx._compute_tile_window()
        if idx._resid8:
            idx._build_residual_aux()
        idx._dev = None
        return idx

    def _capacity_layout(self, counts: np.ndarray, caps: np.ndarray):
        """Capacity offsets + per-sorted-row destination for hole-bearing
        (residual) arenas, with the TILE-SPAN CAP applied.

        The cap (r5): no arena tile may span more than ``_W_CAP`` list
        indices — on anisotropic data (real encoder output: mean-cos 0.99,
        intrinsic dim ~5) k-means leaves hundreds of near-empty lists that
        pack consecutively into single tiles, exploding the per-tile window
        W that sizes the residual kernel's centroid_tiles (n_tiles, W, D),
        the (n_tiles, W) valid_end table, and the uint8 per-row local index
        (hard limit 256) — measured: W=1016 at 1M encoder vectors. When the (W_CAP+1)-th list would begin
        inside the current tile, the layout pads to the next tile boundary
        first; the holes are masked exactly like slack slots. Healthy data
        inserts zero padding and the layout equals the plain cumsum.

        Returns (offsets_cap (nlist+1,), dest (n,)) where dest[i] is the
        arena position of the i-th list-sorted row (each list's rows sit at
        the START of its capacity segment)."""
        counts = counts.astype(np.int64)
        caps = caps.astype(np.int64)
        tile_n = self.tile_n
        starts = np.empty(len(caps), np.int64)
        off = 0
        tile_of = -1
        in_tile = 0
        for li, c in enumerate(caps):
            t = off // tile_n
            if t != tile_of:
                tile_of, in_tile = t, 0
            in_tile += 1
            if in_tile > _W_CAP:
                off = (t + 1) * tile_n
                tile_of, in_tile = t + 1, 1
            starts[li] = off
            off += int(c)
        offsets = np.concatenate([starts, [off]]).astype(np.int64)
        start = np.concatenate([[0], np.cumsum(counts)])
        dest = (np.arange(int(counts.sum()), dtype=np.int64)
                - np.repeat(start[:-1], counts)
                + np.repeat(offsets[:-1], counts))
        return offsets, dest

    def _slack_layout(self, counts: np.ndarray):
        """Capacity offsets + per-sorted-row destination for slack arenas:
        each list's rows sit at the START of its capacity segment, followed
        by ceil(count·slack)+8 empty slack slots that later `add()` calls
        fill in place. Tile-span-capped (_capacity_layout doc)."""
        counts = counts.astype(np.int64)
        caps = counts + np.ceil(counts * self.slack).astype(np.int64) + 8
        return self._capacity_layout(counts, caps)

    def _assemble_compact(self, payload: np.ndarray, ids: np.ndarray,
                          assigns: np.ndarray) -> None:
        """Set this index's arena from already-quantized rows (+ their global
        ids and list assignments): one native counting sort + tile padding.
        Shared by streaming builds (single and sharded) and LSM merges.
        slack>0 re-opens fresh slack slots in every list's segment."""
        from cloudvectordb_tpu.utils.native import arena_sort, gather_rows

        order, offsets = arena_sort(np.asarray(assigns, np.int32), self.nlist)
        sorted_payload = gather_rows(np.asarray(payload), order)
        n = sorted_payload.shape[0]
        counts = np.diff(offsets)
        cap_layout = None
        if self.slack > 0:
            cap_layout = self._slack_layout(counts)
        elif self._resid8:
            off_c, dest_c = self._capacity_layout(counts, counts)
            if int(off_c[-1]) != n:  # tile-span cap forced hole padding
                cap_layout = (off_c, dest_c)
        if cap_layout is not None:
            offsets, dest = cap_layout
            extent = int(offsets[-1])
            n_pad = -(-extent // self.tile_n) * self.tile_n
            arena = np.zeros((n_pad, self.dim), sorted_payload.dtype)
            arena[dest] = sorted_payload
            ids_full = np.full(n_pad, -1, np.int64)
            ids_full[dest] = np.asarray(ids, np.int64)[order]
            self._payload = arena
            self._ids = ids_full
            self._list_lens = counts.astype(np.int64)
            self._n = extent
        else:
            n_pad = -(-n // self.tile_n) * self.tile_n
            if n_pad != n:
                sorted_payload = np.concatenate([
                    sorted_payload,
                    np.zeros((n_pad - n, self.dim), sorted_payload.dtype),
                ])
            self._payload = sorted_payload  # host; ships to HBM lazily
            self._ids = np.asarray(ids, np.int64)[order]
            # compact arena: every list is full again, so any per-list lens
            # left behind by an in-place remove() are stale — drop them or
            # ntotal under-counts and _build_residual_aux masks the tail of
            # every list (exactly the rows this merge just added).
            self._list_lens = None
            self._n = n
        self._offsets = offsets
        self._tile_window = self._compute_tile_window()
        if self._resid8:
            self._build_residual_aux()
        self._dev = None

    def _export_rows(self):
        """(payload, gids, assigns) host arrays — the merge_from interchange
        format: every VALID arena row's quantized payload, global id and
        list assignment (derived from the arena offsets; slack holes and
        tile padding drop out). Pending/annex rows fold first. Device-
        resident arenas fetch once (a PCIe copy on real hardware)."""
        self.merge_pending()
        ids = np.asarray(self._ids, np.int64)
        valid = np.flatnonzero(ids >= 0)
        payload = np.asarray(self._payload)[: ids.shape[0]][valid]
        offsets = np.asarray(self._offsets, np.int64)
        assigns = (np.searchsorted(offsets, valid, side="right") - 1).astype(
            np.int32)
        return payload, ids[valid], assigns

    def merge_from(self, other: "BandIVFIndex",
                   id_offset: int | None = None) -> int:
        """Consolidate another SAME-QUANTIZER index into this one (the
        FAISS ``merge_from`` surface): independent per-worker builds merge
        without re-encoding — one native re-sort of the union. ``other``
        is left untouched. Requires identical centroids (residual payloads
        are relative to them) and identical family parameters; int8
        payloads requantize from ``other``'s scale to this index's.
        Global ids must not collide — pass ``id_offset`` to shift
        ``other``'s ids (e.g. its gid bound) when both built from 0.
        Returns the number of rows merged in."""
        assert self.kind == other.kind and self.dim == other.dim
        assert self.metric == other.metric and self.dtype == other.dtype
        assert self._resid8 == other._resid8 and self.nlist == other.nlist
        np.testing.assert_allclose(
            self.centroids, other.centroids, atol=1e-6,
            err_msg="merge_from needs the SHARED coarse quantizer (train "
                    "once, reuse for every worker's build)")
        p_s, id_s, a_s = self._export_rows()
        p_o, id_o, a_o = other._export_rows()
        if self.dtype == "int8" and other._scale != self._scale:
            p_o = np.clip(
                np.round(p_o.astype(np.float32)
                         * (other._scale / self._scale)),
                -127, 127).astype(np.int8)
        if id_offset is not None:
            id_o = id_o + int(id_offset)
        both = np.concatenate([id_s, id_o])
        uniq = np.unique(both)
        assert uniq.size == both.size, (
            f"{both.size - uniq.size} colliding global ids — pass "
            "id_offset=self._gid_bound() (or any disjoint shift)")
        self._assemble_compact(
            np.concatenate([p_s, p_o]),
            both,
            np.concatenate([a_s, a_o]),
        )
        self._next_id = int(uniq[-1]) + 1 if uniq.size else 0
        return int(id_o.shape[0])

    def _populate(self, vectors) -> None:
        vectors = jnp.asarray(vectors, jnp.float32)
        a, _ = assign_clusters(vectors, jnp.asarray(self.centroids))
        a_np = np.asarray(a)
        order = np.argsort(a_np, kind="stable")
        order_d = jnp.asarray(order)
        x = vectors[order_d]  # device gather into list order
        if self._resid8:
            x = x - jnp.asarray(self.centroids)[jnp.asarray(a_np[order])]
        if self.dtype == "int8":
            rms = jnp.sqrt(jnp.mean(x * x))
            amax = jnp.max(jnp.abs(x))
            scale = float(jnp.maximum(jnp.minimum(amax, 4.0 * rms) / 127.0, 1e-12))
            payload = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
        else:
            scale = 1.0
            payload = x.astype(
                jnp.bfloat16 if self.dtype == "bfloat16" else jnp.float32
            )
        n = int(payload.shape[0])
        counts = np.bincount(a_np, minlength=self.nlist)
        cap_layout = None
        if self.slack > 0:
            cap_layout = self._slack_layout(counts)
        elif self._resid8:
            # tile-span cap (_capacity_layout doc): skewed list sizes may
            # force hole padding; identity layout costs nothing otherwise
            off_c, dest_c = self._capacity_layout(counts, counts)
            if int(off_c[-1]) != n:
                cap_layout = (off_c, dest_c)
        if cap_layout is not None:
            offsets, dest = cap_layout
            extent = int(offsets[-1])
            n_pad = -(-extent // self.tile_n) * self.tile_n
            arena = jnp.zeros((n_pad, self.dim), payload.dtype)
            payload = arena.at[jnp.asarray(dest.astype(np.int32))].set(payload)
            ids = np.full(n_pad, -1, np.int64)
            ids[dest] = order
            self._ids = ids
            self._list_lens = counts.astype(np.int64)
            self._n = extent
        else:
            n_pad = -(-n // self.tile_n) * self.tile_n
            if n_pad != n:
                payload = jnp.concatenate(
                    [payload, jnp.zeros((n_pad - n, self.dim), payload.dtype)]
                )
            offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            self._ids = order.astype(np.int32)
            self._n = n
        self._payload = payload  # device-resident
        self._offsets = offsets
        self._scale = scale
        self._tile_window = self._compute_tile_window()
        if self._resid8:
            self._build_residual_aux()
        self._dev = None

    def _build_residual_aux(self) -> None:
        """Residual mode: per-row LOCAL list index within its tile window
        (the scan maps it to the row's list id through tile_window) and the
        per-tile-list valid_end table — both derivable from the capacity
        offsets + list lengths, recomputed after every arena re-sort or
        in-place insert."""
        n = self._n  # arena extent, INCLUDING slack holes
        n_pad = int(self._payload.shape[0])
        tw = self._tile_window  # (n_tiles, W)
        # every capacity slot (filled or hole) belongs to its list
        assigns = np.repeat(np.arange(self.nlist), np.diff(self._offsets))
        row_tile = np.arange(n) // self.tile_n
        local = assigns - tw[row_tile, 0]
        w = tw.shape[1]
        assert local.min(initial=0) >= 0 and local.max(initial=0) < w
        assert w <= 256, (
            f"per-tile window W={w} overflows the uint8 local index — a "
            "layout path skipped the tile-span cap (_capacity_layout)")
        loc = np.zeros((1, n_pad), np.uint8)
        loc[0, :n] = local.astype(np.uint8)
        self._local = loc
        lens = (self._list_lens if self._list_lens is not None
                else np.diff(self._offsets))
        self._valid_end = (self._offsets[:-1][tw] + lens[tw]).astype(np.int32)

    def _compute_tile_window(self) -> np.ndarray:
        """(n_tiles, W) list ids intersecting each arena tile (rows padded by
        repeating the last id) — drives device-side tile scoring."""
        n_rows = int(self._payload.shape[0])
        n_tiles = n_rows // self.tile_n
        starts = np.arange(n_tiles, dtype=np.int64) * self.tile_n
        ends = np.minimum(starts + self.tile_n - 1, max(self._n - 1, 0))
        fl = np.clip(np.searchsorted(self._offsets, starts, side="right") - 1,
                     0, self.nlist - 1)
        ll = np.clip(np.searchsorted(self._offsets, ends, side="right") - 1,
                     0, self.nlist - 1)
        w = int((ll - fl).max()) + 1 if n_tiles else 1
        window = fl[:, None] + np.arange(w)[None, :]
        window = np.minimum(window, ll[:, None])
        return np.clip(window, 0, self.nlist - 1).astype(np.int32)

    def add(self, vectors, ids: np.ndarray | None = None) -> None:
        """LSM-style incremental insert: assign + quantize the batch on
        device under the EXISTING arena scale, append to the pending buffer
        (scanned exactly at query time), and merge into the arena — one
        native re-sort — once pending outgrows ``merge_threshold``·arena.
        O(batch) amortized; new rows are searchable immediately.

        ids: explicit global ids for the batch (sharded wrappers allocate
        across shards); default allocates from this index's monotonic
        bound. Must be ≥ the current bound — ids are never reused."""
        vectors = jnp.asarray(vectors, jnp.float32)
        if self._n == 0 and self._pending.size == 0:
            assert self.centroids is not None, "build() trains the quantizer"
            assert ids is None, "explicit ids need a populated arena"
            self._populate(vectors)
            return
        a, _ = assign_clusters(vectors, jnp.asarray(self.centroids))
        b = int(vectors.shape[0])
        if ids is None:
            ids = self._alloc_ids(b)
        else:
            ids = np.asarray(ids, np.int64)
            # initial= raises the floor for empty batches only (np.min's
            # initial VALUE participates in the reduction, so it must not
            # sit below the bound being checked)
            lo = np.iinfo(np.int64).max
            assert ids.shape == (b,) and ids.min(initial=lo) >= self._gid_bound(), (
                "explicit ids must not collide with ever-allocated ids")
            self._next_id = max(self._gid_bound(),
                                int(ids.max(initial=-1)) + 1)
        if self.slack > 0 and self._list_lens is not None:
            # in-place insert into each list's slack slots: an O(batch)
            # donated device scatter; rows whose list is full spill to the
            # pending buffer (exact scan) until the next merge re-slacks.
            a_np = np.asarray(a)
            caps = np.diff(self._offsets)
            order = np.argsort(a_np, kind="stable")
            a_s = a_np[order]
            starts = np.searchsorted(a_s, np.arange(self.nlist))
            rank = np.arange(b) - starts[a_s]  # rank within its list
            avail = caps[a_s] - self._list_lens[a_s]
            take = rank < avail
            dest = self._offsets[:-1][a_s] + self._list_lens[a_s] + rank
            t_idx, s_idx = order[take], order[~take]
            if t_idx.size:
                rows = self._quantize_rows(
                    vectors[jnp.asarray(t_idx)], jnp.asarray(a_np[t_idx]))
                dest_t = dest[take]
                dest_dev = jnp.asarray(dest_t.astype(np.int32))
                # host bookkeeping FIRST: if anything below raises, the id
                # tables never point at a half-applied payload scatter
                self._ids = np.asarray(self._ids, np.int64)
                if not self._ids.flags.writeable:  # e.g. mmap'd load
                    self._ids = self._ids.copy()
                if not self._list_lens.flags.writeable:
                    self._list_lens = self._list_lens.copy()
                self._ids[dest_t] = ids[t_idx]
                np.add.at(self._list_lens, a_np[t_idx], 1)
                tw = self._tile_window
                self._valid_end = (self._offsets[:-1][tw]
                                   + self._list_lens[tw]).astype(np.int32)
                self._payload = _scatter_set(
                    jnp.asarray(self._payload), dest_dev, rows)
                if self._dev is not None:  # keep the staged state coherent
                    self._dev["payload"] = self._payload
                    self._dev["ids"] = _scatter_set(
                        self._dev["ids"], dest_dev,
                        jnp.asarray(ids[t_idx].astype(np.int32)))
                    self._dev["valid_end"] = jnp.asarray(self._valid_end)
            if s_idx.size:
                rows_sp = self._quantize_rows(
                    vectors[jnp.asarray(s_idx)], jnp.asarray(a_np[s_idx]))
                self._pending.append(np.asarray(rows_sp), ids[s_idx],
                                     a_np[s_idx])
                self._pending_dev = None
                if self._pending.size > max(
                        self.merge_threshold * self._n_valid,
                        4 * self.tile_n):
                    self._fold_pending()
            return
        payload = self._quantize_rows(vectors, a)
        self._pending.append(np.asarray(payload), ids, np.asarray(a))
        self._pending_dev = None
        if self._pending.size > max(self.merge_threshold * self._n,
                                    4 * self.tile_n):
            self._fold_pending()

    def remove(self, ids) -> int:
        """Delete rows by global id. Returns the number actually removed
        (unknown ids are ignored); freed ids are never reused.

        The device path (residual-int8 arenas, the flagship family) is
        O(batch): within each hit list the surviving TAIL rows swap into
        the removed slots (one donated device gather+scatter — the arena
        payload never crosses the host link) and the list's valid_end
        retreats, so the kernel's per-tile-list mask stays EXACT. Freed
        slots become slack capacity that add() refills in place. Pending
        rows filter host-side; annex rows swap-remove within the annex.
        Non-residual arenas (no in-kernel valid_end masking) compact via
        one host-side re-sort instead."""
        from cloudvectordb_tpu.index.arena import normalize_remove_ids

        req = normalize_remove_ids(ids)
        if req.size == 0:
            return 0
        self._gid_bound()  # materialize BEFORE ids vanish: never reuse ids
        removed = self._remove_pending(req)
        removed += self._remove_annex(req)
        if self._n:
            ids_arr = np.asarray(self._ids[: self._n], np.int64)
            slots = np.flatnonzero(np.isin(ids_arr, req))
            if slots.size:
                if self._resid8:
                    self._remove_arena_inplace(slots)
                else:
                    self._remove_arena_compact(slots)
                removed += int(slots.size)
        return removed

    def _remove_pending(self, req: np.ndarray) -> int:
        n_rem, _ = self._pending.remove_ids(req)
        if n_rem:
            self._pending_dev = None
        return n_rem

    def _remove_annex(self, req: np.ndarray) -> int:
        ax = self._annex
        if ax is None or ax["n"] == 0:
            return 0
        n = ax["n"]
        hit = np.flatnonzero(np.isin(ax["ids"][:n], req))
        if hit.size == 0:
            return 0
        new_n = n - int(hit.size)
        head = hit[hit < new_n]  # holes that need filling
        tail = np.arange(new_n, n)
        tail_surv = tail[~np.isin(tail, hit)]  # survivors that fill them
        if head.size:
            src_p, dst_p = _pad_moves(tail_surv, head)
            src = jnp.asarray(src_p.astype(np.int32))
            dst = jnp.asarray(dst_p.astype(np.int32))
            ax["rows"] = _scatter_move(ax["rows"], src, dst)
            ax["assign"] = _scatter_move(ax["assign"], src, dst)
            ax["ids"][head] = ax["ids"][tail_surv]
        ax["ids"][new_n:n] = -1
        ax["n"] = new_n
        self._annex_ver += 1
        return int(hit.size)

    def _swap_remove_slots(self, slots: np.ndarray):
        """Per-list swap-remove plan: for each hit list, survivors from the
        tail region move into removed head slots so every list stays
        front-packed (the valid_end invariant). Decrements _list_lens.
        Returns (src, dst, freed) arena slot arrays — src→dst moves are
        disjoint; freed slots (the new tail holes) get id -1.

        Fully vectorized (no per-list Python loop — a B=8k delete over
        nlist=4k would pay ~0.1 s of loop overhead otherwise): within each
        list, #removed-in-head == #survivors-in-tail, and both plan arrays
        come out grouped by list, so pairing them positionally is a valid
        assignment."""
        offs = self._offsets
        lens = self._list_lens
        slots = np.sort(np.asarray(slots, np.int64))
        lists = np.searchsorted(offs, slots, side="right") - 1
        ul, cnt = np.unique(lists, return_counts=True)
        new_lens = lens[ul] - cnt
        cut = offs[ul] + new_lens  # first freed slot per hit list
        # freed = each hit list's last `cnt` valid slots, concatenated
        # (arange-by-segment trick)
        total = int(cnt.sum())
        seg_start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        freed = (np.arange(total, dtype=np.int64)
                 - np.repeat(seg_start, cnt) + np.repeat(cut, cnt))
        # survivors inside the freed region move; removed slots there don't
        tail_surv = freed[~np.isin(freed, slots)]
        cut_per_slot = cut[np.searchsorted(ul, lists)]
        head_holes = slots[slots < cut_per_slot]
        assert head_holes.size == tail_surv.size
        lens[ul] = new_lens
        return tail_surv, head_holes, freed

    def _remove_arena_inplace(self, slots: np.ndarray) -> None:
        """Residual-int8 arenas: O(batch) in-place swap-remove (see
        remove()). Mirrors add()'s ordering — host bookkeeping commits
        before the device scatter so a failure can't leave the id tables
        pointing at half-moved payload."""
        if self._list_lens is None:  # compact arena: materialize lens
            self._list_lens = np.diff(self._offsets).astype(np.int64)
        elif not self._list_lens.flags.writeable:
            self._list_lens = self._list_lens.copy()
        self._ids = np.asarray(self._ids, np.int64)
        if not self._ids.flags.writeable:  # e.g. mmap'd load
            self._ids = self._ids.copy()
        src, dst, freed = self._swap_remove_slots(slots)
        self._ids[dst] = self._ids[src]
        self._ids[freed] = -1
        tw = self._tile_window
        self._valid_end = (self._offsets[:-1][tw]
                           + self._list_lens[tw]).astype(np.int32)
        if src.size:
            src, dst = _pad_moves(src, dst)
        (freed,) = _pad_moves(freed)
        sd = jnp.asarray(src.astype(np.int32))
        dd = jnp.asarray(dst.astype(np.int32))
        fd = jnp.asarray(freed.astype(np.int32))
        if src.size:
            self._payload = _scatter_move(jnp.asarray(self._payload), sd, dd)
        if self._dev is not None:  # keep the staged state coherent
            self._dev["payload"] = jnp.asarray(self._payload)
            self._dev["ids"] = _ids_swap_free(self._dev["ids"], sd, dd, fd)
            self._dev["valid_end"] = jnp.asarray(self._valid_end)

    def _remove_arena_compact(self, slots: np.ndarray) -> None:
        """Non-residual arenas (no per-tile-list valid_end mask in the
        plain kernel): one host-side filtered re-sort — exact, O(N)."""
        keep = np.ones(self._n, bool)
        keep[slots] = False
        ids_arr = np.asarray(self._ids[: self._n], np.int64)
        keep &= ids_arr >= 0  # drop pre-existing hole slots too
        cap_assign = np.repeat(np.arange(self.nlist), np.diff(self._offsets))
        payload = np.asarray(self._payload)[: self._n][keep]
        self._assemble_compact(payload, ids_arr[keep], cap_assign[keep])

    def _quantize_rows(self, vectors, assigns):
        """f32 device rows → arena payload dtype under the existing scale.
        New batches whose amplitude exceeds the build-time clip simply clip
        (int8 scale stays fixed so pending/arena scores stay comparable)."""
        if self._resid8:
            vectors = vectors - jnp.asarray(self.centroids)[assigns]
        if self.dtype == "int8":
            return jnp.clip(
                jnp.round(vectors / self._scale), -127, 127
            ).astype(jnp.int8)
        return vectors.astype(jnp.float32)

    def _fold_pending(self) -> None:
        """Threshold-triggered pending fold. Device-resident int8 arenas
        fold into the device ANNEX: the 12.5M/card
        arena is 9.6 GB — the full-compact host round-trip
        (merge_pending) costs ~GB-scale PCIe traffic and CANNOT run
        device-side either, since HBM won't hold two arena copies for a
        re-sort. The annex keeps merged adds device-resident and exactly
        searchable (one small matmul per query batch, _annex_scan);
        merge_pending (save/compact) folds it back through the host."""
        if (isinstance(self._payload, jax.Array)
                and self.dtype == "int8"):
            self._fold_pending_annex()
        else:
            self.merge_pending()

    def _fold_pending_annex(self) -> None:
        if self._pending.size == 0:
            return
        rows8, pids, passign = self._pending.drain()
        self._pending_dev = None
        n_new = rows8.shape[0]
        npad = _next_pow2(max(n_new, 1024))
        if self._annex is None:
            cap = max(npad, 8192)
            self._annex = dict(
                rows=jnp.zeros((cap, self.dim), jnp.int8),
                assign=jnp.zeros((cap,), jnp.int32),
                ids=np.full(cap, -1, np.int64), n=0)
        ax = self._annex
        cap = ax["ids"].shape[0]
        if ax["n"] + npad > cap:  # grow ×pow2 (annex-only device copy)
            cap = _next_pow2(ax["n"] + npad)
            ax["rows"] = (jnp.zeros((cap, self.dim), jnp.int8)
                          .at[: ax["rows"].shape[0]].set(ax["rows"]))
            ax["assign"] = (jnp.zeros((cap,), jnp.int32)
                            .at[: ax["assign"].shape[0]].set(ax["assign"]))
            ids2 = np.full(cap, -1, np.int64)
            ids2[: ax["n"]] = ax["ids"][: ax["n"]]
            ax["ids"] = ids2
        pad_rows = np.zeros((npad, self.dim), np.int8)
        pad_rows[:n_new] = rows8
        pad_assign = np.zeros(npad, np.int32)
        pad_assign[:n_new] = passign
        ax["rows"], ax["assign"] = _annex_append(
            ax["rows"], ax["assign"], jnp.asarray(pad_rows),
            jnp.asarray(pad_assign), ax["n"])
        ax["ids"][ax["n"] : ax["n"] + n_new] = pids
        ax["n"] += n_new
        self._annex_ver += 1

    def merge_pending(self) -> None:
        """Fold pending (and any device annex) into the arena: one native
        counting sort of the union (no re-quantization — scales are already
        unified). For device-resident arenas this is the COMPACT path (the
        payload crosses to the host once); serving-path folds use
        _fold_pending instead."""
        ax = self._annex if (self._annex is not None
                             and self._annex["n"]) else None
        if self._pending.size == 0 and ax is None:
            return
        if self._pending.size:
            p, pids, passign = self._pending.drain()
        else:
            p = np.zeros((0, self.dim),
                         np.int8 if self.dtype == "int8" else np.float32)
            pids = np.zeros(0, np.int64)
            passign = np.zeros(0, np.int64)
        if ax is not None:
            axn = ax["n"]
            p = np.concatenate(
                [p, np.asarray(ax["rows"][:axn]).astype(p.dtype)])
            pids = np.concatenate([pids, ax["ids"][:axn]])
            passign = np.concatenate(
                [passign, np.asarray(ax["assign"][:axn], passign.dtype)])
            self._annex = None
        self._pending_dev = None
        if self._n and self._try_merge_inplace_device(p, pids, passign):
            return
        if self._n:
            cap_assign = np.repeat(
                np.arange(self.nlist), np.diff(self._offsets)
            )
            if self._list_lens is not None:  # slack arena: skip hole slots
                valid_pos = np.flatnonzero(
                    np.asarray(self._ids[: self._n]) >= 0)
                old_payload = np.asarray(self._payload)[valid_pos]
                old_assign = cap_assign[valid_pos]
                old_ids = np.asarray(self._ids, np.int64)[valid_pos]
            else:
                old_payload = np.asarray(self._payload)[: self._n]
                old_assign = cap_assign
                old_ids = self._ids.astype(np.int64)
            payload_all = np.concatenate([old_payload, p.astype(old_payload.dtype)])
            ids_all = np.concatenate([old_ids, pids])
            assign_all = np.concatenate([old_assign, passign])
        else:
            payload_all, ids_all, assign_all = p, pids, passign
        self._assemble_compact(payload_all, ids_all, assign_all)

    def _try_merge_inplace_device(self, p, pids, passign) -> bool:
        """In-place device compact merge: fold drained
        pending/annex rows into a DEVICE-resident compact int8 arena with
        ZERO payload fetch — HBM cannot hold two 9.6 GB arenas at
        12.5M×768/chip, so the classic rebuild-into-a-new-buffer is
        impossible at exactly the scale that matters; instead the arena is
        over-allocated at build time (``merge_headroom``) and old rows
        SHIFT RIGHT inside the same donated buffer.

        Mechanics: per-list shifts are the prefix sums of the inserted
        counts, so destinations are monotone in source position — chunks of
        C rows processed source-DESCENDING never read a slot an earlier
        chunk wrote (earlier writes all land at strictly higher positions),
        and within one ``buf.at[dst].set(buf[src])`` XLA materializes the
        C-row gather before the scatter, so self-overlap is safe. Peak
        extra HBM = one C-row temp (~192 MB) + the (N,) destination map.
        Pending rows (already arena-scale int8, ``_quantize_rows``) scatter
        into their lists' new tail slots in one shot. Returns False when
        the path doesn't apply (host/f32/slack arena, or merged extent
        exceeds the arena capacity) — caller falls back to the host merge.
        """
        if not (isinstance(self._payload, jax.Array)
                and self.dtype == "int8" and self._list_lens is None
                and p.shape[0]):
            return False
        cap_rows = int(self._payload.shape[0])
        n_old = self._n
        counts_old = np.diff(self._offsets)
        passign = np.asarray(passign, np.int64)
        pc = np.bincount(passign, minlength=self.nlist)
        offsets_new = np.concatenate(
            [[0], np.cumsum(counts_old + pc)]).astype(np.int64)
        n_new = int(offsets_new[-1])
        if n_new > cap_rows:
            return False  # headroom exhausted — host merge re-sizes
        shift = (offsets_new[:-1] - self._offsets[:-1]).astype(np.int64)
        # per-source-row destination (monotone: lists are ordered, within-
        # list order kept) + pending destinations (list tail slots, stable)
        row_list = np.repeat(np.arange(self.nlist), counts_old)
        dst_all = np.arange(n_old, dtype=np.int64) + shift[row_list]
        order_p = np.argsort(passign, kind="stable")
        rank = np.arange(p.shape[0]) - np.searchsorted(
            passign[order_p], passign[order_p])
        dest_p = np.empty(p.shape[0], np.int64)
        dest_p[order_p] = (offsets_new[:-1][passign[order_p]]
                           + counts_old[passign[order_p]] + rank)
        buf = self._payload
        dst_dev = jnp.asarray(dst_all.astype(np.int32))
        C = 1 << 18  # 256k rows ≈ 192 MB at 768-d — the bounded move temp
        # rows before the first shifted list stay put — skip their chunks
        # (a small pending batch usually leaves a long unshifted prefix)
        src_min = (int(self._offsets[:-1][np.argmax(shift > 0)])
                   if (shift > 0).any() else n_old)
        # source-DESCENDING chunks, exact sizes (at most one short chunk →
        # one extra compile per distinct remainder; this is a checkpoint-
        # time op). Low-end padding would be UNSAFE: re-moving a row whose
        # source slot a later-positioned write already overwrote would
        # clobber its correct destination.
        for s in list(range(src_min, n_old, C))[::-1]:
            buf = _move_rows(buf, dst_dev, s, min(C, n_old - s))
        # donated scatter (_scatter_set) — an EAGER .at[].set() cannot alias
        # and would allocate a second full arena
        buf = _scatter_set(buf, jnp.asarray(dest_p.astype(np.int32)),
                           jnp.asarray(p))
        ids_new = np.empty(n_new, np.int64)
        ids_new[dst_all] = np.asarray(self._ids, np.int64)[:n_old]
        ids_new[dest_p] = pids
        self._payload = buf
        self._ids = ids_new
        self._offsets = offsets_new
        self._n = n_new
        self._tile_window = self._compute_tile_window()
        if self._resid8:
            self._build_residual_aux()
        self._dev = None
        return True

    def _pending_device(self):
        """Pending rows staged on device, padded to a power-of-2 row count so
        repeated adds reuse compiled pending-scan executables. Residual mode
        reconstructs centroid + s·r8 once (pending is small) so the exact
        scan runs on plain rows with scale 1."""
        if self._pending_dev is None:
            snap = self._pending.snapshot_full()
            if snap is None:
                return None
            rows, pids, passign = snap
            p_pad = _next_pow2(max(rows.shape[0], 128))
            if self._resid8:
                recon = (self.centroids[passign]
                         + rows.astype(np.float32) * self._scale)
                padded = np.zeros((p_pad, self.dim), np.float32)
                padded[: rows.shape[0]] = recon
            else:
                padded = np.zeros((p_pad, self.dim), rows.dtype)
                padded[: rows.shape[0]] = rows
            pids_pad = np.zeros(p_pad, np.int64)
            pids_pad[: rows.shape[0]] = pids
            self._pending_dev = (jnp.asarray(padded), pids,
                                 jnp.asarray(pids_pad.astype(np.int32)),
                                 rows.shape[0])
        return self._pending_dev

    def _pending_scan_scale(self) -> float:
        if self._resid8:
            return 1.0  # pending rows are pre-reconstructed
        return self._scale if self.dtype == "int8" else 1.0

    def _merge_pending_topk(self, v, gids, queries, k, flt=None):
        """Merge arena top-k (host np) with exact device scans of the
        pending buffer and (if present) the device annex arena. flt
        (IdFilter) masks pending/annex candidates by global id — arena
        candidates are already masked in-kernel."""
        extra_v, extra_i = [], []
        pdev = self._pending_device()
        if pdev is not None:
            rows_dev, pids, _, n_pend = pdev
            scale = self._pending_scan_scale()
            pv, pi = _pending_scan(
                jnp.asarray(queries, jnp.float32), rows_dev, scale, n_pend,
                k=min(k, n_pend), l2=self.metric == "l2",
            )
            extra_v.append(np.asarray(pv))
            extra_i.append(pids[np.asarray(pi)])
        ax = self._annex
        if ax is not None and ax["n"]:
            av, ap = _annex_scan(
                jnp.asarray(queries, jnp.float32), ax["rows"], ax["assign"],
                jnp.asarray(self.centroids), self._scale, ax["n"],
                k=min(k, ax["n"]), resid=self._resid8,
                l2=self.metric == "l2",
            )
            extra_v.append(np.asarray(av))
            extra_i.append(ax["ids"][np.asarray(ap)])
        if not extra_v:
            return v, gids
        if flt is not None:
            extra_v = [np.where(flt.allowed_np(ei), ev, -np.inf)
                       for ev, ei in zip(extra_v, extra_i)]
        all_v = np.concatenate([v, *extra_v], axis=1)
        all_i = np.concatenate([gids, *extra_i], axis=1)
        sel = np.argsort(-all_v, axis=1, kind="stable")[:, :k]
        out_v = np.take_along_axis(all_v, sel, 1)
        out_i = np.take_along_axis(all_i, sel, 1)
        if flt is not None:  # unfilled slots keep the (-inf, -1) convention
            out_i = np.where(out_v > -np.inf, out_i, -1)
        return out_v, out_i

    def reconstruct(self, ids) -> np.ndarray:
        """Approximate rows (dequantized payload) for the given global ids,
        covering both arena and pending rows."""
        ids = np.asarray(ids)
        ids_arr = np.asarray(self._ids, np.int64)
        valid = np.flatnonzero(ids_arr >= 0)
        pos = np.full(max(self._gid_bound(), 1), -1, np.int64)
        pos[ids_arr[valid]] = valid
        snap = self._pending.snapshot_full()
        out = np.empty((ids.shape[0], self.dim), np.float32)
        scale = self._scale if self.dtype == "int8" else 1.0
        arena_mask = pos[ids] >= 0
        if arena_mask.any():
            rows = pos[ids[arena_mask]]
            dec = np.asarray(self._payload)[rows].astype(np.float32) * scale
            if self._resid8:
                assign = np.searchsorted(self._offsets, rows, side="right") - 1
                dec = dec + self.centroids[assign]
            out[arena_mask] = dec
        if (~arena_mask).any():
            p_rows = np.zeros((0, self.dim), np.float32)
            p_ids = np.zeros(0, np.int64)
            p_assign = np.zeros(0, np.int64)
            if snap is not None:
                p_rows, p_ids, p_assign = snap
            if self._annex is not None and self._annex["n"]:
                axn = self._annex["n"]
                p_rows = np.concatenate(
                    [np.asarray(p_rows), np.asarray(self._annex["rows"][:axn])])
                p_ids = np.concatenate([p_ids, self._annex["ids"][:axn]])
                p_assign = np.concatenate(
                    [p_assign, np.asarray(self._annex["assign"][:axn],
                                          np.int64)])
            assert p_rows.shape[0], "id not in arena and no pending rows"
            ppos = np.full(max(self._gid_bound(), 1), -1, np.int64)
            ppos[p_ids] = np.arange(p_rows.shape[0])
            sel = ppos[ids[~arena_mask]]
            assert (sel >= 0).all(), "unknown id"
            dec = p_rows[sel].astype(np.float32) * scale
            if self._resid8:
                dec = dec + self.centroids[p_assign[sel]]
            out[~arena_mask] = dec
        return out

    def _device_state(self):
        if self._dev is None:
            dt = {"int8": jnp.int8, "bfloat16": jnp.bfloat16, "float32": jnp.float32}[
                self.dtype
            ]
            self._dev = dict(
                payload=jnp.asarray(self._payload, dt),  # no-op if device-resident
                centroids=jnp.asarray(self.centroids),
                ids=jnp.asarray(self._ids, jnp.int32),
                tile_window=jnp.asarray(self._tile_window),
            )
            if self._resid8:
                self._dev["local"] = jnp.asarray(self._local)
                self._dev["valid_end"] = jnp.asarray(self._valid_end)
        return self._dev

    def make_filter(self, where):
        """Coerce `where` (IdFilter | bool mask by global id | array of
        allowed gids) into an IdFilter for this index's id space. Build
        once and reuse across searches — the device bitmap uploads once."""
        from cloudvectordb_tpu.index.filters import IdFilter

        return IdFilter.coerce(where, self._gid_bound())

    def search(self, queries, k: int, nprobe: int = 32, interpret: bool = False,
               p_tiles: int = 0,
               scoring: str = "hybrid", tile_q: int | None = None,
               where=None, top2: bool | None = None):
        """Device-planned query-clustered tile probing — one dispatch,
        compute ∝ p_tiles/n_tiles of a full scan. interpret=True runs the
        GPU scan kernel in the Pallas interpreter (tests only;
        ops/backend.py decides everything else). top2 is accepted for
        stored op points; the scan keeps an exact top-k over the planned
        tiles, so it changes nothing.
        scoring (int8 arenas only): 'hybrid' (default) scores int8 rows in
        bf16 against unquantized bf16 queries — no query-side quantization
        noise, bf16 tensor-core rate; 'int8' is the int8-MMA two-sided path.
        tile_q: per-search query-tile override — smaller groups make the
        shared tile table more specific for small/diverse batches
        (see _auto_p_tiles).
        where: optional id predicate (IdFilter | bool mask by global id |
        array of allowed gids — see index/filters.py). Residual-int8
        arenas mask at SCORE time in the kernel (exact at any
        selectivity); other arena dtypes use filters.filtered_search.
        Queries with fewer than k allowed hits return (-inf, -1) tails."""
        assert self._n, "empty index"
        queries = np.asarray(queries, np.float32)
        flt = self.make_filter(where) if where is not None else None
        op = self._op_point or {}  # tuned knobs fill sentinel defaults
        if p_tiles <= 0:
            p_tiles = op.get("p_tiles", 0)
        if tile_q is None:
            tile_q = op.get("tile_q")
        return self._search_tiles(queries, k, nprobe, p_tiles, interpret,
                                  scoring, tile_q, flt=flt)

    def _resolve_tiles_knobs(self, nq, nprobe, p_tiles, tile_q):
        """Shared knob resolution for the host and device search paths:
        small-batch query-tile shrink + span-aware auto coverage."""
        n_tiles = int(self._payload.shape[0]) // self.tile_n
        tq = tile_q or self.tile_q
        if tile_q is None and nq < tq:
            # small-batch latency: padding a B<tq batch to a full query
            # group makes the kernel score tq queries' worth of rows —
            # wasted compute at B=8. Shrink to the
            # pow2 cover of the batch (bucketed: bounded distinct compiles)
            tq = max(8, _next_pow2(nq))
        if p_tiles <= 0:
            p_tiles = self._auto_p_tiles(nq, nprobe, n_tiles, tile_q=tq)
        return p_tiles, tq

    def _arena_row_mask(self, flt):
        """Kernel-ready arena-order allow mask for `flt`, cached per
        (filter, device id-table object) — the (N,) gid gather touches the
        whole arena, so it runs once per filter per arena state. Mutation
        paths rebind the device ids array (donated scatters and
        re-staging return new objects), so object identity is a sound
        invalidation key; entries hold refs so ids stay unique."""
        st = self._device_state()
        ids_obj = st["ids"]
        cache = getattr(self, "_flt_cache", None)
        if cache is None:
            cache = self._flt_cache = {}
        key = (id(flt), id(ids_obj))
        hit = cache.get(key)
        if hit is None:
            if len(cache) > 32:  # bound multi-tenant rotation
                cache.clear()
            rm = self._split_row_mask(_arena_mask_from_ids(
                ids_obj, flt.mask_device(), n_pad=self._mask_pad_rows()))
            cache[key] = hit = (flt, ids_obj, rm)
        return hit[2]

    def _mask_pad_rows(self) -> int:
        """PADDED arena row count the filter mask must cover (see
        _arena_mask_from_ids)."""
        return int(self._payload.shape[0])

    def _split_row_mask(self, rm):
        return rm  # PQ family re-slices for segmented arenas

    def _tiles_kernel_dispatch(self, qp, k, p_tiles, tq, scoring, interpret,
                               flt=None):
        """One device dispatch of the tiles search over the arena (pending/
        annex excluded): qp is a device (q_pad, D) f32 array, q_pad a
        multiple of tq. Returns device (v (q_pad, k) f32, gids (q_pad, k)
        i32)."""
        st = self._device_state()
        if self._resid8:
            return _tiles_resid_plan_search(
                qp, st["centroids"], st["payload"], st["local"],
                self._scale, st["ids"], st["tile_window"], st["valid_end"],
                row_mask=self._arena_row_mask(flt) if flt is not None
                else None,
                k=k, p_tiles=p_tiles, tile_n=self.tile_n, tile_q=tq,
                impl=scan_impl(interpret), int8_q=(scoring != "precise"),
                l2=self.metric == "l2",
            )
        assert flt is None, (
            "where= masks at score time in the residual-int8 kernel; for "
            "other arena dtypes use index.filters.filtered_search")
        if self.dtype == "int8":
            # 'precise' (bf16 queries, no query-side quantization) maps
            # to the hybrid kernel — plain True is the NOISIEST
            # two-sided-int8 mode and must only serve scoring='int8'
            int8_mode = True if scoring == "int8" else "hybrid"
        else:
            int8_mode = False
        return _tiles_plan_search(
            qp, st["centroids"], st["payload"], st["ids"],
            st["tile_window"], self._scale, jnp.asarray(self._n, jnp.int32),
            k=k, p_tiles=p_tiles, tile_n=self.tile_n, tile_q=tq,
            int8=int8_mode, impl=scan_impl(interpret),
        )

    def _search_tiles(self, queries, k, nprobe, p_tiles, interpret,
                      scoring="hybrid", tile_q=None, flt=None):
        nq = queries.shape[0]
        p_tiles, tq = self._resolve_tiles_knobs(nq, nprobe, p_tiles, tile_q)
        q_pad = -(-nq // tq) * tq
        qp = queries if q_pad == nq else np.concatenate(
            [queries, np.repeat(queries[-1:], q_pad - nq, axis=0)]
        )
        v, gids = self._tiles_kernel_dispatch(
            jnp.asarray(qp), k, p_tiles, tq, scoring, interpret, flt=flt)
        v, gids = np.asarray(v)[:nq], np.asarray(gids)[:nq].astype(np.int64)
        return self._merge_pending_topk(v, gids, queries[:nq], k, flt=flt)

    def search_device(self, queries, k: int, nprobe: int = 32,
                      p_tiles: int = 0, scoring: str = "hybrid",
                      tile_q: int | None = None,
                      interpret: bool = False, where=None,
                      top2: bool | None = None):
        """All-device serving path: ``queries`` is (or becomes) a device
        (B, D) f32 array and the returned (scores (B, k) f32, ids (B, k)
        i32) are device arrays — once warm there is NO host↔device
        transfer or host compute in the call, so a serving loop can chain
        results on device (filter, re-rank, feed a model) and fetch only
        what it ships out. ``search()`` wraps the same kernels for
        np-in/np-out convenience; its batches cross the host link every
        call (a PCIe copy each way).

        Ids are int32 (the arena id-table dtype; x64 stays disabled).
        Pending and annex rows are scanned exactly on device and merged
        into the arena top-k (device scans cached per pending/annex
        version) — no fold happens per call; add() folds at its own
        threshold. Tuned op points (``tune()``) fill unset knobs, as in
        ``search()``.
        """
        assert self._n, "empty index"
        queries = jnp.asarray(queries, jnp.float32)
        flt = self.make_filter(where) if where is not None else None
        nq = queries.shape[0]
        op = self._op_point or {}
        if p_tiles <= 0:
            p_tiles = op.get("p_tiles", 0)
        if tile_q is None:
            tile_q = op.get("tile_q")
        p_tiles, tq = self._resolve_tiles_knobs(nq, nprobe, p_tiles, tile_q)
        q_pad = -(-nq // tq) * tq
        qp = queries if q_pad == nq else jnp.concatenate(
            [queries, jnp.repeat(queries[-1:], q_pad - nq, axis=0)])
        v, gids = self._tiles_kernel_dispatch(
            qp, k, p_tiles, tq, scoring, interpret, flt=flt)
        return self._merge_pending_topk_device(v[:nq], gids[:nq], queries, k,
                                               flt=flt)

    def _annex_ids_device(self):
        """Device copy of the annex id table, cached per annex version
        (folds append, removes swap in place — both bump _annex_ver)."""
        ax = self._annex
        if ax.get("ids_dev_ver") != self._annex_ver:
            ax["ids_dev"] = jnp.asarray(ax["ids"].astype(np.int32))
            ax["ids_dev_ver"] = self._annex_ver
        return ax["ids_dev"]

    def _merge_pending_topk_device(self, v, gids, queries, k, flt=None):
        """Device twin of _merge_pending_topk for the search_device path:
        exact device scans of the pending buffer and the annex, merged by
        one device top-k. No fold happens here — add() folds at its own
        threshold (the PQ family's fold is a host-side compact that must
        not be promoted into a per-search cost), and the pending scan is
        exact, so results match search() either way. queries must be in
        the same space the pending/annex rows live in (rotated, for the
        PQ family). flt (IdFilter) masks pending/annex candidates on
        device."""
        extra_v, extra_i = [], []
        pdev = self._pending_device()
        if pdev is not None:
            rows_dev, _, pids_dev, n_pend = pdev
            pv, pi = _pending_scan(
                queries, rows_dev, self._pending_scan_scale(), n_pend,
                k=min(k, n_pend), l2=self.metric == "l2")
            extra_v.append(pv)
            extra_i.append(pids_dev[pi])
        ax = self._annex
        if ax is not None and ax["n"]:
            av, ap = _annex_scan(
                queries, ax["rows"], ax["assign"],
                self._device_state()["centroids"],
                self._scale, ax["n"], k=min(k, ax["n"]), resid=self._resid8,
                l2=self.metric == "l2",
            )
            extra_v.append(av)
            extra_i.append(self._annex_ids_device()[ap])
        if not extra_v:
            return v, gids
        if flt is not None:
            extra_v = [jnp.where(flt.allowed_dev(ei), ev, -jnp.inf)
                       for ev, ei in zip(extra_v, extra_i)]
        all_v = jnp.concatenate([v, *extra_v], axis=1)
        all_i = jnp.concatenate([gids, *extra_i], axis=1)
        v2, pos = jax.lax.top_k(all_v, k)
        out_i = jnp.take_along_axis(all_i, pos, axis=1)
        if flt is not None:
            out_i = jnp.where(v2 > -jnp.inf, out_i, -1)
        return v2, out_i

    def _auto_p_tiles(self, nq: int, nprobe: int, n_tiles: int,
                      tile_q: int | None = None) -> int:
        """Span-aware tile budget (measured at 2M×768, B=512, nlist=2048:
        the old batch-blind 10.5% budget scored recall 0.57; covering the
        group span scores the 0.93 full-coverage ceiling at 25× less scan).

        The planner shares ONE tile table across each group of `tile_q`
        sorted queries, so the budget must cover the group's UNION of
        relevant tiles, not one query's. For g = min(tile_q, nq) queries
        spread over the locality-ordered lists, the union spans
        ≈ min(nlist·g/nq, g·nprobe) lists; multiply by tiles-per-list and
        add a per-query margin. Big batches → homogeneous groups → small
        spans: recall at fixed p_tiles IMPROVES with batch size (document
        this to serving users; small batches should pass a smaller tile_q).
        """
        tq = tile_q or self.tile_q
        g = min(tq, max(nq, 1))
        r = max(self._n, 1) / max(self.nlist, 1) / self.tile_n  # tiles/list
        span = min(self.nlist * g / max(nq, 1), float(g) * nprobe)
        margin = max(8.0, nprobe * max(r, 0.25))
        return int(min(n_tiles, max(8, int(np.ceil(span * r + margin)))))

    # -- op-point tuning (eval/tune.py) -----------------------------------
    def _tune_tile_qs(self, nq: int) -> list[int]:
        """Query-tile sizes worth trying: smaller tiles make the shared
        tile table per-group more specific (the small/diverse-batch lever,
        see _auto_p_tiles) at more planning work. Bucketed to the values
        the benches use so kernel compiles stay cache-warm."""
        cand = {self.tile_q, 32, 64, 128}
        return sorted(t for t in cand if t <= max(32, nq))

    def _tune_n_tiles(self) -> int:
        n_rows = getattr(self, "_n_pad_rows", None)
        if n_rows is None:  # base band arena: padded payload rows
            n_rows = int(self._payload.shape[0])
        return n_rows // self.tile_n

    def _tune_candidates(self, nq: int) -> list[dict]:
        n_tiles = self._tune_n_tiles()
        seen, out = set(), []
        for tq in self._tune_tile_qs(nq):
            base = self._auto_p_tiles(nq, 32, n_tiles, tile_q=tq)
            for mult in (1.0, 1.5, 2.5, 4.0, 7.0, 12.0):
                # bucket to multiples of 32: distinct p_tiles values are
                # distinct kernel compiles
                p = min(n_tiles, max(32, int(base * mult) // 32 * 32))
                if (p, tq) not in seen:
                    seen.add((p, tq))
                    out.append({"p_tiles": p, "tile_q": tq})
                if p >= n_tiles:
                    break
        # scan cost ∝ p_tiles · query-groups; prefer larger tile_q at equal
        # coverage (fewer groups, one shared table each)
        out.sort(key=lambda c: (c["p_tiles"], -c["tile_q"]))
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        # full tile coverage ≡ an exact scan up to arena quantization
        return {"p_tiles": self._tune_n_tiles()}

    # -- persistence ------------------------------------------------------
    def _state_arrays(self):
        self.merge_pending()  # persist one contiguous arena
        out = {
            "centroids": self.centroids,
            "payload": _fetch_chunked(self._payload),
            "ids": self._ids,
            "offsets": self._offsets,
        }
        if self._list_lens is not None:
            out["list_lens"] = self._list_lens
        return out

    def _state_meta_common(self):
        return {
            "nlist": self.nlist, "dtype": self.dtype, "scale": self._scale,
            "n": self._n, "kmeans_iters": self.kmeans_iters, "seed": self.seed,
            "tile_n": self.tile_n, "tile_q": self.tile_q,
            "residual": self.residual, "slack": self.slack,
            "next_id": self._gid_bound(),
        }

    def _state_meta(self):
        return self._state_meta_common()

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict) -> "BandIVFIndex":
        m = manifest["meta"]
        idx = cls(manifest["dim"], m["nlist"], m["dtype"], m["kmeans_iters"],
                  m["seed"], m["tile_n"], m["tile_q"],
                  residual=m.get("residual", False),
                  slack=m.get("slack", 0.0),
                  metric=manifest.get("metric", "ip"))
        idx.centroids = np.asarray(arrays["centroids"])
        idx._payload = np.asarray(arrays["payload"])
        # ids/list_lens are mutated in place by the slack add() path, but
        # load_index mmaps arrays read-only — materialize writable copies
        # (they are small next to the payload, which stays mapped)
        idx._ids = np.array(arrays["ids"], np.int64, copy=True)
        idx._offsets = np.asarray(arrays["offsets"])
        if "list_lens" in arrays:
            idx._list_lens = np.array(arrays["list_lens"], np.int64, copy=True)
        idx._scale = m["scale"]
        idx._n = m["n"]
        idx._next_id = m.get("next_id", 0)  # 0: derive lazily (_gid_bound)
        idx._tile_window = idx._compute_tile_window()
        if idx._resid8:  # aux derives from offsets + lens — not persisted
            idx._build_residual_aux()
        return idx


class BandIVFPQIndex(BandIVFIndex):
    """Tile-pruned PQ index with int8 refinement — the 1B-scale configuration
    (BASELINE config #5): PQ codes are the HBM-resident memory format
    (m bytes/vec, 12× smaller than int8 raw), the tile table prunes decode
    compute to each query tile's probed lists, and an optional int8 refine
    store re-ranks the candidate set exactly.

    Memory per chip at 1B/8 = 125M rows: codes m=64 → 8 GB ✓; refine int8
    would need 96 GB → refine='none' at 1B (PQ-ceiling recall) or refine
    shards on host. At ≤100M, refine='int8' fits and recovers exact-ish
    recall.
    """

    kind = "band_ivf_pq"

    # Row-major code arenas past this row count are stored as SEGMENTS
    # (each + one trailing zero pad tile). The cap is TPU-derived (a
    # compiler DMA limit of the first accelerator this ran on) and not yet
    # measured on the H100 (ROADMAP C3). ops/pq_scan.py scans per segment
    # and merges candidates; everything else sees one logical arena.
    seg_rows_cap = 28 * 1024 * 1024

    def __init__(
        self,
        dim: int,
        nlist: int,
        m: int = 64,
        nbits: int = 8,
        refine: str = "int8",
        pq_train_iters: int = 8,
        kmeans_iters: int = 15,
        seed: int = 0,
        # planning granularity of the plain PQ scan; the values came from
        # the TPU rounds and are not measured on the H100 (ROADMAP C3)
        tile_n: int = 1024,
        tile_q: int = 128,
        residual: bool = True,
        opq_matrix: np.ndarray | None = None,
        aniso_eta: float = 0.0,
        m2: int = 32,
        nbits2: int = 8,
        metric: str = "ip",
    ):
        """refine tiers (r3 adds the two 1B-scale options):

        - 'int8'  — residual-int8 rows in HBM (dim bytes/row): near-exact,
                    fits ≤ ~16M rows/chip at 768-d.
        - 'pq2'   — SECOND-tier PQ (m2 bytes/row, default 32) trained on the
                    tier-1 reconstruction ERROR, codes in HBM keyed by
                    global id. Rescore adds a tier-2 ADC correction to the
                    kernel's tier-1 candidate score: ~1.5× the per-row code
                    bits at +m2/m HBM — the config-#5 refine that still fits
                    at 125M rows/chip (8 GB tier-1 + 4 GB tier-2).
        - 'host'  — int8 residual rows in HOST memory (keyed by global id),
                    exact rescore of the candidate shortlist. Per batch the
                    host link carries B·k_cand·dim bytes (B=4096, k=512,
                    768-d → 1.6 GB ≈ 60–160 ms on real PCIe3/4 — overlaps
                    with the next batch's scan).
        - 'pq2+host' — the r4 CASCADE: tier-2 ADC narrows the kernel's
                    k_cand candidates ON-CHIP to a k_host = k·host_factor
                    shortlist, and only the survivors' rows cross PCIe for
                    the exact host rescore. Same recall ceiling as 'host'
                    at the same k_cand (tier-2 ranks candidates far better
                    than tier-1 alone), with the PCIe shortlist bytes cut
                    k_cand/k_host (~8–16×) — the config-#5 QPS-at-quality
                    bridge.
        """
        super().__init__(dim, nlist, dtype="int8", kmeans_iters=kmeans_iters,
                         seed=seed, tile_n=tile_n, tile_q=tile_q,
                         metric=metric)
        assert dim % m == 0 and refine in ("none", "int8", "pq2", "host",
                                           "pq2+host")
        assert dim % m2 == 0
        self.opq_matrix = opq_matrix  # x' = x @ Rᵀ before coarse+PQ
        self.m = m
        self.nbits = nbits
        self.refine = refine
        self.residual = residual
        self.aniso_eta = aniso_eta  # >1: score-aware codebooks (index/pq.py)
        # residual-PQ mode stores refine rows as int8 RESIDUALS (the local
        # list byte needed to recover the centroid term already exists)
        self._refine_residual = residual and refine == "int8"
        self.pq_train_iters = pq_train_iters
        self.m2 = m2                  # tier-2 PQ (refine='pq2')
        self.nbits2 = nbits2
        self.codebooks2: np.ndarray | None = None
        self._codes2 = None           # (N_cap, m2) uint8 keyed by GLOBAL id
        self._s2 = None               # (N_cap,) f32 ‖x̂₂‖²−‖x̂₁‖² (l2 only)
        self._s2_pending: list[np.ndarray] = []
        self._host_rows = None        # (N_cap, dim) int8 host, by global id
        self._host_assign = None      # (N_cap,) int32 list id, by global id
        self._host_scale = 0.0
        self.codebooks: np.ndarray | None = None
        self._codes_cm = None  # (m[+1], N_pad) uint8, arena-ordered, device
        self._refine_rows = None  # (N_pad, dim) int8, arena-ordered
        self._centroid_tiles = None  # (n_tiles, W, D) residual-mode centroids
        # pending adds: base PendingBuffer holds (int8 rows, ids, assigns) in
        # ROTATED space for the exact pending scan; PQ codes ride alongside
        # in the same chunk order for the eventual arena merge.
        self._pending_codes: list[np.ndarray] = []
        self._codes2_pending: list[np.ndarray] = []     # gid-ordered appends
        self._host_pending_rows: list[np.ndarray] = []
        self._host_pending_assign: list[np.ndarray] = []
        self._assign_gid: np.ndarray | None = None  # attach_host_refine
        self._pending_scale = 0.0
        self._codes_row_major = False  # device-resident builds store (N, m+1)

    @property
    def _segmented(self) -> bool:
        return isinstance(self._codes_cm, (list, tuple))

    # refine-mode TIER membership: 'pq2+host' carries BOTH a tier-2 code
    # table and a host row store — every build/add/persist site keys on
    # these, never on mode equality, so the cascade composes for free
    @property
    def _tier2_active(self) -> bool:
        return self.refine in ("pq2", "pq2+host")

    @property
    def _host_active(self) -> bool:
        return self.refine in ("host", "pq2+host")

    def merge_from(self, other: "BandIVFPQIndex",
                   id_offset: int | None = None) -> int:
        """Consolidate another SAME-QUANTIZER PQ-tiles index into this one
        (the FAISS ``merge_from`` surface on the config-#5 memory format):
        PQ codes transfer verbatim when coarse centroids AND codebooks are
        shared (train once, build per worker), so independent builds merge
        with one native re-sort and zero re-encoding. Every refine tier
        consolidates: arena-ordered int8 rows re-sort alongside the codes
        (requantized to this index's scale when the scales differ),
        gid-keyed pq2 codes (+ the l2 s₂ table) and host-RAM rows scatter
        under the shifted ids (zero-filling id-space gaps). ``other`` is
        left untouched; global ids must not collide — pass ``id_offset``
        to shift ``other``'s. Arenas growing past seg_rows_cap re-segment
        through the normal install path (refine='int8' keeps its loud
        _reassemble guard there). Returns the number of rows merged in."""
        from cloudvectordb_tpu.index.arena import grow_scatter_gid

        assert self.kind == other.kind and self.dim == other.dim
        assert self.metric == other.metric and self.m == other.m
        assert self.nbits == other.nbits and self.residual == other.residual
        assert self.refine == other.refine
        assert (self.opq_matrix is None) == (other.opq_matrix is None)
        np.testing.assert_allclose(
            self.centroids, other.centroids, atol=1e-6,
            err_msg="merge_from needs the SHARED coarse quantizer (train "
                    "once, reuse for every worker's build)")
        np.testing.assert_allclose(self.codebooks, other.codebooks,
                                   atol=1e-6)
        if self.opq_matrix is not None:
            np.testing.assert_allclose(self.opq_matrix, other.opq_matrix,
                                       atol=1e-6)
        if self._tier2_active:
            assert self.m2 == other.m2 and self.nbits2 == other.nbits2
            np.testing.assert_allclose(self.codebooks2, other.codebooks2,
                                       atol=1e-6)
        self.merge_pending()
        other.merge_pending()
        ids_s = np.asarray(self._ids, np.int64)
        ids_o = np.asarray(other._ids, np.int64)
        src_o = ids_o  # other's UNSHIFTED gids key its gid-keyed tiers
        if id_offset is not None:
            ids_o = ids_o + int(id_offset)
        both = np.concatenate([ids_s, ids_o])
        uniq = np.unique(both)
        assert uniq.size == both.size, (
            f"{both.size - uniq.size} colliding global ids — pass "
            "id_offset=self._gid_bound() (or any disjoint shift)")
        codes_all = np.concatenate([self._codes_np_rows()[: self._n],
                                    other._codes_np_rows()[: other._n]])
        assigns = np.concatenate([
            np.repeat(np.arange(self.nlist), np.diff(self._offsets)),
            np.repeat(np.arange(self.nlist), np.diff(other._offsets)),
        ]).astype(np.int32)
        refine_all = None
        if self.refine == "int8":
            r_o = np.asarray(other._refine_rows)[: other._n]
            if other._scale != self._scale:
                r_o = np.clip(np.round(r_o.astype(np.float32)
                                       * (other._scale / self._scale)),
                              -127, 127).astype(np.int8)
            refine_all = np.concatenate(
                [np.asarray(self._refine_rows)[: self._n], r_o])
        if self._tier2_active:
            self._codes2_device()   # fold pending appends — fresh builds
            other._codes2_device()  # may carry the whole table in pending
            self._codes2 = grow_scatter_gid(
                np.asarray(self._codes2), np.asarray(other._codes2)[src_o],
                ids_o)
            if self.metric == "l2":
                assert self._s2 is not None and other._s2 is not None
                self._s2 = grow_scatter_gid(
                    np.asarray(self._s2), np.asarray(other._s2)[src_o],
                    ids_o)
        if self._host_active:
            rows_s, asg_s = self._host_store()
            rows_o, asg_o = other._host_store()
            assert rows_s is not None and rows_o is not None, (
                "refine='host' merge needs both host stores attached")
            # unify scales (larger wins — requantizing DOWN loses range)
            s = max(self._host_scale, other._host_scale)
            if s > self._host_scale:
                rows_s = np.clip(np.round(
                    rows_s.astype(np.float32) * (self._host_scale / s)),
                    -127, 127).astype(np.int8)
            r_o = rows_o[src_o]
            if s > other._host_scale:
                r_o = np.clip(np.round(
                    r_o.astype(np.float32) * (other._host_scale / s)),
                    -127, 127).astype(np.int8)
            self._host_scale = s
            self._host_rows = grow_scatter_gid(rows_s, r_o, ids_o)
            self._host_assign = grow_scatter_gid(asg_s, asg_o[src_o], ids_o)
        # attach_host_refine bookkeeping survives only when both sides
        # kept it (its contract is full gid coverage)
        if self._assign_gid is not None and other._assign_gid is not None:
            self._assign_gid = grow_scatter_gid(
                self._assign_gid, other._assign_gid[src_o], ids_o)
        else:
            self._assign_gid = None
        self._reassemble(codes_all, both, assigns, refine_all)
        self._next_id = int(uniq[-1]) + 1 if uniq.size else 0
        return int(ids_o.shape[0])

    def _derive_l_buckets(self, k_cand: int, n_pools: int) -> int:
        """Kernel bucket count for a candidate budget: the next power of two
        of ceil(k_cand/n_pools), floored at 128, that divides tile_n (the
        kernel reshapes each tile into (rows_per_bucket, l_buckets)).
        Shared by search() and every bench/sweep script — deriving it ad hoc
        breaks on configs where ceil(k_cand/n_pools) is not a power of two."""
        l_buckets = min(self.tile_n, max(128, _next_pow2(-(-k_cand // n_pools))))
        while self.tile_n % l_buckets != 0 and l_buckets < self.tile_n:
            l_buckets *= 2  # must divide tile_n
        l_buckets = min(l_buckets, self.tile_n)
        if self.tile_n % l_buckets != 0:  # non-pow2 tile_n: fall back
            l_buckets = self.tile_n
        return l_buckets

    def _seg_layout(self, n_pad: int):
        """(row_counts, offsets) for a segmented row-major arena."""
        cap = (self.seg_rows_cap // self.tile_n) * self.tile_n
        rows, offs, off = [], [], 0
        while off < n_pad:
            r = min(cap, n_pad - off)
            rows.append(r)
            offs.append(off)
            off += r
        return rows, offs

    def _codes_np_rows(self) -> np.ndarray:
        """(N_pad, m) row-major host view of the code arena, any layout."""
        if self._segmented:
            return np.concatenate(
                [np.asarray(s)[: -self.tile_n] for s in self._codes_cm])
        cm = np.asarray(self._codes_cm)
        if self._codes_row_major:
            return cm[:, : self.m]
        return np.ascontiguousarray(cm[: self.m].T)

    def _install_codes_host(self, sorted_codes: np.ndarray,
                            local: np.ndarray | None) -> None:
        """Install (n, m) host codes (+ per-row local byte in residual mode)
        as the arena in the scale-appropriate layout: column-major below the
        segment cap, row-major segments above it. The code-major layout
        (DESIGN §15) was chosen for the TPU's kernels and is not yet
        measured against a row-major one on the H100 (ROADMAP C3)."""
        n = sorted_codes.shape[0]
        n_pad = self._n_pad_rows
        if n_pad <= self.seg_rows_cap:
            rows_cm = self.m + (1 if self.residual else 0)
            codes_cm = np.zeros((rows_cm, n_pad), np.uint8)
            codes_cm[: self.m, :n] = sorted_codes.T
            if self.residual:
                codes_cm[self.m, :n] = local.astype(np.uint8)
            self._codes_cm = codes_cm
            self._codes_row_major = False
            self._local_rm = None
        else:
            rows, offs = self._seg_layout(n_pad)
            segs, loc_segs = [], []
            for r, off in zip(rows, offs):
                seg = np.zeros((r + self.tile_n, self.m), np.uint8)
                seg[: min(r, n - off)] = sorted_codes[off : off + r]
                segs.append(seg)
                if self.residual:
                    ls = np.zeros((1, r + self.tile_n), np.uint8)
                    ls[0, : min(r, n - off)] = local[off : off + r]
                    loc_segs.append(ls)
            self._codes_cm = segs
            self._codes_row_major = True
            self._local_rm = loc_segs if self.residual else None
        self._payload = self._codes_cm

    def _seg_centroid_tiles(self, ct: np.ndarray) -> list[np.ndarray]:
        """Per-segment (seg_tiles+1, W, D) centroid tiles (zero pad tile)."""
        rows, offs = self._seg_layout(self._n_pad_rows)
        out = []
        for r, off in zip(rows, offs):
            t0, t1 = off // self.tile_n, (off + r) // self.tile_n
            piece = np.concatenate(
                [ct[t0:t1], np.zeros((1, *ct.shape[1:]), ct.dtype)])
            out.append(piece)
        return out

    def _seg_n_valid(self):
        """Per-segment REAL row counts (for in-kernel pad masking)."""
        rows, offs = self._seg_layout(self._n_pad_rows)
        return tuple(
            jnp.asarray(int(np.clip(self._n - off, 0, r)), jnp.int32)
            for r, off in zip(rows, offs)
        )

    def _train_pq_codebooks(self, enc_vecs, xdir) -> np.ndarray:
        """PQ codebooks on `enc_vecs` (residuals when self.residual).

        aniso_eta > 1 switches to score-aware anisotropic training
        (index/pq.py::train_pq_aniso) with `xdir` — the full (rotated)
        datapoints, NOT the residuals — as the score direction."""
        from cloudvectordb_tpu.index.pq import train_pq, train_pq_aniso

        if self.aniso_eta > 1.0:
            return np.asarray(train_pq_aniso(
                enc_vecs, xdir, self.m, self.nbits,
                iters=self.pq_train_iters, eta=self.aniso_eta,
                seed=self.seed))
        return np.asarray(train_pq(enc_vecs, self.m, self.nbits,
                                   iters=self.pq_train_iters, seed=self.seed))

    def _pq_encode_rows(self, enc_in, xdir, codebooks):
        """Encode under the metric the codebooks were trained with."""
        from cloudvectordb_tpu.index.pq import pq_encode, pq_encode_aniso

        if self.aniso_eta > 1.0:
            return pq_encode_aniso(enc_in, xdir, codebooks,
                                   eta=self.aniso_eta)
        return pq_encode(enc_in, codebooks)

    def _codes2_device(self, fold: bool = True):
        """Tier-2 code table (gid-keyed). fold=True folds pending appends
        (a full-table concat — required before pending rows enter the
        ARENA, i.e. at merge_pending/save). The serving path passes
        fold=False: kernel candidates are arena rows only (pending rows are
        scored by the exact pending scan), so their gids never reach the
        pending tail — and the 4 GB concat per post-add search at 125M is
        skipped. A None table always folds (fresh host-streaming builds
        carry the whole gid-ordered table in pending)."""
        if (fold or self._codes2 is None) and self._codes2_pending:
            parts = ([jnp.asarray(self._codes2)]
                     if self._codes2 is not None else [])
            parts.append(jnp.asarray(np.concatenate(self._codes2_pending)))
            self._codes2 = (jnp.concatenate(parts) if len(parts) > 1
                            else parts[0])
            self._codes2_pending = []
        if (fold or self._s2 is None) and self._s2_pending:
            sparts = ([jnp.asarray(self._s2)] if self._s2 is not None
                      else [])
            sparts.append(jnp.asarray(np.concatenate(self._s2_pending)))
            self._s2 = (jnp.concatenate(sparts) if len(sparts) > 1
                        else sparts[0])
            self._s2_pending = []
        # identity-keyed device cache: a disk-loaded (numpy/mmap) table
        # must not re-cross the host link per search (4 GB at 125M/m2=32)
        if getattr(self, "_codes2_dev_src", None) is not self._codes2:
            self._codes2_dev = jnp.asarray(self._codes2)
            self._codes2_dev_src = self._codes2
        return self._codes2_dev

    def _s2_device(self):
        """Device twin of the s₂ table (l2 pq2 — _encode_tier2 doc), folded
        and cached alongside _codes2_device. The serving path calls this
        AFTER _codes2_device(fold=False): gid alignment between the two
        tables is maintained by the shared append sites."""
        self._codes2_device(fold=False)  # fold s2_pending when table is None
        assert self._s2 is not None, (
            "metric='l2' pq2 rescore needs the s₂ table; this index was "
            "built/loaded without it (pre-l2 artifact?)")
        if getattr(self, "_s2_dev_src", None) is not self._s2:
            self._s2_dev = jnp.asarray(self._s2)
            self._s2_dev_src = self._s2
        return self._s2_dev

    def _host_store(self):
        """(rows, assign) host arrays (gid-keyed) with pending folded."""
        if self._host_pending_rows:
            base_r = ([self._host_rows] if self._host_rows is not None
                      else [])
            base_a = ([self._host_assign] if self._host_assign is not None
                      else [])
            self._host_rows = np.concatenate(
                base_r + self._host_pending_rows)
            self._host_assign = np.concatenate(
                base_a + self._host_pending_assign)
            self._host_pending_rows = []
            self._host_pending_assign = []
        return self._host_rows, self._host_assign

    def _host_row_sq(self) -> np.ndarray:
        """(N,) f32 ‖x̂‖² per host-store row (x̂ = c[assign] + s·r) — the
        metric='l2' host-rescore bias source. Computed lazily HOST-side in
        chunks (one pass over the store) and cached per store object; a
        device-side per-candidate centroid gather would need a
        (B, k_cand, D) f32 temp (6.4 GB at the 125M op point)."""
        rows, assign = self._host_store()
        cache = getattr(self, "_host_row_sq_cache", None)
        if cache is not None and cache[0] is rows:
            return cache[1]
        out = host_rows_sq(rows, assign, self.centroids, self._host_scale)
        self._host_row_sq_cache = (rows, out)
        return out

    def _train_tier2(self, enc_sample, xdir) -> None:
        """Tier-2 codebooks (refine='pq2') on the tier-1 reconstruction
        error of the training sample — additive residual PQ."""
        from cloudvectordb_tpu.index.pq import pq_decode, train_pq

        codes = self._pq_encode_rows(enc_sample, xdir,
                                     jnp.asarray(self.codebooks))
        err = jnp.asarray(enc_sample) - pq_decode(
            codes, jnp.asarray(self.codebooks))
        self.codebooks2 = np.asarray(train_pq(
            err, self.m2, self.nbits2, iters=self.pq_train_iters,
            seed=self.seed + 1))

    def _encode_tier2(self, enc_in, codes, c_rows=None, with_s2=False):
        """Tier-2 codes for rows whose tier-1 codes are ``codes``.

        with_s2 (metric='l2'): also return s₂ = ‖x̂₂‖² − ‖x̂₁‖²
        = 2·x̂₁·d₂ + ‖d₂‖² per row (x̂₁ = [c +] decode1, d₂ = decode2) —
        the one scalar the EXACT l2 pq2 rescore needs per candidate
        (_pq2_rescore): the tier-2 correction on −‖q−x̂₁‖² keys is
        2·q·d₂ − s₂, and neither term is recoverable from tier-2 codes
        alone at rescore time. c_rows: the rows' centroids (residual
        mode; None = non-residual, x̂₁ = decode1)."""
        from cloudvectordb_tpu.index.pq import pq_decode, pq_encode

        err = jnp.asarray(enc_in) - pq_decode(
            jnp.asarray(codes), jnp.asarray(self.codebooks))
        codes2 = pq_encode(err, jnp.asarray(self.codebooks2))
        if not with_s2:
            return codes2
        d2 = pq_decode(codes2, jnp.asarray(self.codebooks2))
        xhat1 = jnp.asarray(enc_in) - err  # = decode1, exactly
        if c_rows is not None:
            xhat1 = xhat1 + c_rows
        s2 = 2.0 * jnp.sum(xhat1 * d2, axis=1) + jnp.sum(d2 * d2, axis=1)
        return codes2, s2

    def _set_host_scale(self, enc_sample) -> None:
        rms = float(jnp.sqrt(jnp.mean(enc_sample * enc_sample)))
        amax = float(jnp.max(jnp.abs(enc_sample)))
        self._host_scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)

    @classmethod
    def build(cls, vectors, nlist: int, m: int = 64, train_sample: int = 262_144,
              opq: bool = False, **kw) -> "BandIVFPQIndex":
        vectors = jnp.asarray(vectors, jnp.float32)
        seed = kw.get("seed", 0)
        ns = min(train_sample, vectors.shape[0])
        sel = np.sort(np.random.default_rng(seed).choice(
            vectors.shape[0], ns, replace=False))
        idx = cls.train_proto(vectors[jnp.asarray(sel)], nlist, m=m,
                              opq=opq, **kw)
        if idx.opq_matrix is not None:
            vectors = vectors @ jnp.asarray(idx.opq_matrix).T
        idx._populate(vectors)
        return idx

    @classmethod
    def train_proto(cls, sample, nlist: int, m: int = 64, opq: bool = False,
                    **kw) -> "BandIVFPQIndex":
        """Train every quantizer (OPQ rotation, coarse centroids in band
        order, tier-1 PQ codebooks, tier-2 codebooks / host scale per the
        refine mode) on ``sample`` and return the EMPTY trained index — the
        shared-quantizer prototype that build() populates and the sharded
        wrapper (parallel/dist_band_pq.py) replicates across shards (train
        once, encode everywhere: verbatim-code merges and elastic reshard
        both depend on every shard sharing one quantizer set)."""
        sample = jnp.asarray(sample, jnp.float32)
        idx = cls(int(sample.shape[1]), nlist, m=m, **kw)
        if opq and idx.opq_matrix is None:
            from cloudvectordb_tpu.index.opq import train_opq

            r, _ = train_opq(
                np.asarray(sample[: min(int(sample.shape[0]), 65536)]),
                m, idx.nbits, outer_iters=4, pq_iters=5, seed=idx.seed,
            )
            idx.opq_matrix = r
        tr = (sample @ jnp.asarray(idx.opq_matrix).T
              if idx.opq_matrix is not None else sample)
        c, _ = train_kmeans(tr, nlist, iters=idx.kmeans_iters, seed=idx.seed)
        c = np.asarray(c)
        idx.centroids = c[order_centroids(c)]
        train_vecs = tr
        if idx.residual:
            a_s, _ = assign_clusters(train_vecs, jnp.asarray(idx.centroids))
            train_vecs = train_vecs - jnp.asarray(idx.centroids)[a_s]
        idx.codebooks = idx._train_pq_codebooks(train_vecs, tr)
        if idx._tier2_active:
            idx._train_tier2(train_vecs, tr)
        if idx._host_active:
            idx._set_host_scale(train_vecs)
        return idx

    @classmethod
    def build_streaming(
        cls, chunks, nlist: int, m: int = 64, train_sample: int = 262_144,
        opq: bool = False, **kw,
    ) -> "BandIVFPQIndex":
        """Config #5 verbatim: OPQ+IVF-PQ with a streaming encode→insert
        build. Quantizers (coarse, OPQ rotation, PQ codebooks) train on the
        first chunk; every chunk is rotated/assigned/encoded on device and
        only its m-byte codes (+ optional int8 refine rows) reach the host.
        The arena assembles once with the native parallel sort.
        """
        from cloudvectordb_tpu.utils.native import arena_sort, gather_rows

        idx = None
        code_chunks: list[np.ndarray] = []
        refine_chunks: list[np.ndarray] = []
        assign_chunks: list[np.ndarray] = []
        scale = 1e-12
        for chunk in chunks:
            chunk = jnp.asarray(chunk, jnp.float32)
            if idx is None:
                idx = cls(int(chunk.shape[1]), nlist, m=m, **kw)
                if opq:
                    from cloudvectordb_tpu.index.opq import train_opq

                    ns = min(train_sample, chunk.shape[0], 65536)
                    r, _ = train_opq(np.asarray(chunk[:ns]), m, idx.nbits,
                                     outer_iters=4, pq_iters=5, seed=idx.seed)
                    idx.opq_matrix = r
                rot = (jnp.asarray(idx.opq_matrix).T
                       if idx.opq_matrix is not None else None)
                tr = chunk @ rot if rot is not None else chunk
                ns = min(train_sample, tr.shape[0])
                c, _ = train_kmeans(tr[:ns], nlist, iters=idx.kmeans_iters,
                                    seed=idx.seed)
                c = np.asarray(c)
                idx.centroids = c[order_centroids(c)]
                cdev = jnp.asarray(idx.centroids)
                train_vecs = tr[:ns]
                if idx.residual:
                    a_s, _ = assign_clusters(train_vecs, cdev)
                    train_vecs = train_vecs - cdev[a_s]
                idx.codebooks = idx._train_pq_codebooks(train_vecs, tr[:ns])
                if idx.refine == "int8":
                    src = train_vecs if idx._refine_residual else tr
                    rms = float(jnp.sqrt(jnp.mean(src * src)))
                    amax = float(jnp.max(jnp.abs(src)))
                    scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
                if idx._tier2_active:
                    idx._train_tier2(train_vecs, tr[:ns])
                if idx._host_active:
                    idx._set_host_scale(train_vecs)
            else:
                rot = (jnp.asarray(idx.opq_matrix).T
                       if idx.opq_matrix is not None else None)
                tr = chunk @ rot if rot is not None else chunk
                cdev = jnp.asarray(idx.centroids)
            a, _ = assign_clusters(tr, cdev)
            enc_in = tr - cdev[a] if idx.residual else tr
            codes = idx._pq_encode_rows(enc_in, tr, jnp.asarray(idx.codebooks))
            code_chunks.append(np.asarray(codes))
            assign_chunks.append(np.asarray(a))
            if idx.refine == "int8":
                rsrc = enc_in if idx._refine_residual else tr
                refine_chunks.append(np.asarray(
                    jnp.clip(jnp.round(rsrc / scale), -127, 127).astype(jnp.int8)))
            if idx._tier2_active:  # gid = insertion order: plain append
                if idx.metric == "l2":
                    c2_b, s2_b = idx._encode_tier2(
                        enc_in, codes,
                        c_rows=cdev[a] if idx.residual else None,
                        with_s2=True)
                    idx._codes2_pending.append(np.asarray(c2_b))
                    idx._s2_pending.append(np.asarray(s2_b))
                else:
                    idx._codes2_pending.append(
                        np.asarray(idx._encode_tier2(enc_in, codes)))
            if idx._host_active:
                idx._host_pending_rows.append(np.asarray(jnp.clip(
                    jnp.round(enc_in / idx._host_scale), -127, 127
                ).astype(jnp.int8)))
                idx._host_pending_assign.append(
                    np.asarray(a).astype(np.int32))
        assert idx is not None, "empty stream"
        codes_all = np.concatenate(code_chunks)
        assigns = np.concatenate(assign_chunks)
        n = codes_all.shape[0]
        order, offsets = arena_sort(assigns, nlist)
        idx._offsets = offsets
        idx._n = n
        n_pad = idx._fit_tile_n_to_skew(n)
        idx._tile_window = idx._compute_tile_window()
        sorted_codes = gather_rows(codes_all, order)
        rows_cm = m + (1 if idx.residual else 0)
        codes_cm = np.zeros((rows_cm, n_pad), np.uint8)
        codes_cm[:m, :n] = sorted_codes.T
        if idx.residual:
            tw = idx._tile_window
            _assert_w_fits(tw, "BandIVFPQIndex host build")
            row_tile = np.arange(n) // idx.tile_n
            local = assigns[order] - tw[row_tile, 0]
            codes_cm[m, :n] = local.astype(np.uint8)
            ct = idx.centroids[tw]
            idx._centroid_tiles = jnp.asarray(
                np.ascontiguousarray(ct), jnp.bfloat16)
        else:
            idx._centroid_tiles = None
        idx._codes_cm = codes_cm
        idx._payload = codes_cm
        idx._ids = order.astype(np.int32)
        if idx.refine == "int8":
            rr = gather_rows(np.concatenate(refine_chunks), order)
            if n_pad != n:
                rr = np.concatenate([rr, np.zeros((n_pad - n, idx.dim), np.int8)])
            idx._refine_rows = rr
            idx._scale = scale
        else:
            idx._refine_rows = np.zeros((1, idx.dim), np.int8)
            idx._scale = 0.0
        idx._dev = None
        return idx

    @classmethod
    def build_device_streaming(
        cls, chunk_fn, n_chunks: int, nlist: int, m: int = 64,
        train_sample: int = 262_144, opq: bool = False, **kw,
    ) -> "BandIVFPQIndex":
        """Device-RESIDENT PQ build (config #3 at 10M×768: 7.7 GB of int8
        refine rows + 640 MB of codes never cross the host link). chunk_fn
        must be deterministic — two passes, like the base-class variant:
        pass 1 trains OPQ/coarse/PQ on the first chunk and assigns all;
        pass 2 re-produces each chunk and scatters its codes + refine rows
        into HBM arenas at host-sorted positions.
        """
        from cloudvectordb_tpu.utils.native import arena_sort

        idx = None
        assigns: list[np.ndarray] = []
        sizes: list[int] = []
        for ci in range(n_chunks):
            chunk = chunk_fn(ci)
            if idx is None:
                idx = cls(int(chunk.shape[1]), nlist, m=m, **kw)
                if opq:
                    from cloudvectordb_tpu.index.opq import train_opq

                    ns0 = min(train_sample, chunk.shape[0], 65536)
                    r, _ = train_opq(np.asarray(chunk[:ns0]), m, idx.nbits,
                                     outer_iters=4, pq_iters=5, seed=idx.seed)
                    idx.opq_matrix = r
                rot = (jnp.asarray(idx.opq_matrix).T
                       if idx.opq_matrix is not None else None)
                tr = chunk @ rot if rot is not None else chunk
                ns = min(train_sample, tr.shape[0])
                c, _ = train_kmeans(tr[:ns], nlist, iters=idx.kmeans_iters,
                                    seed=idx.seed)
                c = np.asarray(c)
                idx.centroids = c[order_centroids(c)]
                cdev = jnp.asarray(idx.centroids)
                train_vecs = tr[:ns]
                if idx.residual:
                    a_s, _ = assign_clusters(train_vecs, cdev)
                    train_vecs = train_vecs - cdev[a_s]
                idx.codebooks = idx._train_pq_codebooks(train_vecs, tr[:ns])
                if idx.refine == "int8":
                    src = train_vecs if idx._refine_residual else tr
                    rms = float(jnp.sqrt(jnp.mean(src * src)))
                    amax = float(jnp.max(jnp.abs(src)))
                    idx._scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
                if idx._tier2_active:
                    idx._train_tier2(train_vecs, tr[:ns])
                if idx._host_active:
                    idx._set_host_scale(train_vecs)
            else:
                rot = (jnp.asarray(idx.opq_matrix).T
                       if idx.opq_matrix is not None else None)
                tr = chunk @ rot if rot is not None else chunk
            a, _ = assign_clusters(tr, cdev)
            assigns.append(np.asarray(a))
            sizes.append(int(chunk.shape[0]))
            chunk = tr = a = None  # free the ~GB-scale HBM refs per iter
        assert idx is not None, "empty stream"
        train_vecs = None  # pass-1 sample buffers must not outlive the loop
        assign_all = np.concatenate(assigns)
        n = assign_all.shape[0]
        order, offsets = arena_sort(assign_all.astype(np.int32), nlist)
        dest = np.empty(n, np.int64)
        dest[order] = np.arange(n)
        idx._offsets = offsets
        idx._n = n
        n_pad = idx._fit_tile_n_to_skew(n)
        idx._ids = order.astype(np.int64)
        idx._tile_window = idx._compute_tile_window()
        tw = idx._tile_window
        # ROW-major code arena (N_pad, m): HBM scatter aliases only on the
        # row axis — an axis-1 scatter into a code-major arena copies the
        # whole arena per chunk (two arena copies live at once). The
        # residual local byte lives in a SEPARATE (1, N_pad) array: a
        # 65-byte rows would no longer be exactly m bytes/row.
        # Past seg_rows_cap the arena is allocated as SEGMENTS (class doc),
        # each with a trailing zero pad tile that absorbs out-of-segment
        # scatter rows and is masked at query time.
        seg_rows, seg_offs = idx._seg_layout(n_pad)
        segmented = len(seg_rows) > 1
        if segmented:
            codes_rm = tuple(
                jnp.zeros((r + idx.tile_n, m), jnp.uint8) for r in seg_rows)
        else:
            codes_rm = jnp.zeros((n_pad, m), jnp.uint8)
        if idx.residual:
            _assert_w_fits(tw, "BandIVFPQIndex device build")
            row_tile = np.arange(n) // idx.tile_n
            local = (assign_all[order] - tw[row_tile, 0]).astype(np.uint8)
            loc_pad = np.zeros(n_pad, np.uint8)
            loc_pad[:n] = local
            if segmented:
                idx._local_rm = [
                    np.concatenate([loc_pad[off : off + r],
                                    np.zeros(idx.tile_n, np.uint8)])[None]
                    for r, off in zip(seg_rows, seg_offs)
                ]
            else:
                idx._local_rm = jnp.asarray(loc_pad[None])  # (1, N_pad)
            ct = np.ascontiguousarray(idx.centroids[tw])
            idx._centroid_tiles = (idx._seg_centroid_tiles(ct) if segmented
                                   else jnp.asarray(ct, jnp.bfloat16))
        else:
            idx._local_rm = None
            idx._centroid_tiles = None
        do_refine = idx.refine == "int8"
        do_pq2 = idx._tier2_active
        do_host = idx._host_active
        assert not (do_refine and segmented), (
            "int8 refine rows at segmented scale exceed HBM by construction"
            " — use refine='pq2' (in-HBM tier-2) or 'host' at this scale")
        refine = (jnp.zeros((n_pad, idx.dim), jnp.int8) if do_refine
                  else jnp.zeros((1, idx.dim), jnp.int8))
        # tier-2 codes keyed by GLOBAL id (= source row index): insertion-
        # order slots, gathered by gid at rescore — merge-invariant
        codes2 = jnp.zeros((n if do_pq2 else 1, idx.m2), jnp.uint8)
        need_s2 = do_pq2 and idx.metric == "l2"
        s2_ar = jnp.zeros((n if need_s2 else 1,), jnp.float32)
        if do_host:
            idx._host_rows = np.empty((n, idx.dim), np.int8)
            idx._host_assign = assign_all.astype(np.int32)
        cbdev = jnp.asarray(idx.codebooks)
        cb2dev = jnp.asarray(idx.codebooks2) if do_pq2 else None
        rot_dev = (jnp.asarray(idx.opq_matrix).T
                   if idx.opq_matrix is not None else None)
        resid = idx.residual
        scale = idx._scale if do_refine else 0.0
        host_scale = idx._host_scale

        import jax

        from cloudvectordb_tpu.index.pq import pq_decode, pq_encode

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def encode_scatter(codes_ar, refine_ar, chunk, d, a, c, cb):
            tr = chunk @ rot_dev if rot_dev is not None else chunk
            enc_in = tr - c[a] if resid else tr
            codes = idx._pq_encode_rows(enc_in, tr, cb)  # (b, m)
            if segmented:
                segs = []
                for si, (r, off) in enumerate(zip(seg_rows, seg_offs)):
                    in_seg = (d >= off) & (d < off + r)
                    # out-of-segment rows dump into the masked pad tile
                    d_s = jnp.where(in_seg, d - off, r)
                    segs.append(codes_ar[si].at[d_s].set(codes))
                codes_ar = tuple(segs)
            else:
                codes_ar = codes_ar.at[d].set(codes)
            if do_refine:
                rsrc = enc_in if idx._refine_residual else tr
                r8 = jnp.clip(jnp.round(rsrc / scale), -127, 127).astype(jnp.int8)
                refine_ar = refine_ar.at[d].set(r8)
            host_r8 = None
            if do_host:
                host_r8 = jnp.clip(jnp.round(enc_in / host_scale),
                                   -127, 127).astype(jnp.int8)
            return codes_ar, refine_ar, host_r8, codes

        # tier-2 encode runs as a SECOND jit per chunk (enc_in recomputed —
        # one matmul) so the pq_decode/err temps never coexist with the
        # tier-1 encode peak; sub-batched via lax.map to bound them (a fused
        # single jit holds the tier-1 arena, the tier-2 table and all temps
        # at once).
        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def tier2_scatter(codes2_ar, s2_a, chunk, codes_b, gid, a, c, cb,
                          cb2):
            def sub(args):
                ch_b, c_b, a_b = args
                tr = ch_b @ rot_dev if rot_dev is not None else ch_b
                enc = tr - c[a_b] if resid else tr
                dec1 = pq_decode(c_b, cb)
                err = enc - dec1
                c2 = pq_encode(err, cb2)
                if not need_s2:
                    return c2, jnp.zeros((c2.shape[0],), jnp.float32)
                # s₂ = 2·x̂₁·d₂ + ‖d₂‖² (l2 pq2 rescore — _encode_tier2 doc)
                d2 = pq_decode(c2, cb2)
                xh1 = dec1 + c[a_b] if resid else dec1
                return c2, (2.0 * jnp.sum(xh1 * d2, axis=1)
                            + jnp.sum(d2 * d2, axis=1))

            b = chunk.shape[0]
            nsub = 4 if b % 4 == 0 else 1
            c2, s2_b = jax.lax.map(sub, (chunk.reshape(nsub, b // nsub, -1),
                                         codes_b.reshape(nsub, b // nsub, m),
                                         a.reshape(nsub, b // nsub)))
            codes2_ar = codes2_ar.at[gid].set(c2.reshape(b, idx.m2))
            if need_s2:
                s2_a = s2_a.at[gid].set(s2_b.reshape(b))
            return codes2_ar, s2_a

        base = 0
        for ci in range(n_chunks):
            chunk = chunk_fn(ci)
            d = jnp.asarray(dest[base : base + sizes[ci]].astype(np.int32))
            a_dev = jnp.asarray(assigns[ci].astype(np.int32))
            codes_rm, refine, host_r8, codes_b = encode_scatter(
                codes_rm, refine, chunk, d, a_dev, cdev, cbdev)
            if do_pq2:
                gid = jnp.arange(base, base + sizes[ci], dtype=jnp.int32)
                codes2, s2_ar = tier2_scatter(codes2, s2_ar, chunk, codes_b,
                                              gid, a_dev, cdev, cbdev,
                                              cb2dev)
            if do_host:  # per-chunk host fetch (PCIe copy on real hardware)
                idx._host_rows[base : base + sizes[ci]] = np.asarray(host_r8)
            base += sizes[ci]
            chunk = d = a_dev = host_r8 = codes_b = None  # free HBM refs
        idx._codes_cm = list(codes_rm) if segmented else codes_rm
        idx._codes_row_major = True
        idx._payload = idx._codes_cm
        idx._refine_rows = refine
        idx._codes2 = codes2 if do_pq2 else None
        idx._s2 = s2_ar if need_s2 else None
        if not do_refine:
            idx._scale = 0.0
        # keep the gid-keyed assignments host-side (0.5 GB at 125M):
        # attach_host_refine reuses them so a post-hoc host tier never
        # re-runs coarse assignment
        idx._assign_gid = assign_all.astype(np.int32)
        idx._dev = None
        return idx

    def attach_host_refine(self, host_chunk_fn, n_chunks: int, *,
                           chunks_rotated: bool = False) -> None:
        """Attach the host-RAM exact-rescore tier from a HOST-side row
        source — rows never cross the device link.

        The natural production shape: corpus embeddings already live
        host-side (mmap'd shards, disk spools), so quantizing the refine
        rows there is free of link traffic, while shipping them device→host
        after a device-resident build moves dim bytes/row (96 GB at
        125M×768 — a ~10 s PCIe copy). Requires a device build
        that retained its gid-keyed assignments (_assign_gid); the OPQ
        rotation + residual + int8 quantization run here in numpy on the
        host chunks, which must be the SAME rows the index was built from
        (chunk sizes are validated; contents are trusted).

        After attach, refine='host': kernel candidates are exactly rescored
        from the host store (``_host_rescore``) — at 125M/chip this lifts
        recall@10 from the tier-2-ADC ceiling (~0.39) to the candidate
        recall of the shortlist (~0.77 at 5% coverage, measured).

        chunks_rotated=True: the chunks are ALREADY in the index's OPQ
        space and the 768×768 host rotation is skipped. Sources that can
        emit rotated rows directly (a generator whose final projection
        absorbed R — row-normalization commutes with an orthogonal R — or
        shards spooled post-rotation by the encode stage) save dim²·N host
        FLOPs: 147 TFLOP at 125M×768, hours on one core."""
        assert self._assign_gid is not None, (
            "attach_host_refine needs a build that kept assignments "
            "(build_device_streaming)")
        n = int(self._assign_gid.shape[0])
        # gid coverage — NOT ntotal: remove() shrinks ntotal but never
        # allocates ids, so a post-delete index still rescores correctly
        # from the gid-keyed store (stale entries cost bytes, not hits).
        assert self._gid_bound() <= n, (
            f"attach covers gids 0..{n - 1} but ids up to "
            f"{self._gid_bound() - 1} exist — attach BEFORE add()ing, or "
            "merge+rebuild; later gids would silently rescore against the "
            "wrong host rows")
        # same rotated space as every encode path: x' = x @ R.T
        rot = (np.asarray(self.opq_matrix, np.float32).T
               if self.opq_matrix is not None and not chunks_rotated
               else None)
        cent = np.asarray(self.centroids, np.float32)
        rows = np.empty((n, self.dim), np.int8)
        base = 0
        for ci in range(n_chunks):
            chunk = np.asarray(host_chunk_fn(ci), np.float32)
            b = chunk.shape[0]
            assert base + b <= n, "host chunks exceed built row count"
            tr = chunk @ rot if rot is not None else chunk
            enc = (tr - cent[self._assign_gid[base : base + b]]
                   if self.residual else tr)
            if ci == 0:
                rms = float(np.sqrt(np.mean(enc * enc)))
                amax = float(np.abs(enc).max())
                self._host_scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
            # np.round allocates; clip in place on ITS output only — `enc`
            # may alias the caller's chunk (residual=False, no OPQ)
            q8 = np.round(enc / self._host_scale)
            np.clip(q8, -127, 127, out=q8)
            rows[base : base + b] = q8.astype(np.int8)
            base += b
        assert base == n, f"host chunks cover {base} of {n} rows"
        self._host_rows = rows
        self._host_assign = self._assign_gid
        self._host_pending_rows = []
        self._host_pending_assign = []
        # a pq2 build keeps its in-HBM tier-2 table: the attach upgrades it
        # to the CASCADE (kernel → tier-2 narrows on-chip → host exact) —
        # the config-#5 endgame (class doc, 'pq2+host')
        self.refine = ("pq2+host" if self._tier2_active else "host")

    def _populate(self, vectors) -> None:
        vectors = jnp.asarray(vectors, jnp.float32)
        a, _ = assign_clusters(vectors, jnp.asarray(self.centroids))
        a_np = np.asarray(a)
        order = np.argsort(a_np, kind="stable")
        order_d = jnp.asarray(order)
        x = vectors[order_d]
        n = int(x.shape[0])
        counts = np.bincount(a_np, minlength=self.nlist)
        self._offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self._n = n
        n_pad = self._fit_tile_n_to_skew(n)
        self._tile_window = self._compute_tile_window()
        cdev = jnp.asarray(self.centroids)
        a_sorted = jnp.asarray(a_np[order])
        enc_in = x - cdev[a_sorted] if self.residual else x
        codes = self._pq_encode_rows(
            enc_in, x, jnp.asarray(self.codebooks))  # (N, m)
        rows_cm = self.m + (1 if self.residual else 0)
        codes_cm = jnp.zeros((rows_cm, n_pad), jnp.uint8).at[: self.m, :n].set(
            jnp.transpose(codes)
        )
        if self.residual:
            # per-row LOCAL list index within its tile (row m of the codes)
            tw = self._tile_window  # (n_tiles, W)
            row_tile = np.arange(n) // self.tile_n
            local = a_np[order] - tw[row_tile, 0]
            w = tw.shape[1]
            assert local.min() >= 0 and local.max() < w, (local.min(), local.max(), w)
            assert w <= 256, (
                f"per-tile window W={w} overflows the uint8 local code row "
                "— even at the tile_n floor this data packs >256 lists "
                "into one tile (anisotropic/cone data). Rebuild with a "
                "smaller nlist, or use BandIVFIndex (its tile-span cap "
                "pads skew away natively).")
            codes_cm = codes_cm.at[self.m, :n].set(
                jnp.asarray(local.astype(np.uint8))
            )
            # per-tile centroid matrices (n_tiles, W, D) — D minor
            ct = self.centroids[tw]  # (n_tiles, W, D)
            self._centroid_tiles = jnp.asarray(
                np.ascontiguousarray(ct), jnp.bfloat16
            )
        else:
            self._centroid_tiles = None
        if self.refine == "int8":
            # residual refine rows (when the PQ itself is residual): ~4×
            # finer at the same bytes; centroid term recovered at rescore
            src = enc_in if self._refine_residual else x
            rms = jnp.sqrt(jnp.mean(src * src))
            amax = jnp.max(jnp.abs(src))
            self._scale = float(
                jnp.maximum(jnp.minimum(amax, 4.0 * rms) / 127.0, 1e-12)
            )
            rr = jnp.clip(jnp.round(src / self._scale), -127, 127).astype(jnp.int8)
            self._refine_rows = jnp.concatenate(
                [rr, jnp.zeros((n_pad - n, self.dim), jnp.int8)]
            ) if n_pad != n else rr
        else:
            self._refine_rows = jnp.zeros((1, self.dim), jnp.int8)
            self._scale = 0.0
            if self._tier2_active:
                # tier-2 codes keyed by GLOBAL id: row i of enc_in (arena
                # order) is global id order[i]
                if self.metric == "l2":
                    c2_sorted, s2_sorted = self._encode_tier2(
                        enc_in, codes,
                        c_rows=cdev[a_sorted] if self.residual else None,
                        with_s2=True)
                    self._s2 = (jnp.zeros((n,), jnp.float32)
                                .at[jnp.asarray(order)].set(s2_sorted))
                else:
                    c2_sorted = self._encode_tier2(enc_in, codes)
                self._codes2 = (
                    jnp.zeros((n, self.m2), jnp.uint8)
                    .at[jnp.asarray(order)].set(c2_sorted))
            if self._host_active:
                if self._host_scale == 0.0:
                    self._set_host_scale(enc_in)
                r8 = np.asarray(jnp.clip(
                    jnp.round(enc_in / self._host_scale), -127, 127
                ).astype(jnp.int8))
                host = np.empty((n, self.dim), np.int8)
                host[order] = r8
                self._host_rows = host
                self._host_assign = a_np.astype(np.int32)
        self._codes_cm = codes_cm
        self._payload = codes_cm  # satisfies base-class bookkeeping
        self._ids = order.astype(np.int32)
        self._dev = None

    def add(self, vectors, ids: np.ndarray | None = None) -> None:
        """Incremental insert for the PQ arena: the batch is rotated (OPQ),
        assigned, residual-PQ-encoded and int8-quantized ON DEVICE; codes +
        int8 rows append to the pending store (scanned exactly at query
        time) and fold into the arena via one native re-sort past the
        threshold. Fixes the r1 crash where the inherited add() treated the
        code matrix as raw vector rows.

        ids: explicit global ids (sharded wrappers allocate across shards —
        parallel/dist_band_pq.py); must be ≥ the current bound."""
        vectors = jnp.asarray(vectors, jnp.float32)
        assert self.centroids is not None and self.codebooks is not None, (
            "build() trains the quantizers before add()"
        )
        rot = (jnp.asarray(self.opq_matrix).T
               if self.opq_matrix is not None else None)
        tr = vectors @ rot if rot is not None else vectors
        if self._n == 0 and self._pending.size == 0:
            assert ids is None, "explicit ids need a populated arena"
            self._populate(tr)
            return
        cdev = jnp.asarray(self.centroids)
        a, _ = assign_clusters(tr, cdev)
        enc_in = tr - cdev[a] if self.residual else tr
        codes = self._pq_encode_rows(enc_in, tr, jnp.asarray(self.codebooks))
        if self._pending_scale == 0.0:
            # whole-row refine ties pending to the arena refine scale (no
            # requantization at merge); residual refine and refine='none'
            # need a WHOLE-ROW scale here — the pending scan scores raw rows
            if self.refine == "int8" and not self._refine_residual:
                self._pending_scale = self._scale
            else:
                rms = float(jnp.sqrt(jnp.mean(tr * tr)))
                amax = float(jnp.max(jnp.abs(tr)))
                self._pending_scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
        rows8 = jnp.clip(
            jnp.round(tr / self._pending_scale), -127, 127
        ).astype(jnp.int8)
        b = int(vectors.shape[0])
        if ids is None:
            ids = self._alloc_ids(b)
        else:
            ids = np.asarray(ids, np.int64)
            lo = np.iinfo(np.int64).max
            assert ids.shape == (b,) and ids.min(initial=lo) >= self._gid_bound(), (
                "explicit ids must not collide with ever-allocated ids")
            if ((self._tier2_active and self.codebooks2 is not None)
                    or (self._host_active and self._host_scale > 0)):
                # gid-keyed tier stores append by POSITION — the invariant
                # 'table length == gid coverage' only holds for consecutive
                # allocation (sharded wrappers own their tiers instead and
                # run their shards with refine='none')
                assert (ids == np.arange(self._gid_bound(),
                                         self._gid_bound() + b)).all(), (
                    "explicit non-consecutive ids would misalign the "
                    "gid-keyed refine tier stores")
            self._next_id = max(self._gid_bound(),
                                int(ids.max(initial=-1)) + 1)
        # tier-2 stores are gid-keyed: sequential ids → in-order appends
        if self._tier2_active and self.codebooks2 is not None:
            if self.metric == "l2":
                c2_b, s2_b = self._encode_tier2(
                    enc_in, codes,
                    c_rows=cdev[a] if self.residual else None, with_s2=True)
                self._codes2_pending.append(np.asarray(c2_b))
                self._s2_pending.append(np.asarray(s2_b))
            else:
                self._codes2_pending.append(
                    np.asarray(self._encode_tier2(enc_in, codes)))
        if self._host_active and self._host_scale > 0:
            # gate on the SCALE, not _host_rows: after build_streaming the
            # whole store is still in _host_pending_rows (_host_rows None)
            # and gating on it silently dropped every add from the
            # gid-keyed store, misaligning all later appends (review, r3)
            self._host_pending_rows.append(np.asarray(jnp.clip(
                jnp.round(enc_in / self._host_scale), -127, 127
            ).astype(jnp.int8)))
            self._host_pending_assign.append(
                np.asarray(a).astype(np.int32))
        self._pending.append(np.asarray(rows8), ids, np.asarray(a))
        self._pending_codes.append(np.asarray(codes))
        self._pending_dev = None
        if self._pending.size > max(self.merge_threshold * self._n,
                                    4 * self.tile_n):
            self.merge_pending()

    def _pending_scan_scale(self) -> float:
        return self._pending_scale

    def _fold_pending(self) -> None:
        """The PQ family never folds into the device annex: the base annex
        carries only int8 rows at the BAND scale, while PQ pending rows
        ride with their PQ codes (same chunk order) at _pending_scale —
        an annex fold would orphan _pending_codes (corrupting the next
        merge_pending concat) and score annex rows under the wrong scale.
        Fold = the family's own compact merge."""
        self.merge_pending()

    def merge_pending(self) -> None:
        if self._pending.size == 0:
            return
        if self._tier2_active and self._codes2_pending:
            # pending rows become ARENA rows below; the serving path gathers
            # tier-2 codes for arena gids without folding (fold=False), so
            # their codes must land in the table here
            self._codes2_device()

        rows8, pids, passign = self._pending.drain()
        pcodes = np.concatenate(self._pending_codes)
        self._pending_codes = []
        self._pending_dev = None
        old_codes = self._codes_np_rows()[: self._n]
        old_assign = np.repeat(np.arange(self.nlist), np.diff(self._offsets))
        codes_all = np.concatenate([old_codes, pcodes.astype(np.uint8)])
        assigns = np.concatenate([old_assign, passign]).astype(np.int32)
        ids_all = np.concatenate([self._ids.astype(np.int64), pids])
        refine_all = None
        if self.refine == "int8":
            old_refine = np.asarray(self._refine_rows)[: self._n]
            if self._refine_residual:
                # pending rows are whole-row int8 at _pending_scale;
                # re-express as residuals at the arena's residual scale
                # (double quantization on merged adds only — bounded)
                resid_p = (rows8.astype(np.float32) * self._pending_scale
                           - self.centroids[passign])
                rows8_r = np.clip(np.round(resid_p / self._scale),
                                  -127, 127).astype(np.int8)
                refine_all = np.concatenate([old_refine, rows8_r])
            else:
                refine_all = np.concatenate([old_refine, rows8])
        self._reassemble(codes_all, ids_all, assigns, refine_all)

    def _reassemble(self, codes_all, ids_all, assigns, refine_all) -> None:
        """Re-sort (codes, ids[, refine rows]) by list assignment and
        reinstall the arena + every derived table — the shared tail of
        merge_pending and remove-compaction."""
        from cloudvectordb_tpu.utils.native import arena_sort, gather_rows

        order, offsets = arena_sort(assigns, self.nlist)
        n = codes_all.shape[0]
        n_pad = -(-n // self.tile_n) * self.tile_n
        if n_pad > self.seg_rows_cap and self.refine == "int8":
            # mirror build_device_streaming's guard: int8 refine rows past
            # the segment cap are ~21+ GB and the segmented refine gather is
            # unimplemented — fail loudly instead of corrupting the index
            raise NotImplementedError(
                f"index grew past seg_rows_cap ({self.seg_rows_cap} rows) "
                "with refine='int8' — refined indexes are bounded to one "
                "arena segment (use refine='none' at this scale, or shard)"
            )
        self._offsets = offsets
        self._n = n
        n_pad = self._fit_tile_n_to_skew(n)
        self._ids = ids_all[order]
        self._tile_window = self._compute_tile_window()
        sorted_codes = gather_rows(codes_all, order)
        local = None
        if self.residual:
            tw = self._tile_window
            _assert_w_fits(tw, "BandIVFPQIndex reassemble")
            row_tile = np.arange(n) // self.tile_n
            local = (assigns[order] - tw[row_tile, 0]).astype(np.uint8)
            ct = np.ascontiguousarray(self.centroids[tw])
            self._centroid_tiles = (
                self._seg_centroid_tiles(ct)
                if n_pad > self.seg_rows_cap
                else jnp.asarray(ct, jnp.bfloat16))
        if self.refine == "int8":
            rr = gather_rows(refine_all, order)
            if n_pad != n:
                rr = np.concatenate([rr, np.zeros((n_pad - n, self.dim), np.int8)])
            self._refine_rows = rr
        # scale-appropriate layout (col-major, or row-major segments)
        self._install_codes_host(sorted_codes, local)
        self._dev = None

    def remove(self, ids) -> int:
        """Delete rows by global id (returns the number removed; unknown
        ids ignored, freed ids never reused). The PQ scan masks validity
        with a per-segment row COUNT, not the per-tile-list valid_end table
        (ops/pq_scan.py), so holes can't stay in place — the code arena
        compacts via one filtered re-sort (_reassemble; O(N) host-side,
        codes are m bytes/row). Pending rows and their ride-along codes
        filter chunk-parallel. GID-KEYED side stores (tier-2 codes, host
        refine rows, _assign_gid) keep stale entries for removed ids — a
        removed gid can never surface as a kernel candidate, so stale rows
        cost bytes, not correctness. The residual-int8 BandIVFIndex family
        has the O(batch) in-place path; prefer it where deletes are hot."""
        from cloudvectordb_tpu.index.arena import normalize_remove_ids

        req = normalize_remove_ids(ids)
        if req.size == 0:
            return 0
        self._gid_bound()  # materialize BEFORE ids vanish: never reuse ids
        n_rem, masks = self._pending.remove_ids(req)
        if n_rem:
            self._pending_dev = None
            # _pending_codes chunks parallel the pending chunks 1:1 (add());
            # apply the same masks, dropping chunks that went empty
            self._pending_codes = [
                c if mk.all() else c[mk]
                for c, mk in zip(self._pending_codes, masks) if mk.any()
            ]
        if self._n:
            ids_arr = np.asarray(self._ids[: self._n], np.int64)
            slots = np.flatnonzero(np.isin(ids_arr, req))
            if slots.size:
                keep = np.ones(self._n, bool)
                keep[slots] = False
                if self._tier2_active and self._codes2_pending:
                    self._codes2_device()  # land pending tier-2 codes first
                codes = self._codes_np_rows()[: self._n][keep]
                assigns = np.repeat(
                    np.arange(self.nlist), np.diff(self._offsets)
                )[keep].astype(np.int32)
                refine_all = (np.asarray(self._refine_rows)[: self._n][keep]
                              if self.refine == "int8" else None)
                self._reassemble(codes, ids_arr[keep], assigns, refine_all)
                n_rem += int(slots.size)
        return n_rem

    def reconstruct(self, ids) -> np.ndarray:
        """Rows for the given global ids in ORIGINAL space: int8 refine rows
        when present (near-exact), else PQ decode; pending rows from the
        pending int8 store. Un-rotates OPQ output."""
        ids = np.asarray(ids)
        out = np.empty((ids.shape[0], self.dim), np.float32)
        pos = np.full(max(self._gid_bound(), 1), -1, np.int64)
        pos[np.asarray(self._ids, np.int64)] = np.arange(self._n)
        arena_mask = pos[ids] >= 0
        if arena_mask.any():
            rows = pos[ids[arena_mask]]
            if self.refine == "int8":
                rec = (np.asarray(self._refine_rows)[rows].astype(np.float32)
                       * self._scale)
                if self._refine_residual:  # rows store residuals
                    assign = (
                        np.searchsorted(self._offsets, rows, side="right") - 1
                    )
                    rec = rec + self.centroids[assign]
                out[arena_mask] = rec
            elif self._host_active and (self._host_rows is not None
                                        or self._host_pending_rows):
                # gid-keyed near-exact int8 store beats PQ decode (r3)
                rows_h, assign_h = self._host_store()
                g = ids[arena_mask]
                rec = rows_h[g].astype(np.float32) * self._host_scale
                if self.residual:  # rows store residuals
                    rec = rec + self.centroids[assign_h[g]]
                out[arena_mask] = rec
            else:
                if self._segmented:
                    rows_arr = np.asarray(rows)
                    codes = np.empty((rows_arr.shape[0], self.m), np.uint8)
                    seg_rows, seg_offs = self._seg_layout(self._n_pad_rows)
                    for si, (r, off) in enumerate(zip(seg_rows, seg_offs)):
                        msk = (rows_arr >= off) & (rows_arr < off + r)
                        if msk.any():  # device gather, small host fetch
                            codes[msk] = np.asarray(self._codes_cm[si][
                                jnp.asarray(rows_arr[msk] - off)])
                else:
                    cm = np.asarray(self._codes_cm)
                    codes = (cm[rows, : self.m] if self._codes_row_major
                             else cm[: self.m, rows].T)  # (r, m)
                cb = self.codebooks  # (m, C, dsub)
                dec = np.concatenate(
                    [cb[j][codes[:, j]] for j in range(self.m)], axis=1
                )
                if self.residual:
                    assign = (
                        np.searchsorted(self._offsets, rows, side="right") - 1
                    )
                    dec = dec + self.centroids[assign]
                out[arena_mask] = dec
        if (~arena_mask).any():
            snap = self._pending.snapshot()
            assert snap is not None, "id not in arena and no pending rows"
            p_rows, p_ids = snap
            ppos = np.full(max(self._gid_bound(), 1), -1, np.int64)
            ppos[p_ids] = np.arange(p_rows.shape[0])
            out[~arena_mask] = (
                p_rows[ppos[ids[~arena_mask]]].astype(np.float32)
                * self._pending_scale
            )
        if self.opq_matrix is not None:  # rotated → original space
            out = out @ self.opq_matrix
        return out

    def _fit_tile_n_to_skew(self, n: int) -> int:
        """Residual mode: shrink tile_n (halving, floor 256) until the
        per-tile window fits the uint8 local code row (W ≤ 256) on this
        data's list-size distribution, returning the padded row count for
        the final tile_n. Anisotropic (cone) data packs hundreds of tiny
        lists into one tile at the default tile_n (r5 — see the band
        family's ``_capacity_layout``); FEWER rows per tile span fewer
        lists. Zero cost / no-op on healthy data. Requires ``_offsets``
        and ``_n`` to be set. Data too skewed even at the floor still
        fails loudly via ``_assert_w_fits`` downstream. The halving rule
        and its floor are TPU-derived and not yet measured on the H100
        (ROADMAP C3)."""
        while True:
            n_pad = -(-n // self.tile_n) * self.tile_n
            self._n_pad_rows = n_pad
            if (not self.residual or self.tile_n <= 256
                    or self._compute_tile_window().shape[1] <= 256):
                return n_pad
            self.tile_n //= 2

    def _compute_tile_window(self) -> np.ndarray:
        n_rows = getattr(self, "_n_pad_rows", None)
        if n_rows is None:
            return super()._compute_tile_window()
        n_tiles = n_rows // self.tile_n
        starts = np.arange(n_tiles, dtype=np.int64) * self.tile_n
        ends = np.minimum(starts + self.tile_n - 1, max(self._n - 1, 0))
        fl = np.clip(np.searchsorted(self._offsets, starts, side="right") - 1,
                     0, self.nlist - 1)
        ll = np.clip(np.searchsorted(self._offsets, ends, side="right") - 1,
                     0, self.nlist - 1)
        w = int((ll - fl).max()) + 1 if n_tiles else 1
        window = np.minimum(fl[:, None] + np.arange(w)[None, :], ll[:, None])
        return np.clip(window, 0, self.nlist - 1).astype(np.int32)

    def _device_state(self):
        if self._dev is None:
            seg = self._segmented
            self._dev = dict(
                codes=(tuple(jnp.asarray(s) for s in self._codes_cm)
                       if seg else jnp.asarray(self._codes_cm)),
                centroids=jnp.asarray(self.centroids),
                codebooks=jnp.asarray(self.codebooks),
                refine=jnp.asarray(self._refine_rows),
                ids=jnp.asarray(self._ids, jnp.int32),
                tile_window=jnp.asarray(self._tile_window),
                centroid_tiles=(
                    (tuple(jnp.asarray(c, jnp.bfloat16)
                           for c in self._centroid_tiles) if seg
                     else jnp.asarray(self._centroid_tiles, jnp.bfloat16))
                    if self._centroid_tiles is not None else None
                ),
                local_rm=(
                    (tuple(jnp.asarray(l) for l in self._local_rm)
                     if seg else jnp.asarray(self._local_rm))
                    if getattr(self, "_local_rm", None) is not None
                    else None),
            )
        return self._dev

    def _mask_pad_rows(self) -> int:
        return self._n_pad_rows  # _payload is the code matrix, not rows

    def _split_row_mask(self, rm):
        """Segmented arenas take the filter mask as per-segment slices,
        each with the trailing pad tile zeroed (disallowed); the cached
        form is scan-ready (see ops/pq_scan.py segment dispatch)."""
        if not self._segmented:
            return rm
        ok = rm[0]
        parts, t_off = [], 0
        for seg in self._device_state()["codes"]:
            seg_tiles = seg.shape[0] // self.tile_n - 1  # minus pad tile
            sl = ok[t_off * self.tile_n : (t_off + seg_tiles) * self.tile_n]
            parts.append(jnp.concatenate(
                [sl, jnp.zeros((self.tile_n,), jnp.int8)])[None, :])
            t_off += seg_tiles
        return tuple(parts)

    def _refine_scan_state(self):
        """Device aux for serving DIRECTLY from the residual-int8 refine
        arena (serve_from='refine'): the refine rows share the code arena's
        layout (arena-ordered, same offsets), so the residual tiles kernel
        (ops/pallas_band.py) can scan them with a per-tile-list valid_end
        mask — no per-candidate gather at all."""
        assert self.refine == "int8" and self._refine_residual, (
            "serve_from='refine' needs residual-int8 refine rows")
        assert not self._segmented, "refined indexes are single-segment"
        st = self._device_state()
        if "refine_local" not in st:
            lens = np.diff(self._offsets)
            tw = self._tile_window
            ve = (self._offsets[:-1][tw] + lens[tw]).astype(np.int32)
            st["refine_valid_end"] = jnp.asarray(ve)
            if self._codes_row_major:
                st["refine_local"] = st["local_rm"]
            else:
                st["refine_local"] = st["codes"][self.m][None, :]
        return st

    # -- op-point tuning (eval/tune.py) -----------------------------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        """When residual-int8 refine rows are resident, the direct refine
        scan dominates the PQ path on BOTH axes (search() doc) — its ladder
        goes first. Otherwise walk the PQ path over coverage × refine depth
        (deep refine_factor needs pools — auto via n_pools=0)."""
        can_refine_scan = (self.refine == "int8" and self._refine_residual
                           and not self._segmented)
        n_tiles = self._tune_n_tiles()
        out = []
        for tq in self._tune_tile_qs(nq):
            base = self._auto_p_tiles(nq, 32, n_tiles, tile_q=tq)
            for mult in (1.0, 1.5, 2.5, 4.0, 7.0, 12.0):
                p = min(n_tiles, max(32, int(base * mult) // 32 * 32))
                if can_refine_scan:
                    out.append({"p_tiles": p, "tile_q": tq,
                                "serve_from": "refine"})
                elif self.refine == "pq2+host":
                    # cascade ladder: deep kernel candidate sets (tier-2
                    # ranks them on-chip) × PCIe shortlist width
                    for rf in (64, 205, 410, 820):
                        for hf in (32, 102):
                            cfg = {"p_tiles": p, "tile_q": tq,
                                   "refine_factor": rf, "host_factor": hf}
                            out.append(cfg)
                            if rf >= 205:  # shadowing binds at depth
                                out.append({**cfg, "top2": True})
                else:
                    two_stage = self.refine in ("int8", "pq2", "host")
                    for rf in ((16, 64, 102) if two_stage else (None,)):
                        cfg = {"p_tiles": p, "tile_q": tq}
                        if rf is not None:
                            cfg["refine_factor"] = rf
                        out.append(cfg)
                        if rf is not None and rf >= 64:
                            # top2 only widens the k_cand cap now that
                            # the PQ scan is exact (ROADMAP C7)
                            out.append({**cfg, "top2": True})
                if p >= n_tiles:
                    break
        seen = set()
        out = [c for c in out
               if (key := tuple(sorted(c.items()))) not in seen
               and not seen.add(key)]
        out.sort(key=lambda c: (c["p_tiles"]
                                * (1 + c.get("refine_factor", 0) / 256.0)
                                * (1 + c.get("host_factor", 0) / 512.0)
                                * (1.02 if c.get("top2") else 1.0),
                                -c["tile_q"]))
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        n_tiles = self._tune_n_tiles()
        if (self.refine == "int8" and self._refine_residual
                and not self._segmented):
            return {"p_tiles": n_tiles, "serve_from": "refine"}
        kw = {"p_tiles": n_tiles}
        if self.refine in ("int8", "pq2", "host"):
            kw["refine_factor"] = 102  # ~1024 candidates at k=10
        elif self.refine == "pq2+host":
            kw["refine_factor"] = 820  # cascade: deep on-chip candidates,
            kw["host_factor"] = 102    # wide PCIe shortlist as reference
        return kw

    def _resolve_pq_knobs(self, nq, nprobe, p_tiles, tile_q, refine_factor,
                          n_pools, serve_from, top2=None, host_factor=None):
        """Shared knob resolution for the PQ host and device search paths
        (the twin of _resolve_tiles_knobs): tuned op-point fills for
        sentinel values, small-batch query-tile shrink, span-aware auto
        coverage. host_factor sizes the CASCADE shortlist
        (refine='pq2+host'): k_host = k·host_factor rows cross PCIe after
        the on-chip tier-2 narrowing."""
        op = self._op_point or {}
        if serve_from is None:
            serve_from = op.get("serve_from", "pq")
        if refine_factor is None:
            refine_factor = op.get("refine_factor", 16)
        if host_factor is None:
            host_factor = op.get("host_factor", 64)
        if p_tiles <= 0:
            p_tiles = op.get("p_tiles", 0)
        if tile_q is None:
            tile_q = op.get("tile_q")
        if n_pools <= 0:
            n_pools = op.get("n_pools", 0)
        if top2 is None:
            top2 = bool(op.get("top2", False))
        tq = tile_q or self.tile_q
        if tile_q is None and nq < tq:
            tq = max(8, _next_pow2(nq))  # small-batch: see _search_tiles
        if p_tiles <= 0:
            n_tiles = self._n_pad_rows // self.tile_n
            p_tiles = self._auto_p_tiles(nq, nprobe, n_tiles, tile_q=tq)
        return (serve_from, refine_factor, p_tiles, tq, n_pools, top2,
                host_factor)

    def _pq_stage_plan(self, k, refine_factor, n_pools, tq, p_tiles,
                       top2=False):
        """Candidate-budget derivation shared by search()/search_device():
        (two_stage, k_cand, n_pools, l_buckets, k_stage1). two_stage is
        true when a populated refine tier will rescore the kernel's
        candidate set downstream. n_pools, top2 and l_buckets size the
        k_cand cap the way the former bucketed kernel did; the exact PQ
        scan has no pools (ROADMAP C7)."""
        two_stage = (self.refine == "int8"
                     or (self._tier2_active
                         and self.codebooks2 is not None
                         and (self._codes2 is not None
                              or bool(self._codes2_pending)))
                     or (self._host_active
                         and (self._host_rows is not None
                              or bool(self._host_pending_rows))))
        k_cand = min(max(k * refine_factor, 32), self._n) if two_stage else k
        # candidate budget of the former bucketed kernel; the plain scan's
        # exact top-k only uses it to cap k_cand (ROADMAP C7)
        slot_budget = max(min(262_144 // tq, 8192), self.tile_n)
        mult = 2 if top2 else 1
        if n_pools <= 0:
            n_pools = max(1, min(-(-k_cand // (mult * self.tile_n)),
                                 max(slot_budget // (mult * self.tile_n), 1),
                                 p_tiles))
        l_buckets = self._derive_l_buckets(k_cand, mult * n_pools)
        k_cand = min(k_cand, mult * n_pools * l_buckets)
        # for 'pq2'/'host' the kernel stage returns the k_cand-candidate
        # set (tier-1 scores, refine_scale 0) for the tier-2 rescore below
        k_stage1 = k if self.refine == "int8" else (k_cand if two_stage
                                                    else k)
        return two_stage, k_cand, n_pools, l_buckets, k_stage1

    def _host_tier_rescore(self, qp_dev, v, gids, k, l2, centroids_dev):
        """Host-RAM exact rescore of the current candidate set (v, gids):
        gathers the shortlist's int8 rows from the gid-keyed host store
        (the only PCIe traffic of the search) and reranks to k. Shared by
        refine='host' (full kernel candidate set) and the 'pq2+host'
        cascade (tier-2-narrowed shortlist)."""
        host_rows, host_assign = self._host_store()
        gids_h = np.asarray(gids)
        g = np.clip(gids_h, 0, host_rows.shape[0] - 1)
        r8 = host_rows[g]                # host RAM gather (shortlist)
        assign = host_assign[g].astype(np.int32)
        x_sq = (jnp.asarray(self._host_row_sq()[g])
                if l2 and self.residual else None)
        return _host_rescore(
            qp_dev, jnp.asarray(np.asarray(v)), jnp.asarray(gids_h),
            jnp.asarray(r8), jnp.asarray(assign), centroids_dev,
            jnp.float32(self._host_scale), x_sq, k=k,
            resid=self.residual, l2=l2)

    def search(self, queries, k: int, nprobe: int = 32, interpret: bool = False,
               p_tiles: int = 0, refine_factor: int | None = None,
               n_pools: int = 0, tile_q: int | None = None,
               serve_from: str | None = None, where=None,
               top2: bool | None = None, host_factor: int | None = None,
               **_):
        """The PQ scan (ops/pq_scan.py) keeps an exact top-k_cand over the
        planned tiles; n_pools and top2 only size the k_cand cap
        (ROADMAP C7).

        tile_q overrides the index's query-tile size for THIS search (new
        value → one extra compile). Smaller tiles make the shared
        tile table per-group more specific — the lever for small/diverse
        batches (see _auto_p_tiles; measured at 2M, B=512: tile_q 128→32
        lifts recall 0.57→0.93 at the same scanned-tile count).

        serve_from='refine' (r3, residual-int8 refine only): score the
        REFINE arena directly with the residual tiles kernel instead of
        PQ-decode + per-candidate gather-rescore. The direct scan costs
        768 int8 MACs per scanned row per query vs a codebook decode plus
        a bf16 dot for PQ — whenever the int8 rows fit in HBM (≤ ~16M rows/chip at
        768-d) the direct scan is BOTH more accurate (no PQ candidate
        ceiling) and ~10–50× faster. PQ codes remain the memory format for
        scales where refine rows cannot fit (config #5).

        metric='l2' + serve_from='pq': the kernel's −‖x̂‖²/2 bias uses the
        PQ reconstruction's norm, whose error at small m scatters candidate
        keys more than the IP form — size refine_factor generously (on-chip
        at 200k×256/m=16 with 6× norm spread: candidate recall 0.60 at
        k_cand=320 vs 0.91 at 1280; IP reaches 0.87 at 320). Where the
        refine arena fits, serve_from='refine' has no such loss (0.95 at
        the same op point, measured r3)."""
        assert self._n, "empty index"
        queries = np.asarray(queries, np.float32)
        if self.opq_matrix is not None:
            queries = queries @ self.opq_matrix.T
        nq = queries.shape[0]
        flt = self.make_filter(where) if where is not None else None
        (serve_from, refine_factor, p_tiles, tq, n_pools, top2,
         host_factor) = self._resolve_pq_knobs(
            nq, nprobe, p_tiles, tile_q, refine_factor, n_pools, serve_from,
            top2, host_factor)
        q_pad = -(-nq // tq) * tq
        qp = queries if q_pad == nq else np.concatenate(
            [queries, np.repeat(queries[-1:], q_pad - nq, axis=0)])
        l2 = self.metric == "l2"
        if serve_from == "refine":
            st = self._refine_scan_state()
            v, gids = _tiles_resid_plan_search(
                jnp.asarray(qp), st["centroids"], st["refine"],
                st["refine_local"], self._scale,
                st["ids"], st["tile_window"], st["refine_valid_end"],
                row_mask=(self._arena_row_mask(flt) if flt is not None
                          else None),
                k=k, p_tiles=p_tiles, tile_n=self.tile_n, tile_q=tq,
                impl=scan_impl(interpret), l2=l2,
            )
            v = np.asarray(v)[:nq]
            gids = np.asarray(gids)[:nq].astype(np.int64)
            return self._merge_pending_topk(v, gids, queries[:nq], k,
                                            flt=flt)
        st = self._device_state()
        two_stage, k_cand, n_pools, l_buckets, k_stage1 = \
            self._pq_stage_plan(k, refine_factor, n_pools, tq, p_tiles, top2)
        nv = (self._seg_n_valid() if self._segmented
              else jnp.asarray(self._n, jnp.int32))
        qp_dev = jnp.asarray(qp)
        v, gids = _pq_tiles_plan_search(
            qp_dev, st["centroids"], st["codes"], st["codebooks"],
            st["refine"], st["ids"], st["tile_window"], st["centroid_tiles"],
            nv, st.get("local_rm"),
            row_mask=(self._arena_row_mask(flt) if flt is not None
                      else None),
            k=k_stage1, k_cand=k_cand, p_tiles=p_tiles, tile_n=self.tile_n,
            tile_q=tq,
            refine_scale=self._scale if self.refine == "int8" else 0.0,
            row_major=self._codes_row_major,
            refine_residual=self._refine_residual, l2=l2,
        )
        if two_stage and self._tier2_active and self.codebooks2 is not None:
            # cascade ('pq2+host' with a host store attached): tier-2 keeps
            # a k·host_factor shortlist on-chip; only those rows cross PCIe
            have_host = (self._host_active
                         and (self._host_rows is not None
                              or bool(self._host_pending_rows)))
            k_mid = (min(max(k * host_factor, k), k_cand) if have_host
                     else k)
            v, gids = _pq2_rescore(
                qp_dev, v, gids, self._codes2_device(fold=False),
                self._codebooks2_device(),
                self._s2_device() if l2 else None, k=k_mid, l2=l2)
            if have_host:
                v, gids = self._host_tier_rescore(qp_dev, v, gids, k, l2,
                                                  st["centroids"])
        elif two_stage and self._host_active:
            v, gids = self._host_tier_rescore(qp_dev, v, gids, k, l2,
                                              st["centroids"])
        v, gids = np.asarray(v)[:nq], np.asarray(gids)[:nq].astype(np.int64)
        # pending rows live in rotated space; `queries` is already rotated
        return self._merge_pending_topk(v, gids, queries[:nq], k)

    def _opq_device(self):
        """Rotation cached on device: uploading the 768² f32 matrix per
        call would cost ~2.3 MB of host link each search_device."""
        if self.opq_matrix is None:
            return None
        if getattr(self, "_opq_dev", None) is None:
            self._opq_dev = jnp.asarray(self.opq_matrix)
        return self._opq_dev

    def _codebooks2_device(self):
        """Tier-2 codebooks cached on device (identity-keyed — train/load
        replace the numpy table): the pq2 rescore runs per search call and
        must not re-ship the table over the host link each time."""
        if (getattr(self, "_cb2_dev_src", None) is not self.codebooks2
                or self._cb2_dev_src is None):
            self._cb2_dev = jnp.asarray(self.codebooks2)
            self._cb2_dev_src = self.codebooks2
        return self._cb2_dev

    def search_device(self, queries, k: int, nprobe: int = 32,
                      p_tiles: int = 0, refine_factor: int | None = None,
                      n_pools: int = 0, tile_q: int | None = None,
                      serve_from: str | None = None,
                      interpret: bool = False, where=None,
                      top2: bool | None = None):
        """All-device twin of ``search()`` (semantics documented there and
        on BandIVFIndex.search_device): device queries in, device
        (scores f32, ids i32) out, zero per-call host work. Supports
        serve_from='refine' and the PQ path including the in-HBM 'pq2'
        tier; refine='host' is inherently host-attached — use search().
        """
        assert self._n, "empty index"
        queries = jnp.asarray(queries, jnp.float32)
        rot = self._opq_device()
        if rot is not None:
            # HIGHEST: a default GPU f32 matmul runs in TF32 — enough for
            # recall (int8 scoring noise dominates) but the low-bit query
            # drift reorders rank ties vs search()'s host-side np rotation.
            # HIGHEST keeps the two paths equal to f32 rounding; exact id
            # parity on ties is still only guaranteed within one path.
            queries = jnp.dot(queries, rot.T,
                              precision=jax.lax.Precision.HIGHEST)
        nq = queries.shape[0]
        flt = self.make_filter(where) if where is not None else None
        (serve_from, refine_factor, p_tiles, tq, n_pools, top2,
         _hf) = self._resolve_pq_knobs(
            nq, nprobe, p_tiles, tile_q, refine_factor, n_pools, serve_from,
            top2)
        q_pad = -(-nq // tq) * tq
        qp = queries if q_pad == nq else jnp.concatenate(
            [queries, jnp.repeat(queries[-1:], q_pad - nq, axis=0)])
        l2 = self.metric == "l2"
        if serve_from == "refine":
            st = self._refine_scan_state()
            v, gids = _tiles_resid_plan_search(
                qp, st["centroids"], st["refine"], st["refine_local"],
                self._scale, st["ids"],
                st["tile_window"], st["refine_valid_end"],
                row_mask=(self._arena_row_mask(flt) if flt is not None
                      else None),
                k=k, p_tiles=p_tiles, tile_n=self.tile_n, tile_q=tq,
                impl=scan_impl(interpret), l2=l2,
            )
            return self._merge_pending_topk_device(v[:nq], gids[:nq],
                                                   queries, k, flt=flt)
        st = self._device_state()
        two_stage, k_cand, n_pools, l_buckets, k_stage1 = \
            self._pq_stage_plan(k, refine_factor, n_pools, tq, p_tiles, top2)
        assert not (two_stage and self._host_active
                    and not (self._tier2_active
                             and self.codebooks2 is not None)), (
            "refine='host' rescores from host RAM — use search()")
        # 'pq2+host' device twin serves the ON-CHIP cascade prefix (kernel
        # + tier-2): exact host rescore is inherently host-attached
        nv = (self._seg_n_valid() if self._segmented
              else jnp.asarray(self._n, jnp.int32))
        v, gids = _pq_tiles_plan_search(
            qp, st["centroids"], st["codes"], st["codebooks"],
            st["refine"], st["ids"], st["tile_window"],
            st["centroid_tiles"], nv, st.get("local_rm"),
            row_mask=(self._arena_row_mask(flt) if flt is not None
                      else None),
            k=k_stage1, k_cand=k_cand, p_tiles=p_tiles, tile_n=self.tile_n,
            tile_q=tq,
            refine_scale=self._scale if self.refine == "int8" else 0.0,
            row_major=self._codes_row_major,
            refine_residual=self._refine_residual, l2=l2,
        )
        if two_stage and self._tier2_active and self.codebooks2 is not None:
            v, gids = _pq2_rescore(
                qp, v, gids, self._codes2_device(fold=False),
                self._codebooks2_device(),
                self._s2_device() if l2 else None, k=k, l2=l2)
        return self._merge_pending_topk_device(v[:nq], gids[:nq], queries, k)

    # -- persistence ------------------------------------------------------
    def _state_arrays(self):
        self.merge_pending()
        out = {
            "centroids": self.centroids,
            "codebooks": self.codebooks,
            # segmented arenas persist as one row-major matrix; load
            # re-segments past seg_rows_cap
            "codes_cm": (self._codes_np_rows() if self._segmented
                         else _fetch_chunked(self._codes_cm)),
            "ids": self._ids,
            "offsets": self._offsets,
        }
        if self.refine == "int8":
            out["refine_rows"] = _fetch_chunked(self._refine_rows)
        if self._tier2_active and (self._codes2 is not None
                                   or self._codes2_pending):
            out["codes2"] = np.asarray(self._codes2_device())
            out["codebooks2"] = self.codebooks2
            if self.metric == "l2":
                out["s2"] = np.asarray(self._s2_device())
        if self._host_active and (self._host_rows is not None
                                  or self._host_pending_rows):
            rows_h, assign_h = self._host_store()
            out["host_rows"] = rows_h
            out["host_assign"] = assign_h
        if self.opq_matrix is not None:
            out["opq_matrix"] = np.asarray(self.opq_matrix)
        return out

    def _state_meta(self):
        meta = self._state_meta_common()
        meta.update({"m": self.m, "nbits": self.nbits, "refine": self.refine,
                     "pq_train_iters": self.pq_train_iters,
                     "n_pad_rows": self._n_pad_rows,
                     "residual": self.residual,
                     "aniso_eta": self.aniso_eta,
                     "refine_residual": self._refine_residual,
                     "codes_row_major": self._codes_row_major,
                     "m2": self.m2, "nbits2": self.nbits2,
                     "host_scale": self._host_scale})
        return meta

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict) -> "BandIVFPQIndex":
        m = manifest["meta"]
        idx = cls(manifest["dim"], m["nlist"], m["m"], m["nbits"], m["refine"],
                  m["pq_train_iters"], m["kmeans_iters"], m["seed"],
                  m["tile_n"], m["tile_q"], residual=m.get("residual", False),
                  aniso_eta=m.get("aniso_eta", 0.0),
                  m2=m.get("m2", 32), nbits2=m.get("nbits2", 8),
                  metric=manifest.get("metric", "ip"))
        # older manifests carry whole-row refine rows regardless of mode
        idx._refine_residual = m.get("refine_residual", False)
        idx._host_scale = m.get("host_scale", 0.0)
        if "codes2" in arrays:
            idx._codes2 = np.asarray(arrays["codes2"])
            idx.codebooks2 = np.asarray(arrays["codebooks2"])
            if "s2" in arrays:
                idx._s2 = np.asarray(arrays["s2"])
        if "host_rows" in arrays:
            idx._host_rows = np.asarray(arrays["host_rows"])
            idx._host_assign = np.array(arrays["host_assign"], np.int32,
                                        copy=True)
        idx.centroids = np.asarray(arrays["centroids"])
        idx.codebooks = np.asarray(arrays["codebooks"])
        idx._codes_cm = np.asarray(arrays["codes_cm"])
        idx._codes_row_major = m.get("codes_row_major", False)
        idx._payload = idx._codes_cm
        idx._ids = np.asarray(arrays["ids"])
        idx._offsets = np.asarray(arrays["offsets"])
        idx._scale = m["scale"]
        idx._n = m["n"]
        idx._n_pad_rows = m["n_pad_rows"]
        idx._next_id = m.get("next_id", 0)  # 0: derive lazily (_gid_bound)
        idx._refine_rows = (
            np.asarray(arrays["refine_rows"]) if "refine_rows" in arrays
            else np.zeros((1, manifest["dim"]), np.int8)
        )
        if "opq_matrix" in arrays:
            idx.opq_matrix = np.asarray(arrays["opq_matrix"])
        idx._tile_window = idx._compute_tile_window()
        local = None
        if idx.residual and idx._codes_row_major:
            # local byte derives from offsets
            assigns_sorted = np.repeat(np.arange(idx.nlist),
                                       np.diff(idx._offsets))
            row_tile = np.arange(idx._n) // idx.tile_n
            local = (assigns_sorted
                     - idx._tile_window[row_tile, 0]).astype(np.uint8)
        if (idx._codes_row_major
                and idx._n_pad_rows > idx.seg_rows_cap):
            # saved as one row-major matrix; re-segment past the cap
            idx._install_codes_host(
                np.asarray(idx._codes_cm)[: idx._n], local)
        elif idx.residual and idx._codes_row_major:
            loc_pad = np.zeros(idx._n_pad_rows, np.uint8)
            loc_pad[: idx._n] = local
            idx._local_rm = loc_pad[None]
        if idx.residual:
            ct = np.ascontiguousarray(idx.centroids[idx._tile_window])
            idx._centroid_tiles = (
                idx._seg_centroid_tiles(ct) if idx._segmented
                else jnp.asarray(ct, jnp.bfloat16))
        return idx
