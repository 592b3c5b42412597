"""Tile-pruned IVF scan: centroid ordering, the Hopper tile-scan kernel
and its plain-XLA form.

Scheme (index/ivf_band.py drives it):
  1. (build time) Relabel coarse centroids along a locality order
     (``order_centroids``) and lay the arena out list by list, so each
     fixed-size arena tile spans few lists.
  2. (query time, XLA) sort queries by their top-1 list, group them
     ``tile_q`` at a time, and pick each group's ``p_tiles`` best arena
     tiles (``_plan_tiles``) — one shared tile table per group.
  3. (scan) score every row of a group's tiles against the group's queries
     and keep the best rows.

Two implementations of step 3 live here, chosen by ``ops/backend.py``:

  - ``impl="triton"`` — one Pallas kernel compiled through Triton for the
    GPU. A block owns up to ``_BQ`` queries of one group and a contiguous
    slice of that group's tile list; it loops over the slice inside the
    block (blocks run in parallel and in no order), reading its own tile
    ids from the table. The slice count is chosen so the grid holds about
    ``_FILL_BLOCKS`` blocks. Per ``_BN``-row chunk the block forms the
    score tile in registers and inserts every score that beats its
    running k-th best into an exact per-query top-K (K = k rounded up to a
    power of two, at least 16), so neither the gathered tiles nor the
    score matrix ever reach HBM. Each block writes its K candidates per
    query and one ``lax.top_k`` over the slices finishes.
    ``impl="interpret"`` runs the same kernel in the Pallas interpreter
    (CPU tests).
  - ``impl="xla"`` — gather the group's tiles, score them with one
    ``dot_general`` and take ``lax.top_k``. This is the plain reference,
    and the implementation on backends without Triton.

Both are exact over the planned tiles. With ``candidates=True`` the plain
form returns the kernel's per-slice top-K instead of the final top-k —
what the kernel parity checks compare against.

Residual-int8 arenas (``tiles_topk_resid``) hold int8 RESIDUALS (row − its
list centroid). The centroid term q·c is not recomputed: the planner's
(Q, nlist) q·centroid dots are gathered by each row's list id, which is
``tile_window[tile, local_id]``; the per-row valid end (tail padding and
slack holes) is gathered the same way.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

NEG_INF = float("-inf")

#: query rows per kernel block: one 64-row warpgroup MMA tile.
_BQ = 64
#: arena rows per inner chunk, and candidate lanes per block.
_BN = 128
#: feature-axis chunk of each MMA (int8 MMA needs K ≥ 32). f32 operands
#: stop at 64: three pipeline stages of (64 + 128) × 128 f32 need 288 KiB
#: of shared memory, past the H100's 227 KiB per block (measured refusal).
_BK_CHOICES = (128, 64, 32)
_BK_MAX_F32 = 64
#: target grid size: about two resident blocks on each of an H100's 132 SMs.
_FILL_BLOCKS = 264
#: Triton launch shape for the scan kernel.
_NUM_WARPS = 8
_NUM_STAGES = 3


def order_centroids(centroids: np.ndarray) -> np.ndarray:
    """Locality-preserving centroid permutation: recursive balanced 2-means.

    A 1-D projection (PC1, space-filling curve) cannot localize 768-d probe
    sets (measured: bands/unions degenerate to the whole arena). The
    hierarchical ordering puts genuinely similar centroids at adjacent ids at
    EVERY scale — a query's nprobe nearest lists then concentrate in a small
    id range, so query tiles (sorted by top-1 id) share small tile unions.
    """
    c = np.asarray(centroids, np.float64)
    rng = np.random.default_rng(0)

    def rec(idx: np.ndarray) -> list[int]:
        if len(idx) <= 2:
            return idx.tolist()
        sub = c[idx]
        # 2-means direction (few Lloyd rounds), then a balanced median split
        picks = rng.choice(len(idx), 2, replace=False)
        c0, c1 = sub[picks[0]].copy(), sub[picks[1]].copy()
        for _ in range(6):
            d0 = ((sub - c0) ** 2).sum(1)
            d1 = ((sub - c1) ** 2).sum(1)
            m = d0 <= d1
            if m.any():
                c0 = sub[m].mean(0)
            if (~m).any():
                c1 = sub[~m].mean(0)
        proj = sub @ (c1 - c0)
        order = np.argsort(proj, kind="stable")
        half = len(idx) // 2
        return rec(idx[order[:half]]) + rec(idx[order[half:]])

    return np.asarray(rec(np.arange(len(c))), dtype=np.int64)


# -- shapes ------------------------------------------------------------------

def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _feature_chunk(d: int, f32: bool = False) -> tuple[int, int]:
    """(chunk, padded d): the largest MMA K-chunk dividing d; dims that no
    chunk divides are zero-padded to a multiple of 32 (inner products are
    unchanged). Serving dims (768, 384, 128, 96) never pad."""
    for bk in _BK_CHOICES:
        if d % bk == 0 and not (f32 and bk > _BK_MAX_F32):
            return bk, d
    return 32, _ceil_to(d, 32)


def _pad_features(x, d_pad: int):
    d = x.shape[-1]
    if d == d_pad:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, d_pad - d)])


def _keep(k: int) -> int:
    """Per-block top-K width: k rounded up to a power of two, ≥ 16."""
    return max(16, 1 << max(k - 1, 0).bit_length())


def _scan_geometry(nq: int, tile_q: int, tile_n: int, p: int, keep: int):
    """(bq, bn, n_split, per): query rows and arena rows per block chunk,
    the number of tile-list slices per group and the tiles per slice.
    Deep top-Ks (range search) trade query rows for register room."""
    bq = max(16, min(_BQ, tile_q, 4096 // keep))
    bn = min(_BN, tile_n)
    assert tile_q % bq == 0 and tile_n % bn == 0, (tile_q, tile_n)
    n_qb = nq // bq
    want = max(1, -(-_FILL_BLOCKS // n_qb))
    per = -(-p // min(p, want))
    n_split = -(-p // per)  # every slice non-empty
    return bq, bn, n_split, per


def _widen_groups(x, tile_q: int, rows: int):
    """(n_qt·tile_q, ...) → (n_qt·rows, ...): zero rows appended to every
    query group. Kernel blocks need ≥16 query rows; tiny groups (B=4
    latency batches) grow to 16 and shrink back after the scan."""
    n_qt = x.shape[0] // tile_q
    g = x.reshape((n_qt, tile_q) + x.shape[1:])
    g = jnp.pad(g, [(0, 0), (0, rows - tile_q)] + [(0, 0)] * (x.ndim - 1))
    return g.reshape((n_qt * rows,) + x.shape[1:])


def _narrow_groups(x, tile_q: int, rows: int):
    n_qt = x.shape[0] // rows
    return x.reshape((n_qt, rows) + x.shape[1:])[:, :tile_q].reshape(
        (n_qt * tile_q,) + x.shape[1:])


# -- the Triton kernel ---------------------------------------------------------

def _scan_kernel(*refs, tile_n, tile_q, bq, bn, bk, n_k, per, p, w, nlist,
                 keep, dot, resid, masked, l2):
    """One block: queries [qb·bq, +bq) × tiles table[g, s·per : s·per+per).

    dot: 'int8' (int8 × int8 → int32 MMA), 'bf16' (bf16 × bf16, int8 rows
    widened exactly) or 'f32' (f32 × f32, IEEE). resid: residual-int8 rows
    (centroid term gathered from qc, per-row valid end from ve); otherwise
    rows < n_valid are live and scores are the raw dots."""
    rl = list(refs)
    tt_ref, q_ref, db_ref = rl[0], rl[1], rl[2]
    rl = rl[3:]
    if resid:
        local_ref, tw_ref, ve_ref, qc_ref, rs_ref = rl[:5]
        rl = rl[5:]
    else:
        nv_ref = rl.pop(0)
    mask_ref = rl.pop(0) if masked else None
    if l2:
        cent_ref, csq_ref, s_ref = rl[:3]
        rl = rl[3:]
    out_v_ref, out_i_ref = rl

    qb = pl.program_id(0)
    sp = pl.program_id(1)
    q0 = qb * bq
    grp = lax.div(q0, tile_q)  # lax.div/rem: jnp's floor forms don't lower
    lo = sp * per
    hi = jnp.minimum(lo + per, p)
    n_c = tile_n // bn
    lane = lax.broadcasted_iota(jnp.int32, (bn,), 0)
    acc_t = jnp.int32 if dot == "int8" else jnp.float32

    def chunk(it, carry):
        t = tt_ref[grp, lo + lax.div(it, n_c)]
        row0 = t * tile_n + lax.rem(it, n_c) * bn

        def kstep(kk, kc):
            a = q_ref[pl.ds(q0, bq), pl.ds(kk * bk, bk)]
            b = db_ref[pl.ds(row0, bn), pl.ds(kk * bk, bk)]
            r32 = b.astype(jnp.float32) if l2 else None
            if dot == "bf16":
                b = b.astype(jnp.bfloat16)
            # f32 operands: HIGHEST selects IEEE f32 (DEFAULT lowers to TF32)
            acc = kc[0] + lax.dot_general(
                a, b, (((1,), (1,)), ((), ())), preferred_element_type=acc_t,
                precision=lax.Precision.HIGHEST if dot == "f32" else None)
            if not l2:
                return (acc,)
            c = cent_ref[lists[:, None] * (n_k * bk)
                         + (kk * bk + lax.broadcasted_iota(
                             jnp.int32, (bn, bk), 1))]
            return (acc, kc[1] + jnp.sum(r32 * r32, axis=1),
                    kc[2] + jnp.sum(c * r32, axis=1))

        rows = row0 + lane
        if resid:
            loc = local_ref[pl.ds(row0, bn)].astype(jnp.int32)
            lists = tw_ref[t * w + loc]
            live = rows < ve_ref[t * w + loc]
        else:
            lists = None
            live = rows < nv_ref[0]
        init = (jnp.zeros((bq, bn), acc_t),)
        if l2:
            init += (jnp.zeros((bn,), jnp.float32),) * 2
        kc = lax.fori_loop(0, n_k, kstep, init)
        score = kc[0].astype(jnp.float32)
        if resid:
            qrow = q0 + lax.broadcasted_iota(jnp.int32, (bq, bn), 0)
            score = (qc_ref[qrow * nlist + lists[None, :]]
                     + rs_ref[pl.ds(q0, bq)][:, None] * score)
            if l2:
                s = s_ref[0]
                bias = (-0.5 * s * s) * kc[1] - s * kc[2] - 0.5 * csq_ref[lists]
                score = score + bias[None, :]
        if masked:
            live = jnp.logical_and(live, mask_ref[pl.ds(row0, bn)] != 0)
        score = jnp.where(live[None, :], score, NEG_INF)

        # exact top-K insertion: while any score beats its query's current
        # K-th best, move each query's best remaining score into its worst
        # slot. After the first chunks almost every chunk exits at once.
        def beats(c):
            tv, _, sc = c
            hit = (sc > jnp.min(tv, axis=1)[:, None]).astype(jnp.int32)
            return jnp.max(hit) > 0  # no reduce_or in the Triton lowering

        def insert(c):
            tv, ti, sc = c
            worst = jnp.min(tv, axis=1)
            slot = jnp.argmin(tv, axis=1)
            best = jnp.max(sc, axis=1)
            at = jnp.argmax(sc, axis=1)
            put = jnp.logical_and((best > worst)[:, None],
                                  kslot[None, :] == slot[:, None])
            tv = jnp.where(put, best[:, None], tv)
            ti = jnp.where(put, (row0 + at)[:, None], ti)
            sc = jnp.where(lane[None, :] == at[:, None], NEG_INF, sc)
            return tv, ti, sc

        tv, ti, _ = lax.while_loop(beats, insert, (carry[0], carry[1], score))
        return tv, ti

    kslot = lax.broadcasted_iota(jnp.int32, (keep,), 0)
    state = (jnp.full((bq, keep), NEG_INF, jnp.float32),
             jnp.zeros((bq, keep), jnp.int32))
    tv, ti = lax.fori_loop(0, (hi - lo) * n_c, chunk, state)
    cols = pl.ds(sp * keep, keep)
    out_v_ref[pl.ds(q0, bq), cols] = tv
    out_i_ref[pl.ds(q0, bq), cols] = ti


def _run_scan(q, db, tile_table, extra, *, k, tile_n, tile_q, dot, resid,
              masked, l2, w, nlist, interpret):
    """pallas_call plumbing shared by both arena families; returns the
    (Q, n_split·K) candidate scores and arena rows."""
    from jax.experimental.pallas import triton as plgpu

    nq, d = q.shape
    p = tile_table.shape[1]
    bk, d_pad = _feature_chunk(d, f32=dot == "f32")
    assert d_pad == d, "callers pad the feature axis"
    keep = _keep(k)
    bq, bn, n_split, per = _scan_geometry(nq, tile_q, tile_n, p, keep)
    width = n_split * keep
    kernel = functools.partial(
        _scan_kernel, tile_n=tile_n, tile_q=tile_q, bq=bq, bn=bn, bk=bk,
        n_k=d // bk, per=per, p=p, w=w, nlist=nlist, keep=keep, dot=dot,
        resid=resid, masked=masked, l2=l2)
    return pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((nq, width), jnp.float32),
                   jax.ShapeDtypeStruct((nq, width), jnp.int32)],
        grid=(nq // bq, n_split),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        interpret=interpret,
        name="tile_scan",
    )(tile_table.astype(jnp.int32), q, db, *extra)


# -- the plain-XLA form --------------------------------------------------------

def _group_scores(qg, tt_row, db, *, tile_n, dot, score_fn):
    """Scores of one query group against its tiles: (tq, P·tile_n) and the
    arena row of each column. score_fn(score, rows) applies the family's
    centroid term, bias and validity."""
    rows = (tt_row[:, None] * tile_n
            + jnp.arange(tile_n, dtype=jnp.int32)[None, :]).reshape(-1)
    r = db[rows]
    if dot == "int8":
        s = lax.dot_general(qg, r, (((1,), (1,)), ((), ())),
                            preferred_element_type=jnp.int32)
    else:
        s = lax.dot_general(
            qg, r.astype(qg.dtype), (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST)
    return score_fn(s.astype(jnp.float32), rows, r), rows


def _xla_scan(q, db, tile_table, *, k, tile_n, tile_q, dot, score_fn,
              per_group=(), slices=None):
    """lax.map over query groups (bounded temps): exact top-k per query,
    or (slices=(n_split, per)) the kernel's per-slice top-K
    candidates."""
    n_qt = tile_table.shape[0]
    d = q.shape[1]

    def body(args):
        qg, tt_row, *pg = args
        s, rows = _group_scores(
            qg, tt_row, db, tile_n=tile_n, dot=dot,
            score_fn=lambda sc, rw, r: score_fn(sc, rw, r, *pg))
        if slices is None:
            v, pos = lax.top_k(s, min(k, s.shape[1]))
            return v, rows[pos]
        return _slice_topk(s, rows, p=tt_row.shape[0], keep=_keep(k),
                           slices=slices)

    xs = (q.reshape(n_qt, tile_q, d), tile_table) + tuple(
        a.reshape((n_qt, tile_q) + a.shape[1:]) for a in per_group)
    v, i = lax.map(body, xs)
    return v.reshape(n_qt * tile_q, -1), i.reshape(n_qt * tile_q, -1)


def _slice_topk(s, rows, *, p, keep, slices):
    """The kernel's output in plain form: each (query, slice) keeps its
    exact top-K; empty slots hold (-inf, row 0)."""
    n_split, per = slices
    tq = s.shape[0]
    tile_n = s.shape[1] // p
    pad = (n_split * per - p) * tile_n
    s = jnp.pad(s, ((0, 0), (0, pad)), constant_values=NEG_INF)
    r = jnp.pad(rows, (0, pad))
    v, pos = lax.top_k(s.reshape(tq, n_split, per * tile_n), keep)
    i = r.reshape(n_split, per * tile_n)[jnp.arange(n_split)[None, :, None],
                                         pos]
    i = jnp.where(v > NEG_INF, i, 0)
    return v.reshape(tq, -1), i.reshape(tq, -1)


def _ref_slices(nq, k, tile_q, tile_n, tile_table, candidates):
    """The kernel's slice geometry (after _widen_groups), or None for the
    final top-k."""
    if not candidates:
        return None
    rows = max(16, tile_q)
    _, _, n_split, per = _scan_geometry(nq // tile_q * rows, rows, tile_n,
                                        tile_table.shape[1], _keep(k))
    return n_split, per


def _finish(v, i, k, scanned):
    """Final top-k over the blocks' candidates; never wider than the rows
    the plan scanned (the plain form's width)."""
    kk = min(k, v.shape[1], scanned)
    top_v, pos = lax.top_k(v, kk)
    return top_v, jnp.take_along_axis(i, pos, axis=1)


def _plain_inputs(db, queries_sorted, int8):
    """(dot kind, query operand) of the whole-row families."""
    if int8 == "hybrid":
        return "bf16", queries_sorted.astype(jnp.bfloat16)
    if int8:
        return "int8", queries_sorted.astype(jnp.int8)
    if db.dtype == jnp.float32:
        return "f32", queries_sorted.astype(jnp.float32)
    return "bf16", queries_sorted.astype(db.dtype)


def _prepare(q, db, tile_q):
    """Pad the feature axis to a chunk multiple and tiny query groups to
    16 rows (see _widen_groups); returns (q, db, rows per group)."""
    _, d_pad = _feature_chunk(q.shape[1])
    q, db = _pad_features(q, d_pad), _pad_features(db, d_pad)
    rows = max(16, tile_q)
    if rows != tile_q:
        q = _widen_groups(q, tile_q, rows)
    return q, db, rows


@functools.partial(
    jax.jit,
    static_argnames=("k", "tile_n", "tile_q", "int8", "impl", "candidates"),
)
def tiles_topk(
    db,
    queries_sorted,
    tile_table,  # (n_qt, P) i32 arena-tile ids
    k: int,
    *,
    tile_n: int,
    tile_q: int,
    int8=False,  # True: int8 queries (callers quantize); 'hybrid': bf16
                 # queries × int8 rows; False: rows' own float dtype
    impl: str,
    n_valid=None,  # true row count (traced scalar ok); pad rows masked out
    candidates: bool = False,  # see tiles_topk_resid
):
    """Top-k over each query group's tiles of a whole-row arena.

    Returns (raw dot scores (Q, k) f32, arena rows (Q, k) i32); callers
    apply their quantization scales. ``n_valid`` is the number of REAL rows
    in ``db`` (rows ≥ n_valid are zero padding to a tile_n multiple and
    must never become candidates: int8 pads score 0, which can outrank
    real negatives). Traced, so add()-driven count changes don't
    recompile."""
    n = db.shape[0]
    assert n % tile_n == 0 and queries_sorted.shape[0] % tile_q == 0
    nv = jnp.asarray(n if n_valid is None else n_valid, jnp.int32)
    dot, q = _plain_inputs(db, queries_sorted, int8)

    if impl == "xla":
        def score_fn(s, rows, r):
            return jnp.where((rows < nv)[None, :], s, NEG_INF)

        return _xla_scan(q, db, tile_table, k=k, tile_n=tile_n,
                         tile_q=tile_q, dot=dot, score_fn=score_fn,
                         slices=_ref_slices(q.shape[0], k, tile_q, tile_n,
                                            tile_table, candidates))
    q, db, rows = _prepare(q, db, tile_q)
    v, i = _run_scan(q, db, tile_table, [nv.reshape(1)], k=k, tile_n=tile_n,
                     tile_q=rows, dot=dot, resid=False, masked=False,
                     l2=False, w=0, nlist=0, interpret=impl == "interpret")
    if rows != tile_q:
        v, i = _narrow_groups(v, tile_q, rows), _narrow_groups(i, tile_q, rows)
    if candidates:
        return v, i
    return _finish(v, i, k, tile_table.shape[1] * tile_n)


def _resid_operands(queries_sorted, resid_scale, int8_q):
    """Query operand and per-query score scale of the residual scan: int8_q
    quantizes each query to int8 (scale folded with the residual scale);
    otherwise bf16 queries × int8 rows."""
    qf = queries_sorted.astype(jnp.float32)
    s = jnp.asarray(resid_scale, jnp.float32)
    if int8_q:
        q_amax = jnp.maximum(jnp.max(jnp.abs(qf), axis=1), 1e-12)
        q8 = jnp.clip(jnp.round(qf * (127.0 / q_amax)[:, None]),
                      -127, 127).astype(jnp.int8)
        return "int8", q8, (q_amax / 127.0) * s
    return "bf16", qf.astype(jnp.bfloat16), jnp.full(qf.shape[:1], s)


def _resid_score_fn(local_ids, tile_window, valid_end, tile_n, row_mask,
                    l2, centroids, resid_scale):
    """Plain-form residual scoring: mirrors the kernel's arithmetic."""
    w = tile_window.shape[1]

    def score_fn(s, rows, r, qc_g, rs_g):
        t = rows // tile_n
        loc = local_ids[0, rows].astype(jnp.int32)
        lists = tile_window.reshape(-1)[t * w + loc]
        live = rows < valid_end.reshape(-1)[t * w + loc]
        if row_mask is not None:
            live = jnp.logical_and(live, row_mask[0, rows] != 0)
        score = jnp.take(qc_g, lists, axis=1) + rs_g[:, None] * s
        if l2:
            sc = jnp.asarray(resid_scale, jnp.float32)
            r32 = r.astype(jnp.float32)
            c = centroids[lists]
            cr = jnp.sum(c * r32[:, : c.shape[1]], axis=1)
            bias = ((-0.5 * sc * sc) * jnp.sum(r32 * r32, axis=1) - sc * cr
                    - 0.5 * jnp.sum(c * c, axis=1))
            score = score + bias[None, :]
        return jnp.where(live[None, :], score, NEG_INF)

    return score_fn


@functools.partial(
    jax.jit,
    static_argnames=("k", "tile_n", "tile_q", "impl", "int8_q", "l2",
                     "candidates"),
)
def tiles_topk_resid(
    db_resid,        # (N_pad, D) int8 residual rows
    local_ids,       # (1, N_pad) uint8: per-row local list idx within tile
    tile_window,     # (n_tiles, W) i32: global list id of each local idx
    valid_end,       # (n_tiles, W) i32: one past each tile-list's last VALID
                     # arena row — masks tail padding AND interior slack
                     # holes left for in-place inserts
    qc_sorted,       # (Q, nlist) f32 q·centroid dots, in sorted query order
    resid_scale,     # () f32 residual dequant scale
    queries_sorted,  # (Q, D) f32/bf16 pre-sorted queries
    tile_table,      # (n_qt, P) i32
    k: int,
    *,
    tile_n: int,
    tile_q: int,
    impl: str,
    int8_q: bool = True,  # residual dot on int8 tensor cores (else bf16)
    row_mask=None,   # (1, N_pad) int8 arena-order allow bits (filtered
                     # search) — None compiles the unmasked kernel
    l2: bool = False,  # L2 metric: ranking key q·x̂ − ‖x̂‖²/2, x̂ = c + s·r;
                       # scores return as the key, callers convert to
                       # −‖q−x̂‖² with their own ‖q‖²
    centroids=None,  # (nlist, D) f32: the l2 bias's c·r and ‖c‖² terms
    candidates: bool = False,  # return the kernel's per-slice top-K
                               # (kernel parity checks) instead of top-k
):
    """Top-k over residual-int8 arena tiles: score = q·c_list(row) +
    s·(q·r_row), with the centroid term gathered from ``qc_sorted``."""
    n, d = db_resid.shape
    nq = queries_sorted.shape[0]
    assert n % tile_n == 0 and nq % tile_q == 0
    assert not l2 or centroids is not None
    dot, q, rs = _resid_operands(queries_sorted, resid_scale, int8_q)
    if impl == "xla":
        fn = _resid_score_fn(local_ids, tile_window, valid_end, tile_n,
                             row_mask, l2, centroids, resid_scale)
        return _xla_scan(q, db_resid, tile_table, k=k, tile_n=tile_n,
                         tile_q=tile_q, dot=dot, score_fn=fn,
                         per_group=(qc_sorted.astype(jnp.float32), rs),
                         slices=_ref_slices(nq, k, tile_q, tile_n,
                                            tile_table, candidates))

    q, db, rows = _prepare(q, db_resid, tile_q)
    qc = qc_sorted.astype(jnp.float32)
    if rows != tile_q:
        qc = _widen_groups(qc, tile_q, rows)
        rs = _widen_groups(rs, tile_q, rows)
    extra = [local_ids.reshape(-1), tile_window.astype(jnp.int32).reshape(-1),
             valid_end.astype(jnp.int32).reshape(-1), qc.reshape(-1), rs]
    if row_mask is not None:
        extra.append(row_mask.astype(jnp.int8).reshape(-1))
    if l2:
        c = centroids.astype(jnp.float32)
        extra += [_pad_features(c, q.shape[1]).reshape(-1),
                  jnp.sum(c * c, axis=1),
                  jnp.asarray(resid_scale, jnp.float32).reshape(1)]
    v, i = _run_scan(q, db, tile_table, extra, k=k, tile_n=tile_n,
                     tile_q=rows, dot=dot, resid=True,
                     masked=row_mask is not None, l2=l2,
                     w=int(tile_window.shape[1]),
                     nlist=int(qc_sorted.shape[1]),
                     interpret=impl == "interpret")
    if rows != tile_q:
        v, i = _narrow_groups(v, tile_q, rows), _narrow_groups(i, tile_q, rows)
    if candidates:
        return v, i
    return _finish(v, i, k, tile_table.shape[1] * tile_n)


