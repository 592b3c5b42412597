"""IVF-PQ: coarse quantizer + per-list PQ codes (BASELINE config #3/#4).

Residual encoding: each vector is stored as PQ codes of (x - centroid[list]),
recovering most of the coarse quantizer's resolution. At query time, the
probe-scan exploits that every row in a probe shares one list: the centroid
term of the score is a per-(query, probe) constant, and only the residual part
needs the PQ lookup (SURVEY.md §3.5).

Scoring inside a probe is classic ADC — per-query LUT (m, 2**nbits) built with
one small matmul, then code lookups. The tile-pruned PQ family
(index/ivf_band.py::BandIVFPQIndex, ops/pq_scan.py) is the batched
alternative.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from cloudvectordb_tpu.index.arena import (ListArena, PendingBuffer,
                                            grow_scatter_gid)
from cloudvectordb_tpu.index.base import Index
from cloudvectordb_tpu.index.kmeans import train_kmeans
from cloudvectordb_tpu.index.pq import pq_encode, train_pq, _split
from cloudvectordb_tpu.ops.assign import assign_clusters
from cloudvectordb_tpu.ops.topk import NEG_INF, merge_topk, tiled_topk


def _build_luts(q, codebooks, metric: str):
    """Per-query ADC lookup tables.

    q (B, D); codebooks (m, C, dsub) → luts (B, m, C):
      metric='ip':  lut[b,j,c] = q_j[b]·cb[j,c]
      metric='l2':  lut[b,j,c] = -||q_j[b] - cb[j,c]||² (larger better)
    For residual indexes, q here is the *residual query* handled by the caller
    via the constant probe term; these luts always act on the stored codes.
    """
    m, c, dsub = codebooks.shape
    qs = _split(q, m)  # (m, B, dsub)
    dots = jnp.einsum("mbd,mcd->bmc", qs, codebooks, preferred_element_type=jnp.float32)
    if metric == "ip":
        return dots
    q_sq = jnp.sum(qs.astype(jnp.float32) ** 2, axis=2)  # (m, B)
    c_sq = jnp.sum(codebooks.astype(jnp.float32) ** 2, axis=2)  # (m, C)
    return 2.0 * dots - jnp.transpose(q_sq)[:, :, None] - c_sq[None, :, :]


@functools.partial(
    jax.jit, static_argnames=("k", "nprobe", "cap", "metric", "residual")
)
def _ivfpq_scan_search(
    q, centroids, codes, offsets, lens, codebooks,
    *, k, nprobe, cap, metric, residual,
):
    """Probe-scan ADC search. codes (N, m) uint8; returns (B,k) scores and
    ARENA ROW positions (callers map rows → global ids; the refine stage
    needs rows to recover each candidate's list for the centroid term).

    Probe SELECTION always ranks centroids by L2 — the metric that assigned
    vectors to lists. Ranking by IP mis-probes badly when centroid norms vary
    (measured: recall 0.28 → 0.9+ on clustered data after this fix). The IP
    coarse value is still used as the constant term of residual-IP scores.

    Residual score decomposition:
      ip: q·x = q·c_l + q·r̂            (constant + LUT part)
      l2: -||q-x||² = -||q-c_l||² + 2 q·r̂ - 2 c_l·r̂ - ||r̂||²
    """
    bq = q.shape[0]
    m = codebooks.shape[0]
    _, probe_lists = tiled_topk(
        centroids, q, nprobe, metric="l2", tile=min(8192, centroids.shape[0])
    )
    probed_c = centroids[probe_lists]  # (B, nprobe, D)
    if metric == "ip":
        coarse_s = jnp.einsum(
            "bd,bpd->bp", q.astype(jnp.float32), probed_c.astype(jnp.float32)
        )
    else:
        diff = q[:, None, :].astype(jnp.float32) - probed_c.astype(jnp.float32)
        coarse_s = -jnp.sum(diff * diff, axis=2)
    luts_ip = _build_luts(q, codebooks, "ip")  # (B, m, C) q·r lookups
    c_sq_codes = jnp.sum(codebooks.astype(jnp.float32) ** 2, axis=2)  # (m, C)
    window = jnp.arange(cap, dtype=jnp.int32)
    probed_centroids = probed_c  # residual cross terms need the centroids

    def probe_step(carry, inp):
        best_v, best_i = carry
        p_start, p_len, p_coarse, p_cent = inp  # (B,), (B,), (B,), (B, D)
        rows = p_start[:, None] + window[None, :]
        valid = window[None, :] < p_len[:, None]
        rows_c = jnp.clip(rows, 0, codes.shape[0] - 1)
        c_tile = codes[rows_c].astype(jnp.int32)  # (B, cap, m)
        # gather ADC: sum_j lut[b, j, code]
        lut_b = luts_ip  # (B, m, C)
        picked = jnp.take_along_axis(
            jnp.transpose(lut_b, (0, 2, 1)),  # (B, C, m)
            c_tile,
            axis=1,
        )  # (B, cap, m)
        q_dot_r = jnp.sum(picked, axis=2)  # (B, cap) = q·r̂
        if residual:
            # r̂ norms and centroid·r̂ cross terms
            if metric == "ip":
                s = p_coarse[:, None] + q_dot_r
            else:
                # -||q - c - r̂||² = -||q-c||² + 2(q-c)·r̂ - ||r̂||²
                #                = coarse_l2 + 2 q·r̂ - 2 c·r̂ - ||r̂||²
                r_sq = jnp.sum(
                    jnp.take_along_axis(
                        jnp.transpose(c_sq_codes)[None], c_tile, axis=1
                    ),
                    axis=2,
                )  # (B, cap) Σ_j ||cb_j[code]||² = ||r̂||²
                cent_luts = _build_luts(p_cent, codebooks, "ip")  # (B, m, C)
                c_dot_r = jnp.sum(
                    jnp.take_along_axis(
                        jnp.transpose(cent_luts, (0, 2, 1)), c_tile, axis=1
                    ),
                    axis=2,
                )
                s = p_coarse[:, None] + 2.0 * q_dot_r - 2.0 * c_dot_r - r_sq
        else:
            if metric == "ip":
                s = q_dot_r
            else:
                r_sq = jnp.sum(
                    jnp.take_along_axis(
                        jnp.transpose(c_sq_codes)[None], c_tile, axis=1
                    ),
                    axis=2,
                )
                q_sq = jnp.sum(q.astype(jnp.float32) ** 2, axis=1)
                s = 2.0 * q_dot_r - r_sq - q_sq[:, None]
        s = jnp.where(valid, s, NEG_INF)
        kk = min(k, cap)
        tv, tp = lax.top_k(s, kk)
        trows = jnp.take_along_axis(rows_c, tp, axis=1)
        if kk < k:
            pad = k - kk
            tv = jnp.concatenate([tv, jnp.full((bq, pad), NEG_INF)], axis=1)
            trows = jnp.concatenate(
                [trows, jnp.zeros((bq, pad), trows.dtype)], axis=1)
        return merge_topk(best_v, best_i, tv, trows, k), None

    starts = offsets[probe_lists]
    ll = lens[probe_lists]
    init = (jnp.full((bq, k), NEG_INF, jnp.float32), jnp.zeros((bq, k), jnp.int32))
    xs = (
        starts.T,
        ll.T,
        coarse_s.T,
        jnp.transpose(probed_centroids, (1, 0, 2)),
    )
    (best_v, best_i), _ = lax.scan(probe_step, init, xs)
    return best_v, best_i


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "refine_residual")
)
def _refine_rescore(
    q_rot, q_raw, v, rows, ids, refine_rows, centroids, offsets_full,
    refine_scale,
    *, k, metric, refine_residual,
):
    """Exact int8 rescore of scan candidates (probe-scan family, r3 port of
    the band family's residual refine — ivf_band._pq_tiles_plan_search).

    rows (B, k_cand) are ARENA positions; the refine store is keyed by
    GLOBAL id (ids[row]) so it survives arena re-sorts without a permute.
    refine_residual: rows hold int8 residuals in ROTATED space — the exact
    centroid term rides q·centroids (one small matmul) gathered per
    candidate through its list (searchsorted over the arena offsets).
    Whole-row mode scores UNrotated rows against the raw queries."""
    NEG = NEG_INF
    valid = v > NEG
    rows_c = jnp.clip(rows, 0, ids.shape[0] - 1)
    gid = jnp.clip(ids[rows_c], 0, refine_rows.shape[0] - 1)
    r8 = refine_rows[gid].astype(jnp.float32) * refine_scale  # (B, kc, D)
    if refine_residual:
        assign = jnp.clip(
            jnp.searchsorted(offsets_full, rows_c, side="right") - 1,
            0, centroids.shape[0] - 1)
        if metric == "ip":
            dots = jax.lax.dot_general(
                q_rot, centroids, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)
            ex = (jnp.einsum("bd,brd->br", q_rot, r8)
                  + jnp.take_along_axis(dots, assign, axis=1))
        else:
            xhat = centroids[assign] + r8
            diff = q_rot[:, None, :] - xhat
            ex = -jnp.sum(diff * diff, axis=2)
    else:
        if metric == "ip":
            ex = jnp.einsum("bd,brd->br", q_raw, r8)
        else:
            diff = q_raw[:, None, :] - r8
            ex = -jnp.sum(diff * diff, axis=2)
    ex = jnp.where(valid, ex, NEG)
    v2, pos = lax.top_k(ex, k)
    return v2, jnp.take_along_axis(rows_c, pos, axis=1)


class IVFPQIndex(Index):
    kind = "ivf_pq"

    def __init__(
        self,
        dim: int,
        nlist: int,
        m: int = 64,
        nbits: int = 8,
        metric: str = "ip",
        residual: bool = True,
        kmeans_iters: int = 20,
        pq_train_iters: int = 12,
        seed: int = 0,
        opq_matrix: np.ndarray | None = None,
        refine: str = "none",
    ):
        assert metric in ("ip", "l2")
        assert refine in ("none", "int8")
        assert dim % m == 0
        self.dim = dim
        self.metric = metric
        self.nlist = nlist
        self.m = m
        self.nbits = nbits
        self.residual = residual
        self.kmeans_iters = kmeans_iters
        self.pq_train_iters = pq_train_iters
        self.seed = seed
        self.centroids: np.ndarray | None = None
        self.codebooks: np.ndarray | None = None
        self.opq_matrix = opq_matrix  # (D, D) rotation applied before PQ
        self._arena = ListArena(nlist, m, np.uint8)
        self._pending = PendingBuffer(m, np.uint8)
        # refinement: compact exact-ish representation for re-ranking the
        # ADC top-R — PQ recall@10 is reconstruction-limited; a second-stage
        # int8 rescore recovers it (BASELINE configs #3/#4 memory budgets
        # allow int8 raw; 1B-scale (#5) runs PQ-only or sharded).
        #
        # Residual refine (r3, ported from the band family): when the PQ is
        # residual-encoded, refine rows store int8 RESIDUALS (x_rot − its
        # list centroid) — same bytes, ~3–4× finer quantization — and the
        # exact centroid term q·c_list is added back at rescore from a full
        # q·centroids matrix (one small matmul + a scalar gather). Measured
        # on the band family at 10M×768: whole-row int8 rescoring ceilings
        # recall at 0.860; residual rows reach 0.875+ at the same cost.
        self.refine = refine
        self._refine_residual = residual and refine == "int8"
        self._refine_rows = np.zeros((0, dim), np.int8)
        self._refine_scale = 1e-12
        self._next_id = 0
        self._dev = None

    @property
    def ntotal(self) -> int:
        return self._arena.size + self._pending.size

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None and self.codebooks is not None

    def _rotate(self, x: np.ndarray) -> np.ndarray:
        if self.opq_matrix is None:
            return x
        return x @ self.opq_matrix.T  # rows are rotated: x' = R x

    def train(self, sample) -> None:
        sample = np.asarray(sample, np.float32)
        if self.opq_matrix is not None:
            sample = self._rotate(sample)
        c, assign = train_kmeans(
            jnp.asarray(sample), self.nlist, iters=self.kmeans_iters, seed=self.seed
        )
        self.centroids = np.asarray(c)
        train_vecs = jnp.asarray(sample)
        if self.residual:
            train_vecs = train_vecs - c[assign]
        cb = train_pq(
            train_vecs, self.m, self.nbits, iters=self.pq_train_iters, seed=self.seed
        )
        self.codebooks = np.asarray(cb)
        self._dev = None

    @classmethod
    def build(
        cls, vectors, nlist: int, m: int = 64, metric: str = "ip",
        train_sample: int = 262_144, **kw,
    ) -> "IVFPQIndex":
        vectors = np.asarray(vectors, np.float32)
        idx = cls(vectors.shape[1], nlist, m=m, metric=metric, **kw)
        ns = min(train_sample, vectors.shape[0])
        rs = np.random.default_rng(idx.seed).choice(vectors.shape[0], ns, replace=False)
        idx.train(vectors[rs])
        idx.add(vectors)
        idx.merge_pending()
        return idx

    def add(self, vectors, ids=None) -> None:
        """Append vectors; ids default to a contiguous range (explicit ids let
        a sharded wrapper assign global ids across shards)."""
        assert self.is_trained, "call train() before add()"
        vectors = np.asarray(vectors, np.float32)
        raw_vectors = vectors  # pre-rotation: whole-row refine stores these
        if self.opq_matrix is not None:
            vectors = self._rotate(vectors)
        n = vectors.shape[0]
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
            self._next_id += n
        else:
            ids = np.asarray(ids, np.int64)
            self._next_id = max(self._next_id, int(ids.max(initial=-1)) + 1)
        xv = jnp.asarray(vectors)
        assign, _ = assign_clusters(xv, jnp.asarray(self.centroids))
        enc_input = xv - jnp.asarray(self.centroids)[assign] if self.residual else xv
        codes = np.asarray(pq_encode(enc_input, jnp.asarray(self.codebooks)))
        if self.refine == "int8":
            # residual mode stores the (rotated-space) residuals themselves;
            # whole-row mode keeps UNrotated rows (scored vs raw queries)
            if self._refine_residual:
                self._store_refine(np.asarray(enc_input), ids)
            else:
                self._store_refine(raw_vectors, ids)
        self._pending.append(codes, ids, np.asarray(assign))
        if self._pending.size > max(4096, 0.1 * self._arena.size):
            self.merge_pending()
        self._dev = None

    def _store_refine(self, vectors: np.ndarray, ids: np.ndarray) -> None:
        rms = float(np.sqrt(np.mean(vectors.astype(np.float64) ** 2)))
        amax = float(np.abs(vectors).max(initial=0.0))
        batch_scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
        if batch_scale > self._refine_scale and self._refine_rows.shape[0]:
            self._refine_rows = np.clip(np.round(
                self._refine_rows.astype(np.float32)
                * (self._refine_scale / batch_scale)), -127, 127).astype(np.int8)
        self._refine_scale = max(self._refine_scale, batch_scale)
        hi = int(ids.max()) + 1
        if hi > self._refine_rows.shape[0]:
            grown = np.zeros((hi, self.dim), np.int8)
            grown[: self._refine_rows.shape[0]] = self._refine_rows
            self._refine_rows = grown
        self._refine_rows[ids] = np.clip(
            np.round(vectors / self._refine_scale), -127, 127
        ).astype(np.int8)

    def merge_pending(self) -> None:
        p, i, a = self._pending.drain()
        if p.shape[0]:
            self._arena.merge(p, i, a)
        self._dev = None

    def merge_from(self, other: "IVFPQIndex",
                   id_offset: int | None = None) -> int:
        """Consolidate another SAME-QUANTIZER IVF-PQ into this one (the
        FAISS ``merge_from`` surface): PQ codes transfer verbatim when the
        coarse centroids AND codebooks are identical (train once, reuse
        per worker), so independent builds merge with one native re-sort
        and no re-encoding. int8 refine stores are gid-keyed — both
        requantize to the larger of the two scales and scatter into one
        table. ``id_offset`` shifts ``other``'s global ids (collisions
        are rejected). Returns the number of rows merged in."""
        assert self.kind == other.kind and self.dim == other.dim
        assert self.metric == other.metric and self.m == other.m
        assert self.nbits == other.nbits and self.residual == other.residual
        assert self.refine == other.refine
        assert (self.opq_matrix is None) == (other.opq_matrix is None)
        np.testing.assert_allclose(self.centroids, other.centroids,
                                   atol=1e-6)
        np.testing.assert_allclose(self.codebooks, other.codebooks,
                                   atol=1e-6)
        if self.opq_matrix is not None:
            np.testing.assert_allclose(self.opq_matrix, other.opq_matrix,
                                       atol=1e-6)
        self.merge_pending()
        other.merge_pending()
        oa = other._arena
        codes_o = np.asarray(oa.payload)
        ids_o = np.asarray(oa.ids, np.int64)
        assign_o = np.repeat(np.arange(self.nlist), oa.list_lens)
        if id_offset is not None:
            ids_o = ids_o + int(id_offset)
        both = np.concatenate([np.asarray(self._arena.ids, np.int64), ids_o])
        uniq = np.unique(both)
        assert uniq.size == both.size, (
            f"{both.size - uniq.size} colliding global ids — pass "
            "id_offset=self._next_id (or any disjoint shift)")
        if self.refine == "int8" and other._refine_rows.shape[0]:
            # unify scales (larger wins — requantizing DOWN loses range),
            # then scatter other's rows under the (shifted) gids
            s = max(self._refine_scale, other._refine_scale)
            if s > self._refine_scale and self._refine_rows.shape[0]:
                self._refine_rows = np.clip(np.round(
                    self._refine_rows.astype(np.float32)
                    * (self._refine_scale / s)), -127, 127).astype(np.int8)
            rows_o = other._refine_rows
            if s > other._refine_scale:
                rows_o = np.clip(np.round(
                    rows_o.astype(np.float32) * (other._refine_scale / s)),
                    -127, 127).astype(np.int8)
            self._refine_scale = s
            # other's store is keyed by its UNSHIFTED gids; grow_scatter
            # copies, so a mmap-loaded (read-only) store is never mutated
            src = np.asarray(other._arena.ids, np.int64)
            self._refine_rows = grow_scatter_gid(
                self._refine_rows, rows_o[src], ids_o)
        self._arena.merge(codes_o, ids_o, assign_o)
        self._next_id = int(uniq[-1]) + 1 if uniq.size else 0
        self._dev = None
        return int(ids_o.shape[0])

    def remove(self, ids) -> int:
        """Delete rows by global id: pending chunks filter in place, the
        code arena compacts via one boolean-mask pass. The gid-keyed int8
        refine store keeps stale rows for removed ids (a removed gid can
        never surface as a candidate, so stale rows cost bytes, not
        correctness). Returns the number removed; unknown ids ignored;
        freed ids never reused."""
        from cloudvectordb_tpu.index.arena import normalize_remove_ids

        req = normalize_remove_ids(ids)
        if req.size == 0:
            return 0
        n_rem, _ = self._pending.remove_ids(req)
        n_rem += self._arena.remove_ids(req)
        if n_rem:
            self._dev = None
        return n_rem

    def _device_state(self):
        if self._dev is None:
            ar = self._arena
            self._dev = dict(
                centroids=jnp.asarray(self.centroids),
                codes=jnp.asarray(ar.payload),
                ids=jnp.asarray(ar.ids, jnp.int32),
                offsets=jnp.asarray(ar.offsets[:-1], jnp.int32),
                offsets_full=jnp.asarray(ar.offsets, jnp.int32),
                lens=jnp.asarray(ar.list_lens, jnp.int32),
                codebooks=jnp.asarray(self.codebooks),
                cap=max(8, ar.max_list_len),
                refine=jnp.asarray(self._refine_rows)
                if self.refine == "int8" else None,
            )
        return self._dev

    def search(self, queries, k: int, nprobe: int | None = None,
               batch: int = 256, refine_factor: int | None = None):
        """With refine enabled, the ADC stage retrieves refine_factor·k
        candidates which are exactly re-scored from the int8 store — PQ
        becomes the candidate generator, recall is refine-limited.
        nprobe/refine_factor default to the tuned op point (Index.tune)
        when one is set, else 8 / 16. The probe scan's speed on the GPU is
        not measured yet (ROADMAP A3)."""
        assert self.is_trained
        self.merge_pending()  # pending rows are PQ codes; simplest correct path
        raw_queries = np.asarray(queries, np.float32)
        queries = self._rotate(raw_queries) if self.opq_matrix is not None else raw_queries
        op = self._op_point or {}
        if nprobe is None:
            nprobe = op.get("nprobe", 8)
        if refine_factor is None:
            refine_factor = op.get("refine_factor", 16)
        nprobe = min(nprobe, self.nlist)
        do_refine = self.refine == "int8" and self._refine_rows.shape[0]
        kk = min(max(k * refine_factor, 32), self.ntotal) if do_refine else k
        st = self._device_state()
        outs_v, outs_i = [], []
        for s in range(0, queries.shape[0], batch):
            qb = jnp.asarray(queries[s : s + batch])
            v, rows_a = _ivfpq_scan_search(
                qb, st["centroids"], st["codes"], st["offsets"],
                st["lens"], st["codebooks"],
                k=kk, nprobe=nprobe, cap=st["cap"], metric=self.metric,
                residual=self.residual,
            )
            if do_refine:
                # exact re-score of the candidates. Unfilled ADC slots sit at
                # (NEG_INF, row 0) when probed lists hold fewer than k_cand
                # rows — mask them or row 0 gets rescored exactly and
                # displaces real results.
                v, rows_a = _refine_rescore(
                    qb, jnp.asarray(raw_queries[s : s + batch]), v, rows_a,
                    st["ids"], st["refine"], st["centroids"],
                    st["offsets_full"],
                    k=k, metric=self.metric,
                    refine_scale=self._refine_scale,
                    refine_residual=self._refine_residual,
                )
            rows_c = jnp.clip(rows_a, 0, st["ids"].shape[0] - 1)
            i = st["ids"][rows_c]
            outs_v.append(np.asarray(v))
            outs_i.append(np.asarray(i))
        return np.concatenate(outs_v), np.concatenate(outs_i)

    # -- op-point tuning (eval/tune.py) -----------------------------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        """nprobe ladder × refine depth. Cost ∝ nprobe (scan) + rf·k
        (gather-rescore): walk nprobe at the cheap depth first, escalating
        refine_factor only where candidate generation stops being the
        bottleneck (deep refine without coverage is wasted gathers)."""
        rfs = (16, 64) if self.refine == "int8" else (None,)
        out = []
        p = 1
        while p < self.nlist:
            for rf in rfs:
                out.append({"nprobe": p} if rf is None
                           else {"nprobe": p, "refine_factor": rf})
            p *= 2
        for rf in rfs:
            out.append({"nprobe": self.nlist} if rf is None
                       else {"nprobe": self.nlist, "refine_factor": rf})
        out.sort(key=lambda c: c["nprobe"] * (1 + c.get("refine_factor", 0)
                                              / 64.0))
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        # full probe + deep refine ≈ the index's recall ceiling (exact when
        # refine='int8'; PQ-reconstruction-limited otherwise)
        kw = {"nprobe": self.nlist}
        if self.refine == "int8":
            kw["refine_factor"] = 64
        return kw

    def reconstruct(self, ids) -> np.ndarray:
        """Near-exact rows (ORIGINAL space) for the given global ids: the
        int8 refine store when present (residual rows get their list
        centroid back), else PQ decode. Un-rotates OPQ output. API parity
        with the band family (ivf_band.py reconstruct)."""
        self.merge_pending()
        ids = np.asarray(ids)
        ar = self._arena
        pos = np.full(max(self._next_id, int(ar.ids.max(initial=-1)) + 1),
                      -1, np.int64)
        pos[ar.ids] = np.arange(ar.size)
        rows = pos[ids]
        assert (rows >= 0).all(), "unknown id"
        lists = np.searchsorted(ar.offsets, rows, side="right") - 1
        rotated_space = True  # whether `out` needs the OPQ un-rotation
        if self.refine == "int8" and self._refine_rows.shape[0]:
            out = (self._refine_rows[ids].astype(np.float32)
                   * self._refine_scale)
            if self._refine_residual:
                out = out + self.centroids[lists]
            else:
                rotated_space = False  # whole-row store is UNrotated
        else:
            codes = np.asarray(ar.payload)[rows]  # (n, m)
            cb = self.codebooks
            out = np.concatenate(
                [cb[j][codes[:, j]] for j in range(self.m)], axis=1)
            if self.residual:
                out = out + self.centroids[lists]
        if self.opq_matrix is not None and rotated_space:
            out = out @ self.opq_matrix  # rotated → original
        return out

    # -- persistence ------------------------------------------------------
    def _state_arrays(self):
        self.merge_pending()
        out = {
            "centroids": self.centroids,
            "codebooks": self.codebooks,
            "payload": self._arena.payload,
            "ids": self._arena.ids,
            "offsets": self._arena.offsets,
        }
        if self.opq_matrix is not None:
            out["opq_matrix"] = self.opq_matrix
        if self.refine == "int8":
            out["refine_rows"] = self._refine_rows
        return out

    def _state_meta(self):
        return {
            "nlist": self.nlist, "m": self.m, "nbits": self.nbits,
            "residual": self.residual, "kmeans_iters": self.kmeans_iters,
            "pq_train_iters": self.pq_train_iters, "seed": self.seed,
            "next_id": self._next_id, "opq": self.opq_matrix is not None,
            "refine": self.refine, "refine_scale": self._refine_scale,
            "refine_residual": self._refine_residual,
        }

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict) -> "IVFPQIndex":
        m = manifest["meta"]
        idx = cls(
            manifest["dim"], m["nlist"], m["m"], m["nbits"], manifest["metric"],
            m["residual"], m["kmeans_iters"], m["pq_train_iters"], m["seed"],
            opq_matrix=np.asarray(arrays["opq_matrix"]) if "opq_matrix" in arrays else None,
            refine=m.get("refine", "none"),
        )
        if "refine_rows" in arrays:
            idx._refine_rows = np.asarray(arrays["refine_rows"])
            idx._refine_scale = m.get("refine_scale", 1e-12)
        # pre-r3 artifacts stored whole-row refine regardless of residual
        idx._refine_residual = m.get("refine_residual", False)
        idx.centroids = arrays["centroids"]
        idx.codebooks = arrays["codebooks"]
        idx._arena.payload = arrays["payload"]
        idx._arena.ids = arrays["ids"]
        idx._arena.offsets = arrays["offsets"]
        idx._next_id = m["next_id"]
        return idx
