"""Sharded PQ-tiles serving index — BASELINE config #5 across a mesh.

The 1B×768d configuration (BASELINE.json:11) is definitionally a multi-chip
artifact: 8 × 125M rows/chip of exactly the family that holds 125M/chip —
``BandIVFPQIndex`` (PQ codes as the HBM memory format, segmented row-major
arenas past ~28M rows, pq2/host refine tiers). This wrapper shards its ROWS
across the 'shard' mesh axis with every quantizer (OPQ rotation, coarse
centroids, tier-1/tier-2 PQ codebooks) trained ONCE and replicated:

- per-shard arenas hold GLOBAL ids and scan with the same tile-table PQ
  kernel under ``shard_map``; the partial top-k merges with one all_gather
  (S·B·k floats) — identical collective shape to the band family
  (dist_band.py) and the probe-scan family (dist_ivf.py);
- gid-keyed refine tiers (tier-2 codes, host rows, int8 rows) are owned by
  the WRAPPER in per-shard insertion-order stores and permuted into ARENA
  order at device-staging time (the ``dist_ivf`` refine pattern) — so each
  chip's tier-2 table is exactly its own n rows (m2 bytes each), never the
  S×-wasteful global-gid-dense table;
- the tier-2 rescore runs INSIDE the sharded program, keyed by arena row
  (``_pq_tiles_core`` returns rows before the id map — index/ivf_band.py);
- the host tier (refine='host' / the r4 'pq2+host' cascade) runs as TWO
  dispatches: (1) kernel + on-chip tier-2 narrowing per shard, outputs
  stacked per shard, (2) each shard's shortlist rows gathered from ITS OWN
  host store (per-chip PCIe traffic = B·k_host·dim bytes, same as the
  single-chip case) and exactly rescored + merged on the mesh.

Device memory per card at 125M rows (m=64, m2=32, 768-d): 8 GB tier-1
codes + 4 GB tier-2 codes + 0.5 GB ids + ~0.4 GB centroid tiles ≈ 12.9 GB,
with the aggregate 1B object build/serve/save/reshard-able.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cloudvectordb_tpu.eval.tune import TunableMixin
from cloudvectordb_tpu.index.ivf_band import (
    BandIVFPQIndex, _host_rescore, _next_pow2, _pq2_rescore, _pq_tiles_core)
from cloudvectordb_tpu.index.range import RangeSearchMixin
from cloudvectordb_tpu.ops.assign import assign_clusters
from cloudvectordb_tpu.parallel.mesh import make_mesh


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "k_cand", "k_out", "p_tiles", "tile_n", "tile_q",
        "mesh", "refine_scale", "segmented",
        "refine_residual", "l2", "use_pq2", "stack_out",
    ),
)
def _sharded_pq_tiles_search(
    q, centroids, codebooks, codes, ids, tile_window, n_valid,
    centroid_tiles=None, local_rm=None, refine_rows=None,
    codes2=None, codebooks2=None, s2=None, row_mask=None,
    *, k, k_cand, k_out, p_tiles, tile_n, tile_q, mesh,
    refine_scale: float, segmented: bool,
    refine_residual: bool, l2: bool, use_pq2: bool,
    stack_out: bool,
):
    """The sharded config-#5 program: per-shard plan + PQ-tiles scan
    (+ arena-ordered tier-2 rescore) + global-id map, then either the
    cross-shard top-k merge (stack_out=False — one all_gather) or
    per-shard stacked (S·B, k_out) candidate sets (stack_out=True — the
    host-tier dispatch-1 output, each shard's shortlist staying on its own
    device until the host gathers its rows).

    Per-shard blocks (axis 0 sharded, equal shapes — staging pads to the
    max shard): codes col-major (m[+1], n_pad) below the segment cap or a
    tuple of row-major (r+tile_n, m) segments above it; ids (1, n_pad)
    GLOBAL; n_valid (1, nseg) per-segment true row counts; codes2/s2
    ARENA-ordered; row_mask kernel-ready per-shard allow bits."""
    qs = P("replica") if "replica" in mesh.axis_names else P()
    nseg = len(codes) if segmented else 1
    # the core's own top-k width: the full k_cand candidate set when a
    # downstream tier (on-chip tier-2 or the host rescore) reranks it, k
    # when the in-core int8 refine already reduced
    k_core = (k_cand if (use_pq2 or stack_out) and refine_scale == 0
              else k)

    def local(qb, c, cb, codes_l, ids_l, tw_l, nv_l, *rest):
        it = iter(rest)
        ct_l = next(it) if centroid_tiles is not None else None
        loc_l = next(it) if local_rm is not None else None
        rr_l = next(it) if refine_rows is not None else None
        c2_l = next(it) if codes2 is not None else None
        cb2_l = next(it) if codebooks2 is not None else None
        s2_l = next(it) if s2 is not None else None
        rm_l = next(it) if row_mask is not None else None
        nv = (tuple(nv_l[0, j] for j in range(nseg)) if segmented
              else nv_l[0, 0])
        v, rows = _pq_tiles_core(
            qb, c, codes_l, cb,
            rr_l if rr_l is not None else jnp.zeros((1, qb.shape[1]),
                                                    jnp.int8),
            tw_l, ct_l, nv, loc_l, rm_l,
            k=k_core,
            k_cand=k_cand, p_tiles=p_tiles, tile_n=tile_n, tile_q=tile_q,
            refine_scale=refine_scale, row_major=segmented,
            refine_residual=refine_residual, l2=l2,
        )
        if use_pq2:
            # tier-2 tables are staged in ARENA order → rescore by row
            # (merge-invariant: rows only mean something per shard, and the
            # rescore happens before the cross-shard merge)
            v, rows = _pq2_rescore(qb, v, rows, c2_l, cb2_l,
                                   s2_l if l2 else None, k=k_out, l2=l2)
        gid = ids_l[0][jnp.clip(rows, 0, ids_l.shape[1] - 1)]
        if rm_l is not None:  # unfilled slots keep the (-inf, -1) convention
            gid = jnp.where(v > -jnp.inf, gid, -1)
        v, gid = v[:, :k_out], gid[:, :k_out]
        if stack_out:
            return v, gid
        all_v = lax.all_gather(v, "shard", axis=0)  # (S, B, k_out)
        all_i = lax.all_gather(gid, "shard", axis=0)
        s, b, kk = all_v.shape
        cand_v = jnp.transpose(all_v, (1, 0, 2)).reshape(b, s * kk)
        cand_i = jnp.transpose(all_i, (1, 0, 2)).reshape(b, s * kk)
        best_v, pos = lax.top_k(cand_v, min(k, s * kk))
        return best_v, jnp.take_along_axis(cand_i, pos, axis=1)

    specs = [qs, P(), P(),
             tuple(P("shard") for _ in codes) if segmented else P("shard"),
             P("shard"), P("shard"), P("shard")]
    args = [q, centroids, codebooks, codes, ids, tile_window, n_valid]
    for extra, spec in (
        (centroid_tiles,
         (tuple(P("shard") for _ in centroid_tiles) if segmented
          else P("shard")) if centroid_tiles is not None else None),
        (local_rm,
         (tuple(P("shard") for _ in local_rm) if segmented
          else P("shard")) if local_rm is not None else None),
        (refine_rows, P("shard")),
        (codes2, P("shard")),
        (codebooks2, P()),
        (s2, P("shard")),
        (row_mask,
         (tuple(P("shard") for _ in row_mask) if segmented
          else P("shard")) if row_mask is not None else None),
    ):
        if extra is not None:
            specs.append(spec)
            args.append(extra)
    out_spec = P("shard") if stack_out else qs
    return shard_map(
        local, mesh=mesh, in_specs=tuple(specs),
        out_specs=(out_spec, out_spec), check_vma=False,
    )(*args)


@functools.partial(
    jax.jit,
    static_argnames=("k", "resid", "l2", "mesh", "scale"),
)
def _sharded_host_rescore(q, v, gids, r8, assign, centroids, x_sq=None,
                          *, k, resid, l2, mesh, scale: float):
    """Host-tier dispatch 2: each shard exactly rescores ITS OWN shortlist
    (rows gathered host-side from that shard's store — the only PCIe
    traffic) and the per-shard top-k merges with one all_gather. v/gids/
    r8/assign are (S·B, ...) stacked per shard; queries replicated."""
    def local(qb, vb, gb, rb, ab, c, *xs):
        vv, gg = _host_rescore(
            qb, vb, gb, rb, ab, c, jnp.float32(scale),
            xs[0] if xs else None, k=k, resid=resid, l2=l2)
        all_v = lax.all_gather(vv, "shard", axis=0)
        all_i = lax.all_gather(gg, "shard", axis=0)
        s, b, kk = all_v.shape
        cand_v = jnp.transpose(all_v, (1, 0, 2)).reshape(b, s * kk)
        cand_i = jnp.transpose(all_i, (1, 0, 2)).reshape(b, s * kk)
        best_v, pos = lax.top_k(cand_v, min(k, s * kk))
        return best_v, jnp.take_along_axis(cand_i, pos, axis=1)

    specs = [P(), P("shard"), P("shard"), P("shard"), P("shard"), P()]
    args = [q, v, gids, r8, assign, centroids]
    if x_sq is not None:
        specs.append(P("shard"))
        args.append(x_sq)
    return shard_map(
        local, mesh=mesh, in_specs=tuple(specs), out_specs=(P(), P()),
        check_vma=False,
    )(*args)


class ShardedBandIVFPQIndex(TunableMixin, RangeSearchMixin):
    """Row-partitioned ``BandIVFPQIndex`` with replicated quantizers — the
    sharded config-#5 object (module doc). Shards are plain refine='none'
    PQ-tiles arenas (global ids); every refine tier lives in the wrapper's
    per-shard gid-keyed insertion-order stores."""

    kind = "sharded_band_ivf_pq"

    def __init__(self, mesh: Mesh | None = None, refine: str = "none",
                 **pq_kw):
        self.mesh = mesh or make_mesh(axis_name="shard")
        pq_kw.pop("refine", None)
        self.kw = pq_kw
        self.refine = refine
        self.proto: BandIVFPQIndex | None = None  # shared trained quantizers
        self._shards: list[BandIVFPQIndex] = []
        # per-shard insertion-order tier stores, all keyed by the SAME gid
        # stream (_t_gids): appended together at build/add, permuted into
        # arena order at staging, re-partitioned by membership at reshard
        self._t_gids: list[list[np.ndarray]] = []
        self._t_c2: list[list[np.ndarray]] = []
        self._t_s2: list[list[np.ndarray]] = []
        self._t_host: list[list[np.ndarray]] = []
        self._t_assign: list[list[np.ndarray]] = []
        self._t_r8: list[list[np.ndarray]] = []
        self._refine_scale = 0.0
        self._next_gid = 0
        self._dev = None

    # -- shared-quantizer proto plumbing ----------------------------------
    def _shard_kw(self) -> dict:
        kw = dict(self.kw)
        kw.pop("refine", None)
        return kw

    @property
    def nshards(self) -> int:
        return self.mesh.shape["shard"]

    @property
    def ntotal(self) -> int:
        return sum(s.ntotal for s in self._shards)

    @property
    def metric(self) -> str:
        return self.kw.get("metric", "ip")

    @property
    def _tier2_active(self) -> bool:
        return self.refine in ("pq2", "pq2+host")

    @property
    def _host_active(self) -> bool:
        return self.refine in ("host", "pq2+host")

    def _gid_bound(self) -> int:
        return self._next_gid

    def _new_shard(self) -> BandIVFPQIndex:
        sub = BandIVFPQIndex(self.proto.dim, refine="none",
                             **self._shard_kw())
        sub.centroids = np.asarray(self.proto.centroids)
        sub.codebooks = np.asarray(self.proto.codebooks)
        sub.opq_matrix = self.proto.opq_matrix
        return sub

    def _encode_batch(self, chunk):
        """Rotate/assign/tier-1-encode one chunk with the shared quantizers
        (device compute, host results) + every active tier's payload."""
        proto = self.proto
        chunk = jnp.asarray(chunk, jnp.float32)
        rot = (jnp.asarray(proto.opq_matrix).T
               if proto.opq_matrix is not None else None)
        tr = chunk @ rot if rot is not None else chunk
        cdev = jnp.asarray(proto.centroids)
        a, _ = assign_clusters(tr, cdev)
        enc_in = tr - cdev[a] if proto.residual else tr
        codes = proto._pq_encode_rows(enc_in, tr,
                                      jnp.asarray(proto.codebooks))
        out = {"codes": np.asarray(codes).astype(np.uint8),
               "assigns": np.asarray(a).astype(np.int32)}
        if self.refine == "int8":
            rsrc = enc_in if proto.residual else tr
            if self._refine_scale == 0.0:  # first chunk sets the scale
                rms = float(jnp.sqrt(jnp.mean(rsrc * rsrc)))
                amax = float(jnp.max(jnp.abs(rsrc)))
                self._refine_scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
            out["r8"] = np.asarray(jnp.clip(
                jnp.round(rsrc / self._refine_scale), -127, 127
            ).astype(jnp.int8))
        if self._tier2_active:
            if self.metric == "l2":
                c2, s2 = proto._encode_tier2(
                    enc_in, codes,
                    c_rows=cdev[a] if proto.residual else None, with_s2=True)
                out["c2"], out["s2"] = np.asarray(c2), np.asarray(s2)
            else:
                out["c2"] = np.asarray(proto._encode_tier2(enc_in, codes))
        if self._host_active:
            out["host"] = np.asarray(jnp.clip(
                jnp.round(enc_in / proto._host_scale), -127, 127
            ).astype(jnp.int8))
        return out

    def _append_tiers(self, si: int, gids: np.ndarray, enc: dict) -> None:
        if not (self._tier2_active or self._host_active
                or self.refine == "int8"):
            return
        self._t_gids[si].append(gids.astype(np.int64))
        if self._tier2_active:
            self._t_c2[si].append(enc["c2"])
            if self.metric == "l2":
                self._t_s2[si].append(enc["s2"])
        if self._host_active:
            self._t_host[si].append(enc["host"])
        if self.refine == "int8":
            self._t_r8[si].append(enc["r8"])
        self._t_assign[si].append(enc["assigns"])

    # -- build paths -------------------------------------------------------
    @classmethod
    def build(cls, vectors, nlist: int, m: int = 64,
              mesh: Mesh | None = None, train_sample: int = 262_144,
              opq: bool = False, refine: str = "none",
              **kw) -> "ShardedBandIVFPQIndex":
        """Host-matrix build (test scale); config #5 itself streams
        (build_streaming). One global training sample → shared quantizers;
        rows partition contiguously; each shard assembles with one native
        arena sort."""
        vectors = np.asarray(vectors, np.float32)
        idx = cls(mesh, refine=refine, nlist=nlist, m=m, **kw)
        seed = kw.get("seed", 0)
        ns = min(train_sample, vectors.shape[0])
        sel = np.sort(np.random.default_rng(seed).choice(
            vectors.shape[0], ns, replace=False))
        idx.proto = BandIVFPQIndex.train_proto(
            vectors[sel], nlist, m=m, opq=opq, refine=refine, **kw)
        s = idx.nshards
        idx._init_tier_lists(s)
        assert vectors.shape[0] >= s, (
            f"{vectors.shape[0]} rows cannot populate {s} shards")
        bounds = np.linspace(0, vectors.shape[0], s + 1).astype(int)
        for si in range(s):
            block = vectors[bounds[si]: bounds[si + 1]]
            gids = np.arange(bounds[si], bounds[si + 1], dtype=np.int64)
            enc = idx._encode_batch(block)
            sub = idx._new_shard()
            sub._reassemble(enc["codes"], gids, enc["assigns"], None)
            sub._next_id = int(vectors.shape[0])
            idx._shards.append(sub)
            idx._append_tiers(si, gids, enc)
        idx._next_gid = int(vectors.shape[0])
        return idx

    @classmethod
    def build_streaming(cls, chunks, nlist: int, m: int = 64,
                        mesh: Mesh | None = None,
                        train_sample: int = 262_144, opq: bool = False,
                        refine: str = "none",
                        **kw) -> "ShardedBandIVFPQIndex":
        """Config #5 verbatim at mesh scale: quantizers train on the first
        chunk; every chunk is rotated/assigned/encoded on device and its
        m-byte codes (+ tier payloads) split across shards — the f32 corpus
        never exists in one piece, and each shard's arena assembles once
        with the native sort (streaming encode→insert, BASELINE.json:11)."""
        idx = cls(mesh, refine=refine, nlist=nlist, m=m, **kw)
        s = idx.nshards
        idx._init_tier_lists(s)
        codes_acc = [[] for _ in range(s)]
        assigns_acc = [[] for _ in range(s)]
        gids_acc = [[] for _ in range(s)]
        next_id = 0
        for chunk in chunks:
            if idx.proto is None:
                chunk = np.asarray(chunk, np.float32)
                ns = min(train_sample, chunk.shape[0])
                idx.proto = BandIVFPQIndex.train_proto(
                    chunk[:ns], nlist, m=m, opq=opq, refine=refine, **kw)
            enc = idx._encode_batch(chunk)
            b = enc["codes"].shape[0]
            gids = np.arange(next_id, next_id + b, dtype=np.int64)
            next_id += b
            for si, sl in enumerate(np.array_split(np.arange(b), s)):
                if not sl.size:
                    continue
                codes_acc[si].append(enc["codes"][sl])
                assigns_acc[si].append(enc["assigns"][sl])
                gids_acc[si].append(gids[sl])
                idx._append_tiers(si, gids[sl],
                                  {k_: v_[sl] for k_, v_ in enc.items()})
        assert idx.proto is not None, "empty stream"
        for si in range(s):
            assert codes_acc[si], f"shard {si} received no rows"
            sub = idx._new_shard()
            sub._reassemble(np.concatenate(codes_acc[si]),
                            np.concatenate(gids_acc[si]),
                            np.concatenate(assigns_acc[si]), None)
            sub._next_id = next_id
            idx._shards.append(sub)
        idx._next_gid = next_id
        return idx

    def _init_tier_lists(self, s: int) -> None:
        self._t_gids = [[] for _ in range(s)]
        self._t_c2 = [[] for _ in range(s)]
        self._t_s2 = [[] for _ in range(s)]
        self._t_host = [[] for _ in range(s)]
        self._t_assign = [[] for _ in range(s)]
        self._t_r8 = [[] for _ in range(s)]

    # -- mutation ----------------------------------------------------------
    def add(self, vectors) -> np.ndarray:
        """Append to the smallest shard under wrapper-allocated global ids;
        tier payloads encode once with the shared quantizers and join the
        wrapper's gid-keyed stores. The staged mesh state rebuilds on the
        next search (sharded scans read only staged arenas). Returns the
        new rows' global ids."""
        assert self._shards, "build() first"
        vectors = np.asarray(vectors, np.float32)
        b = vectors.shape[0]
        gids = np.arange(self._next_gid, self._next_gid + b, dtype=np.int64)
        self._next_gid += b
        # smallest NON-EMPTY shard: an emptied-by-remove() shard cannot
        # take explicit ids (its add() would route to _populate, which
        # allocates its own — review finding, r4)
        sizes = [sh.ntotal if sh.ntotal else np.inf for sh in self._shards]
        assert np.isfinite(min(sizes)), (
            "every shard is empty — build() a fresh index instead")
        si = int(np.argmin(sizes))
        sh = self._shards[si]
        sh.add(vectors, ids=gids)
        sh.merge_pending()
        if self._tier2_active or self._host_active or self.refine == "int8":
            # (refine='none' skips the tier encode entirely — the shard's
            # own add() already produced the arena codes)
            self._append_tiers(si, gids, self._encode_batch(vectors))
        self._dev = None
        return gids

    def remove(self, ids) -> int:
        """Delete by global id (each shard compacts what it owns; the
        wrapper's gid-keyed tier stores keep stale rows — staging only
        looks up SURVIVING arena ids, so stale entries cost bytes, not
        correctness; freed gids are never reused)."""
        total = sum(sh.remove(ids) for sh in self._shards)
        if total:
            self._dev = None
        return total

    # -- device staging ----------------------------------------------------
    def _tier_store(self, si: int):
        """(gids_sorted, sort_idx, concat caches) for shard si's tier
        stores; cached per append-count so staging after add() re-sorts."""
        key = (si, len(self._t_gids[si]))
        cache = getattr(self, "_tier_cache", None)
        if cache is not None and cache.get(si, (None,))[0] == key:
            return cache[si][1]
        gids = (np.concatenate(self._t_gids[si]) if self._t_gids[si]
                else np.empty(0, np.int64))
        sort_idx = np.argsort(gids, kind="stable")
        out = {
            "gids_sorted": gids[sort_idx],
            "sort_idx": sort_idx,
            "c2": (np.concatenate(self._t_c2[si]) if self._t_c2[si]
                   else None),
            "s2": (np.concatenate(self._t_s2[si]) if self._t_s2[si]
                   else None),
            "host": (np.concatenate(self._t_host[si]) if self._t_host[si]
                     else None),
            "assign": (np.concatenate(self._t_assign[si])
                       if self._t_assign[si] else None),
            "r8": (np.concatenate(self._t_r8[si]) if self._t_r8[si]
                   else None),
        }
        if cache is None:
            cache = self._tier_cache = {}
        cache[si] = (key, out)
        return out

    def _arena_perm(self, si: int) -> np.ndarray:
        """Positions of shard si's ARENA rows in its insertion-order tier
        stores (gid lookup — the dist_ivf staging pattern)."""
        st = self._tier_store(si)
        arena_ids = np.asarray(self._shards[si]._ids, np.int64)
        pos = np.searchsorted(st["gids_sorted"], arena_ids)
        assert (st["gids_sorted"][pos] == arena_ids).all(), (
            "tier store missing arena gids — build/add bookkeeping bug")
        return st["sort_idx"][pos]

    def _common_layout(self):
        tile_n = self._shards[0].tile_n
        n_pad_max = max(sh._n_pad_rows for sh in self._shards)
        seg_rows, seg_offs = self._shards[0]._seg_layout(n_pad_max)
        segmented = len(seg_rows) > 1
        n_tiles = n_pad_max // tile_n
        w = max(sh._tile_window.shape[1] for sh in self._shards)
        return tile_n, n_pad_max, seg_rows, seg_offs, segmented, n_tiles, w

    def _shard_tw(self, si: int, n_tiles: int, w: int) -> np.ndarray:
        tw = self._shards[si]._tile_window
        if tw.shape[0] < n_tiles:
            tw = np.concatenate(
                [tw, np.repeat(tw[-1:], n_tiles - tw.shape[0], axis=0)])
        if tw.shape[1] < w:
            tw = np.concatenate(
                [tw, np.repeat(tw[:, -1:], w - tw.shape[1], axis=1)], axis=1)
        return tw.astype(np.int32)

    def _device_state(self):
        if self._dev is not None:
            return self._dev
        from cloudvectordb_tpu.parallel.mesh import (
            stage_replicated, stage_row_sharded)

        s = self.nshards
        proto = self.proto
        m = proto.m
        dim = proto.dim
        (tile_n, n_pad_max, seg_rows, seg_offs, segmented, n_tiles,
         w) = self._common_layout()
        assert not (segmented and self.refine == "int8"), (
            "int8 refine rows at segmented scale exceed HBM by construction"
            " — use refine='pq2'/'host'/'pq2+host' (index/ivf_band.py)")
        residual = proto.residual

        def rows_of(si):
            return self._shards[si]._codes_np_rows()[: self._shards[si]._n]

        def local_of(si):
            sh = self._shards[si]
            tw = self._shard_tw(si, n_tiles, w)
            row_tile = np.arange(sh._n) // tile_n
            assigns = np.repeat(np.arange(sh.nlist), np.diff(sh._offsets))
            return (assigns - tw[row_tile, 0]).astype(np.uint8)

        dev = dict(
            centroids=stage_replicated(np.asarray(proto.centroids),
                                       self.mesh),
            codebooks=stage_replicated(np.asarray(proto.codebooks),
                                       self.mesh),
            ids=stage_row_sharded(
                lambda si: np.pad(
                    np.asarray(self._shards[si]._ids, np.int64),
                    (0, n_pad_max - self._shards[si]._ids.shape[0]),
                ).astype(np.int32)[None], s, self.mesh),
            tile_window=stage_row_sharded(
                lambda si: self._shard_tw(si, n_tiles, w), s, self.mesh),
            n_valid=stage_row_sharded(
                lambda si: np.asarray(
                    [np.clip(self._shards[si]._n - off, 0, r)
                     for r, off in zip(seg_rows, seg_offs)],
                    np.int32)[None], s, self.mesh),
            n_tiles=n_tiles, segmented=segmented,
        )
        if segmented:
            # common row-major segments, each + one zero pad tile
            def seg_piece(j):
                def piece(si):
                    r, off = seg_rows[j], seg_offs[j]
                    rows = rows_of(si)
                    out = np.zeros((r + tile_n, m), np.uint8)
                    lo, hi = off, min(off + r, rows.shape[0])
                    if hi > lo:
                        out[: hi - lo] = rows[lo:hi]
                    return out
                return piece

            dev["codes"] = tuple(
                stage_row_sharded(seg_piece(j), s, self.mesh)
                for j in range(len(seg_rows)))
            if residual:
                def loc_piece(j):
                    def piece(si):
                        r, off = seg_rows[j], seg_offs[j]
                        loc = local_of(si)
                        out = np.zeros((1, r + tile_n), np.uint8)
                        lo, hi = off, min(off + r, loc.shape[0])
                        if hi > lo:
                            out[0, : hi - lo] = loc[lo:hi]
                        return out
                    return piece

                dev["local_rm"] = tuple(
                    stage_row_sharded(loc_piece(j), s, self.mesh)
                    for j in range(len(seg_rows)))
        else:
            rows_cm = m + (1 if residual else 0)

            def cm_piece(si):
                rows = rows_of(si)
                out = np.zeros((rows_cm, n_pad_max), np.uint8)
                out[:m, : rows.shape[0]] = rows.T
                if residual:
                    out[m, : rows.shape[0]] = local_of(si)
                return out

            dev["codes"] = stage_row_sharded(cm_piece, s, self.mesh)
        if residual:
            cents = np.asarray(proto.centroids)

            if segmented:
                def ct_piece(j):
                    def piece(si):
                        tw = self._shard_tw(si, n_tiles, w)
                        t0 = seg_offs[j] // tile_n
                        t1 = (seg_offs[j] + seg_rows[j]) // tile_n
                        ct = cents[tw[t0:t1]]
                        ct = np.concatenate(
                            [ct, np.zeros((1, *ct.shape[1:]), ct.dtype)])
                        return np.ascontiguousarray(ct).astype(jnp.bfloat16)
                    return piece

                dev["centroid_tiles"] = tuple(
                    stage_row_sharded(ct_piece(j), s, self.mesh)
                    for j in range(len(seg_rows)))
            else:
                dev["centroid_tiles"] = stage_row_sharded(
                    lambda si: np.ascontiguousarray(
                        cents[self._shard_tw(si, n_tiles, w)]
                    ).astype(jnp.bfloat16), s, self.mesh)
        if self.refine == "int8":
            def r8_piece(si):
                perm = self._arena_perm(si)
                rr = self._tier_store(si)["r8"][perm]
                out = np.zeros((n_pad_max, dim), np.int8)
                out[: rr.shape[0]] = rr
                return out

            dev["refine"] = stage_row_sharded(r8_piece, s, self.mesh)
        if self._tier2_active:
            m2 = proto.m2

            def c2_piece(si):
                perm = self._arena_perm(si)
                c2 = self._tier_store(si)["c2"][perm]
                out = np.zeros((n_pad_max, m2), np.uint8)
                out[: c2.shape[0]] = c2
                return out

            dev["codes2"] = stage_row_sharded(c2_piece, s, self.mesh)
            dev["codebooks2"] = stage_replicated(
                np.asarray(proto.codebooks2), self.mesh)
            if self.metric == "l2":
                def s2_piece(si):
                    perm = self._arena_perm(si)
                    s2 = self._tier_store(si)["s2"][perm]
                    return np.pad(s2, (0, n_pad_max - s2.shape[0])).astype(
                        np.float32)

                dev["s2"] = stage_row_sharded(s2_piece, s, self.mesh)
        self._dev = dev
        return dev

    # -- filters -----------------------------------------------------------
    def make_filter(self, where):
        from cloudvectordb_tpu.index.filters import IdFilter

        return IdFilter.coerce(where, max(self._next_gid, 1))

    def _staged_row_mask(self, flt):
        """Per-shard kernel-ready arena allow bits (row-sharded; per-segment
        tuples on segmented layouts), cached per (filter, staging). The
        cache holds REFERENCES to both key objects — identity keys are only
        sound while the keyed objects stay alive (a recycled id() would
        serve a stale filter's mask; same rule as _arena_mask_from_ids)."""
        from cloudvectordb_tpu.parallel.mesh import stage_row_sharded

        cache = getattr(self, "_rm_cache", None)
        if (cache is not None and cache[0] is flt
                and cache[1] is self._dev):
            return cache[2]
        (tile_n, n_pad_max, seg_rows, seg_offs, segmented, _n_tiles,
         _w) = self._common_layout()
        mask_np = np.asarray(flt.mask_np)

        def arena_mask(si):
            ids = np.asarray(self._shards[si]._ids, np.int64)
            ok = np.zeros(n_pad_max, np.int8)
            valid = (ids >= 0) & (ids < mask_np.shape[0])
            ok[: ids.shape[0]][valid] = mask_np[ids[valid]]
            return ok

        if segmented:
            def seg_piece(j):
                def piece(si):
                    r, off = seg_rows[j], seg_offs[j]
                    ok = arena_mask(si)
                    out = np.zeros((1, r + tile_n), np.int8)
                    out[0, :r] = ok[off: off + r]
                    return out
                return piece

            rm = tuple(stage_row_sharded(seg_piece(j), self.nshards,
                                         self.mesh)
                       for j in range(len(seg_rows)))
        else:
            rm = stage_row_sharded(lambda si: arena_mask(si)[None],
                                   self.nshards, self.mesh)
        self._rm_cache = (flt, self._dev, rm)
        return rm

    # -- search ------------------------------------------------------------
    def _stage_plan(self, k, refine_factor, host_factor, n_pools, tq,
                    p_tiles, top2):
        """Wrapper twin of BandIVFPQIndex._pq_stage_plan: per-SHARD
        candidate budgets (each shard generates its own k_cand candidates;
        the merge pools shards × k_out)."""
        proto = self.proto
        tier2 = self._tier2_active and proto.codebooks2 is not None
        host = self._host_active and any(self._t_host)
        two_stage = tier2 or host or self.refine == "int8"
        per_shard = max(sh._n for sh in self._shards)
        k_cand = min(max(k * refine_factor, 32), per_shard) if two_stage \
            else k
        tile_n = proto.tile_n
        slot_budget = max(min(262_144 // tq, 8192), tile_n)
        mult = 2 if top2 else 1
        if n_pools <= 0:
            n_pools = max(1, min(-(-k_cand // (mult * tile_n)),
                                 max(slot_budget // (mult * tile_n), 1),
                                 p_tiles))
        l_buckets = proto._derive_l_buckets(k_cand, mult * n_pools)
        k_cand = min(k_cand, mult * n_pools * l_buckets)
        # per-shard output width: k for on-chip-complete modes, the PCIe
        # shortlist width for the host tier
        if host:
            k_out = min(max(k * host_factor, k), k_cand) if tier2 else k_cand
        else:
            k_out = k
        return two_stage, tier2, host, k_cand, n_pools, l_buckets, k_out

    def search(self, queries, k: int, nprobe: int = 32, p_tiles: int = 0,
               refine_factor: int | None = None, n_pools: int = 0,
               tile_q: int | None = None, where=None,
               top2: bool | None = None, host_factor: int | None = None,
               **_):
        assert self._shards, "build() first"
        queries = np.asarray(queries, np.float32)
        proto = self.proto
        if proto.opq_matrix is not None:
            queries = queries @ proto.opq_matrix.T
        nq = queries.shape[0]
        flt = self.make_filter(where) if where is not None else None
        op = self._op_point or {}
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
        sh0 = self._shards[0]
        st = self._device_state()
        n_rep = dict(zip(self.mesh.axis_names,
                         self.mesh.devices.shape)).get("replica", 1)
        nproc = jax.process_count()
        if nproc > 1:
            nq_plan, q_mult = nq, tile_q or sh0.tile_q
        else:
            tq0 = tile_q or sh0.tile_q
            nq_plan, q_mult = max(1, nq // n_rep), tq0 * n_rep
        tq = tile_q or sh0.tile_q
        if tile_q is None and nq_plan < tq:
            tq = max(8, _next_pow2(nq_plan))
            q_mult = tq * (1 if nproc > 1 else n_rep)
        if p_tiles <= 0:
            p_tiles = sh0._auto_p_tiles(nq_plan, nprobe, int(st["n_tiles"]),
                                        tile_q=tq)
        two_stage, tier2, host, k_cand, n_pools, l_buckets, k_out = \
            self._stage_plan(k, refine_factor, host_factor, n_pools, tq,
                             p_tiles, top2)
        q_pad = -(-nq // q_mult) * q_mult
        qp = queries if q_pad == nq else np.concatenate(
            [queries, np.repeat(queries[-1:], q_pad - nq, axis=0)])
        l2 = self.metric == "l2"
        from cloudvectordb_tpu.parallel.mesh import fetch_local, stage_queries

        import zlib

        flt_crc = (zlib.crc32(flt.mask_np.tobytes())
                   if flt is not None else 0)
        qg = stage_queries(qp, self.mesh,
                           statics=(p_tiles, k, k_cand, k_out, flt_crc,
                                    int(l2), int(host)))
        stack_out = host
        if stack_out:
            assert "replica" not in self.mesh.axis_names, (
                "the host tier's stacked dispatch-1 output is 1-D-'shard'-"
                "mesh only (replica meshes serve on-chip modes)")
        v, gid = _sharded_pq_tiles_search(
            qg, st["centroids"], st["codebooks"], st["codes"], st["ids"],
            st["tile_window"], st["n_valid"],
            st.get("centroid_tiles"), st.get("local_rm"), st.get("refine"),
            st.get("codes2") if tier2 else None,
            st.get("codebooks2") if tier2 else None,
            st.get("s2") if tier2 and l2 else None,
            self._staged_row_mask(flt) if flt is not None else None,
            k=k, k_cand=k_cand, k_out=k_out, p_tiles=p_tiles,
            tile_n=sh0.tile_n, tile_q=tq, mesh=self.mesh,
            refine_scale=(self._refine_scale if self.refine == "int8"
                          else 0.0),
            segmented=bool(st["segmented"]),
            refine_residual=(self.refine == "int8" and proto.residual),
            l2=l2, use_pq2=tier2, stack_out=stack_out,
        )
        if not stack_out:
            out_v = fetch_local(v)[:nq]
            out_i = fetch_local(gid)[:nq].astype(np.int64)
            if flt is not None:
                out_i = np.where(out_v > -np.inf, out_i, -1)
            return out_v, out_i
        # host tier dispatch 2: gather each shard's shortlist rows from its
        # own store, rescore exactly on the mesh, merge. Multi-process
        # each process fetches ONLY the dispatch-1
        # slices its devices hold (addressable_shards), gathers ONLY its
        # own shards' rows from its own host stores, and re-stages them
        # per-device (stage_row_sharded already skips remote shards) —
        # per-host PCIe/RAM traffic stays 1/P of the shortlist, and the
        # dispatch-2 merge all_gather is the only cross-host hop.
        s = self.nshards
        b = qp.shape[0]
        me = jax.process_index()
        shard_devs = list(self.mesh.devices.flat)[:s]
        local_sis = {si for si, d in enumerate(shard_devs)
                     if d.process_index == me}

        def _per_shard_local(arr, dtype):
            out = {}
            for piece in arr.addressable_shards:
                si = (piece.index[0].start or 0) // b
                out[si] = np.asarray(piece.data, dtype)
            return out

        v_h = _per_shard_local(v, np.float32)
        g_h = _per_shard_local(gid, np.int64)
        r8 = {}
        assign = {}
        x_sq = {} if l2 and proto.residual else None
        for si in local_sis:
            ts = self._tier_store(si)
            g = g_h[si].reshape(-1)
            # candidates are this shard's arena gids (plus -inf slots →
            # clamp to slot 0 of the store; masked by -inf downstream)
            pos = np.searchsorted(ts["gids_sorted"],
                                  np.clip(g, ts["gids_sorted"][0],
                                          ts["gids_sorted"][-1]))
            perm = ts["sort_idx"][pos]
            r8[si] = ts["host"][perm].reshape(b, k_out, proto.dim)
            assign[si] = ts["assign"][perm].reshape(b, k_out)
            if x_sq is not None:
                x_sq[si] = self._host_sq(si)[perm].reshape(b, k_out)
        from cloudvectordb_tpu.parallel.mesh import (fetch_local,
                                                     stage_replicated,
                                                     stage_row_sharded)

        v2, g2 = _sharded_host_rescore(
            stage_replicated(qp, self.mesh),
            stage_row_sharded(lambda si: v_h[si], s, self.mesh),
            stage_row_sharded(lambda si: g_h[si].astype(np.int32), s,
                              self.mesh),
            stage_row_sharded(lambda si: r8[si], s, self.mesh),
            stage_row_sharded(lambda si: assign[si], s, self.mesh),
            st["centroids"],
            (stage_row_sharded(lambda si: x_sq[si], s, self.mesh)
             if x_sq is not None else None),
            k=k, resid=proto.residual, l2=l2, mesh=self.mesh,
            scale=float(proto._host_scale),
        )
        out_v = fetch_local(v2)[:nq]
        out_i = fetch_local(g2)[:nq].astype(np.int64)
        if flt is not None:
            out_i = np.where(out_v > -np.inf, out_i, -1)
        return out_v, out_i

    def _host_sq(self, si: int) -> np.ndarray:
        """‖x̂‖² per insertion-order host-store row of shard si (l2 host
        rescore bias — the shared index-layer helper), cached per store
        version."""
        from cloudvectordb_tpu.index.ivf_band import host_rows_sq

        ts = self._tier_store(si)
        cache = getattr(self, "_host_sq_cache", {})
        hit = cache.get(si)
        if hit is not None and hit[0] is ts["host"]:
            return hit[1]
        out = host_rows_sq(ts["host"], ts["assign"], self.proto.centroids,
                           self.proto._host_scale)
        cache[si] = (ts["host"], out)
        self._host_sq_cache = cache
        return out

    # -- op-point tuning ---------------------------------------------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        n_tiles = int(self._device_state()["n_tiles"])
        sh0 = self._shards[0]
        base = sh0._auto_p_tiles(nq, 32, n_tiles)
        host = self._host_active and any(self._t_host)
        out = []
        for mult in (1.0, 1.5, 2.5, 4.0, 7.0, 12.0):
            p = min(n_tiles, max(32, int(base * mult) // 32 * 32))
            if self.refine == "none":
                out.append({"p_tiles": p})
            elif host and self._tier2_active:
                for rf in (64, 205, 410):
                    for hf in (32, 102):
                        out.append({"p_tiles": p, "refine_factor": rf,
                                    "host_factor": hf})
            else:
                for rf in (16, 64, 102):
                    out.append({"p_tiles": p, "refine_factor": rf})
                    if rf >= 64:
                        out.append({"p_tiles": p, "refine_factor": rf,
                                    "top2": True})
            if p >= n_tiles:
                break
        seen = set()
        out = [c for c in out
               if (key := tuple(sorted(c.items()))) not in seen
               and not seen.add(key)]
        out.sort(key=lambda c: (c["p_tiles"]
                                * (1 + c.get("refine_factor", 0) / 256.0)
                                * (1 + c.get("host_factor", 0) / 512.0)))
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        n_tiles = int(self._device_state()["n_tiles"])
        kw = {"p_tiles": n_tiles}
        if self.refine != "none":
            kw["refine_factor"] = 102
        if self._host_active and any(self._t_host) and self._tier2_active:
            kw["refine_factor"] = 410
            kw["host_factor"] = 102
        return kw

    # -- persistence -------------------------------------------------------
    def save(self, path, extra_meta: dict | None = None) -> None:
        """One atomic directory (parallel/persist.py): per-shard PQ-tiles
        artifacts + the wrapper's insertion-order tier stores (gid-keyed →
        they survive future merges and elastic reshard)."""
        from cloudvectordb_tpu.parallel.persist import save_sharded

        for sh in self._shards:
            sh.merge_pending()

        def cat(chunks):
            return np.concatenate(chunks) if chunks else None

        extras = {"tier_gids": [cat(c) for c in self._t_gids],
                  "tier_assign": [cat(c) for c in self._t_assign]}
        if self._tier2_active:
            extras["tier_c2"] = [cat(c) for c in self._t_c2]
            if self.metric == "l2":
                extras["tier_s2"] = [cat(c) for c in self._t_s2]
            s = self.nshards
            extras["codebooks2"] = ([np.asarray(self.proto.codebooks2)]
                                    + [None] * (s - 1))
        if self._host_active:
            extras["tier_host"] = [cat(c) for c in self._t_host]
        if self.refine == "int8":
            extras["tier_r8"] = [cat(c) for c in self._t_r8]
        save_sharded(
            path,
            {"kind": self.kind, "kw": self.kw, "refine": self.refine,
             "refine_scale": self._refine_scale,
             "host_scale": float(self.proto._host_scale),
             "next_gid": self._next_gid, "op_point": self._op_point,
             **(extra_meta or {})},
            self._shards,
            extras_per_shard=extras,
        )

    @classmethod
    def load(cls, path, mesh: Mesh | None = None,
             mmap: bool = True) -> "ShardedBandIVFPQIndex":
        from cloudvectordb_tpu.parallel.persist import (
            load_extras, load_shards, read_sharded_manifest)

        man = read_sharded_manifest(path)
        assert man["kind"] == cls.kind, man["kind"]
        if mesh is None:
            mesh = make_mesh(man["nshards"], axis_name="shard")
        idx = cls(mesh, refine=man["refine"], **man.get("kw", {}))
        idx._refine_scale = man["refine_scale"]
        idx._next_gid = man["next_gid"]
        idx._shards = load_shards(path, man, mmap=mmap)
        s_saved = man["nshards"]
        idx._init_tier_lists(s_saved)

        def fill(dst, name):
            arrs = load_extras(path, man, name, mmap=mmap)
            for si, a in enumerate(arrs or []):
                if a is not None:
                    dst[si].append(np.asarray(a))

        fill(idx._t_gids, "tier_gids")
        fill(idx._t_assign, "tier_assign")
        fill(idx._t_c2, "tier_c2")
        fill(idx._t_s2, "tier_s2")
        fill(idx._t_host, "tier_host")
        fill(idx._t_r8, "tier_r8")
        # proto: shared quantizers reconstruct from shard 0 + extras
        sh0 = idx._shards[0]
        proto = BandIVFPQIndex(sh0.dim, refine=idx.refine,
                               **idx._shard_kw())
        proto.centroids = np.asarray(sh0.centroids)
        proto.codebooks = np.asarray(sh0.codebooks)
        proto.opq_matrix = sh0.opq_matrix
        proto._host_scale = man.get("host_scale", 0.0)
        cb2 = load_extras(path, man, "codebooks2", mmap=mmap)
        if cb2 and cb2[0] is not None:
            proto.codebooks2 = np.asarray(cb2[0])
        idx.proto = proto
        if idx.nshards != s_saved:
            idx._do_reshard(idx.nshards)
        if man.get("op_point"):
            idx._op_point = dict(man["op_point"])
        return idx

    def _do_reshard(self, s_new: int) -> None:
        """Elastic reshard (e.g. 8 ↔ 16 shards without a rebuild): codes move
        VERBATIM (shared quantizers), rows sort by global id and split
        contiguously, each new shard runs one native arena sort; the
        gid-keyed tier stores re-partition by arena membership."""
        codes_l, gids_l, asg_l = [], [], []
        for sh in self._shards:
            sh.merge_pending()
            codes_l.append(sh._codes_np_rows()[: sh._n])
            gids_l.append(np.asarray(sh._ids, np.int64))
            asg_l.append(np.repeat(np.arange(sh.nlist),
                                   np.diff(sh._offsets)).astype(np.int32))
        codes = np.concatenate(codes_l)
        gid = np.concatenate(gids_l)
        assign = np.concatenate(asg_l)
        order = np.argsort(gid, kind="stable")
        codes, gid, assign = codes[order], gid[order], assign[order]

        def cat_all(lists):
            parts = [np.concatenate(c) for c in lists if c]
            return np.concatenate(parts) if parts else None

        g_all = cat_all(self._t_gids)
        stores = {name: cat_all(getattr(self, name))
                  for name in ("_t_c2", "_t_s2", "_t_host", "_t_assign",
                               "_t_r8")}
        bounds = np.linspace(0, gid.shape[0], s_new + 1).astype(int)
        shards = []
        self._init_tier_lists(s_new)
        for si in range(s_new):
            lo, hi = bounds[si], bounds[si + 1]
            assert hi > lo, f"reshard to {s_new}: shard {si} would be empty"
            sub = self._new_shard()
            sub._reassemble(codes[lo:hi], gid[lo:hi], assign[lo:hi], None)
            sub._next_id = self._next_gid
            shards.append(sub)
            if g_all is not None:
                sel = np.isin(g_all, gid[lo:hi])
                self._t_gids[si].append(g_all[sel])
                for name, arr in stores.items():
                    if arr is not None:
                        getattr(self, name)[si].append(arr[sel])
        self._shards = shards
        self._tier_cache = {}
        self._dev = None
