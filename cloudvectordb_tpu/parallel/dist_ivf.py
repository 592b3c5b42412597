"""Sharded IVF-PQ over a device mesh (BASELINE config #4: 100M×768d).

Design: the coarse quantizer and PQ codebooks are trained ONCE on a global
sample and replicated (they're tiny); the *rows* are partitioned across the
'shard' axis, each shard holding its own list-sorted code arena in HBM. A
query runs the probe-scan on every shard in parallel (shard_map), and the
per-shard partial top-k is all-gathered and reduced — identical
recall semantics to a single IVF-PQ index with the same nprobe, because every
shard probes its own copy of the same global lists.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cloudvectordb_tpu.index.ivf_pq import IVFPQIndex, _ivfpq_scan_search
from cloudvectordb_tpu.eval.tune import TunableMixin
from cloudvectordb_tpu.index.range import RangeSearchMixin
from cloudvectordb_tpu.index.pq import pq_encode
from cloudvectordb_tpu.ops.assign import assign_clusters
from cloudvectordb_tpu.parallel.mesh import make_mesh


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "k_cand", "nprobe", "cap", "metric", "residual", "mesh",
        "refine_scale", "refine_residual",
    ),
)
def _sharded_ivfpq_search(
    q, centroids, codebooks, codes, ids, offsets, lens, refine_rows,
    *, k, k_cand, nprobe, cap, metric, residual, mesh, refine_scale: float,
    refine_residual: bool = False,
):
    """codes (S·maxn, m) row-sharded; offsets/lens/ids/refine_rows sharded on
    axis 0. Refinement rescoring runs SHARD-LOCALLY (each shard holds the
    int8 rows for its partition, staged ARENA-ordered) before the tiny
    all_gather merge. refine_residual: rows are rotated-space residuals —
    the centroid term is recovered exactly via _refine_rescore (r3 port of
    the band family's residual refine). On a 2-D ('replica', 'shard') mesh
    the query batch additionally splits across replicas (each replica
    column holds a full index copy)."""
    from cloudvectordb_tpu.index.ivf_pq import _refine_rescore

    qs = P("replica") if "replica" in mesh.axis_names else P()

    def local(qb, c, cb, codes_l, ids_l, off_l, lens_l, rr):
        v, i = _ivfpq_scan_search(
            qb, c, codes_l, off_l[0], lens_l[0], cb,
            k=k_cand, nprobe=nprobe, cap=cap, metric=metric, residual=residual,
        )
        if refine_scale > 0:
            # refine rows are arena-ordered per shard → the row itself is
            # the store key (identity id table). The arena is contiguous,
            # so full offsets = offsets[:-1] ++ [offsets[-1] + last len].
            off_full = jnp.concatenate(
                [off_l[0], off_l[0][-1:] + lens_l[0][-1:]])
            # a range-escalated k can exceed k_cand (capped at the largest
            # shard's ntotal): rescore what exists, pad the width back to k
            # with (-inf, 0) — the scan's own unfilled-slot convention
            k_loc = min(k, k_cand)
            v, i = _refine_rescore(
                qb, qb, v, i,
                jnp.arange(rr.shape[0], dtype=jnp.int32), rr, c, off_full,
                refine_scale,
                k=k_loc, metric=metric, refine_residual=refine_residual,
            )
            if k_loc < k:
                pad = k - k_loc
                v = jnp.concatenate(
                    [v, jnp.full((v.shape[0], pad), -jnp.inf, v.dtype)], 1)
                i = jnp.concatenate(
                    [i, jnp.zeros((i.shape[0], pad), i.dtype)], 1)
        else:
            v = v[:, :k]
            i = i[:, :k]
        # map local rows → global ids through this shard's id table
        gid = jnp.take_along_axis(ids_l[0][None, :].repeat(i.shape[0], 0), i, axis=1)
        all_v = lax.all_gather(v, "shard", axis=0)  # (S, B, k)
        all_i = lax.all_gather(gid, "shard", axis=0)
        s, b, kk = all_v.shape
        cand_v = jnp.transpose(all_v, (1, 0, 2)).reshape(b, s * kk)
        cand_i = jnp.transpose(all_i, (1, 0, 2)).reshape(b, s * kk)
        best_v, pos = lax.top_k(cand_v, k)
        return best_v, jnp.take_along_axis(cand_i, pos, axis=1)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(
            qs, P(), P(), P("shard"), P("shard"), P("shard"), P("shard"),
            P("shard"),
        ),
        out_specs=(qs, qs),
        check_vma=False,
    )(q, centroids, codebooks, codes, ids, offsets, lens, refine_rows)


class ShardedIVFPQIndex(TunableMixin, RangeSearchMixin):
    """Row-partitioned IVF-PQ with replicated quantizers."""

    def __init__(self, mesh: Mesh | None = None, refine: str = "none", **ivfpq_kw):
        self.mesh = mesh or make_mesh(axis_name="shard")
        ivfpq_kw.pop("refine", None)  # refinement lives in the wrapper: rows
        self.kw = ivfpq_kw            # stay shard-local and arena-ordered
        # the wrapper's query path never rotates: OPQ belongs to the band
        # family's sharded build (ShardedBandIndex/BandIVFPQIndex)
        assert ivfpq_kw.get("opq_matrix") is None, (
            "ShardedIVFPQIndex does not support OPQ")
        self.refine = refine
        self.metric = ivfpq_kw.get("metric", "ip")
        self.residual = ivfpq_kw.get("residual", True)
        # residual refine (r3): rows store int8 RESIDUALS (x − list
        # centroid) — centroid term recovered exactly at rescore
        self._refine_residual = self.residual and refine == "int8"
        self._shards: list[IVFPQIndex] = []
        # per-shard int8 refine rows in INSERTION order + their global ids;
        # arena order changes on every add+merge, so rows are permuted to
        # arena order lazily at device-staging time via an id lookup. This
        # is what makes add() work with refinement (r1 raised here).
        self._refine_rows_ins: list[list[np.ndarray]] = []
        self._refine_gids_ins: list[list[np.ndarray]] = []
        self._refine_scale = 0.0
        self._dev = None
        self._next_id = 0

    @property
    def nshards(self) -> int:
        return self.mesh.shape["shard"]

    @property
    def ntotal(self) -> int:
        return sum(s.ntotal for s in self._shards)

    @staticmethod
    def _refine_src(vectors, centroids) -> np.ndarray:
        """Residuals of ``vectors`` vs their assigned list centroid — the
        residual-refine store's source rows (device assign, host result)."""
        xv = jnp.asarray(vectors, jnp.float32)
        cdev = jnp.asarray(centroids)
        a, _ = assign_clusters(xv, cdev)
        return np.asarray(xv - cdev[a])

    @classmethod
    def build(
        cls, vectors, nlist: int, m: int = 64, mesh: Mesh | None = None,
        train_sample: int = 262_144, **kw,
    ) -> "ShardedIVFPQIndex":
        vectors = np.asarray(vectors, np.float32)
        idx = cls(mesh, nlist=nlist, m=m, **kw)
        s = idx.nshards
        dim = vectors.shape[1]
        # shared quantizers from a global sample
        proto = IVFPQIndex(dim, nlist, m=m, **kw)
        ns = min(train_sample, vectors.shape[0])
        sel = np.random.default_rng(proto.seed).choice(
            vectors.shape[0], ns, replace=False
        )
        proto.train(vectors[sel])
        # contiguous row partition; each shard reuses the shared quantizers
        # and stores GLOBAL ids directly in its arena.
        if idx.refine == "int8":
            src = (idx._refine_src(vectors[sel], proto.centroids)
                   if idx._refine_residual else vectors)
            rms = float(np.sqrt(np.mean(src.astype(np.float64) ** 2)))
            amax = float(np.abs(src).max())
            idx._refine_scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
        bounds = np.linspace(0, vectors.shape[0], s + 1).astype(int)
        for si in range(s):
            sub = IVFPQIndex(dim, nlist, m=m, **kw)
            sub.centroids = proto.centroids
            sub.codebooks = proto.codebooks
            gids = np.arange(bounds[si], bounds[si + 1], dtype=np.int64)
            sub.add(vectors[bounds[si] : bounds[si + 1]], ids=gids)
            sub.merge_pending()
            idx._shards.append(sub)
            idx._refine_rows_ins.append([])
            idx._refine_gids_ins.append([])
            if idx.refine == "int8":
                block = vectors[bounds[si] : bounds[si + 1]]
                if idx._refine_residual:
                    block = idx._refine_src(block, proto.centroids)
                idx._refine_rows_ins[si].append(
                    np.clip(np.round(block / idx._refine_scale), -127, 127
                            ).astype(np.int8)
                )
                idx._refine_gids_ins[si].append(gids)
        idx._next_id = int(vectors.shape[0])
        idx._dev = None
        return idx

    @classmethod
    def build_streaming(
        cls, chunks, nlist: int, m: int = 64, mesh: Mesh | None = None,
        train_sample: int = 262_144, **kw,
    ) -> "ShardedIVFPQIndex":
        """Config-#4 build from a chunk iterator: quantizers train on the
        first chunk; every chunk is assigned + residual-PQ-encoded on device
        and only its m-byte codes (+ int8 refine rows when enabled) reach the
        host, split across shards. The f32 corpus never exists in one piece
        — host peak is m bytes/row (+ dim bytes/row with refine)."""
        idx = cls(mesh, nlist=nlist, m=m, **kw)
        s = idx.nshards
        proto = None
        codes_acc: list[list[np.ndarray]] = [[] for _ in range(s)]
        assigns_acc: list[list[np.ndarray]] = [[] for _ in range(s)]
        gids_acc: list[list[np.ndarray]] = [[] for _ in range(s)]
        idx._refine_rows_ins = [[] for _ in range(s)]
        idx._refine_gids_ins = [[] for _ in range(s)]
        next_id = 0
        for chunk in chunks:
            chunk = jnp.asarray(chunk, jnp.float32)
            if proto is None:
                proto = IVFPQIndex(int(chunk.shape[1]), nlist, m=m, **kw)
                ns = min(train_sample, chunk.shape[0])
                proto.train(np.asarray(chunk[:ns]))
                cdev = jnp.asarray(proto.centroids)
                cbdev = jnp.asarray(proto.codebooks)
            a, _ = assign_clusters(chunk, cdev)
            enc_in = chunk - cdev[a] if idx.residual else chunk
            codes = pq_encode(enc_in, cbdev)
            if idx.refine == "int8":
                rsrc = enc_in if idx._refine_residual else chunk
                if idx._refine_scale == 0.0:  # first chunk sets the scale
                    rms = float(jnp.sqrt(jnp.mean(rsrc * rsrc)))
                    amax = float(jnp.max(jnp.abs(rsrc)))
                    idx._refine_scale = max(min(amax, 4.0 * rms) / 127.0,
                                            1e-12)
                rows8_h = np.asarray(jnp.clip(
                    jnp.round(rsrc / idx._refine_scale), -127, 127
                ).astype(jnp.int8))
            else:
                rows8_h = None
            codes_h, a_h = np.asarray(codes), np.asarray(a)
            b = codes_h.shape[0]
            ids_h = np.arange(next_id, next_id + b, dtype=np.int64)
            next_id += b
            for si, sl in enumerate(np.array_split(np.arange(b), s)):
                if not sl.size:
                    continue
                codes_acc[si].append(codes_h[sl])
                assigns_acc[si].append(a_h[sl])
                gids_acc[si].append(ids_h[sl])
                if rows8_h is not None:
                    idx._refine_rows_ins[si].append(rows8_h[sl])
                    idx._refine_gids_ins[si].append(ids_h[sl])
        assert proto is not None, "empty stream"
        for si in range(s):
            assert codes_acc[si], f"shard {si} received no rows"
            sub = IVFPQIndex(proto.dim, nlist, m=m, **kw)
            sub.centroids = proto.centroids
            sub.codebooks = proto.codebooks
            sub._arena.rebuild(
                np.concatenate(codes_acc[si]),
                np.concatenate(gids_acc[si]),
                np.concatenate(assigns_acc[si]),
            )
            sub._next_id = next_id
            idx._shards.append(sub)
        idx._next_id = next_id
        idx._dev = None
        return idx

    def add(self, vectors) -> None:
        """Append to the smallest shard (keeps shards balanced); global ids.
        Works with refinement: the batch's int8 rows join the shard's
        insertion-order store and are re-staged in arena order on the next
        device upload."""
        assert self._shards, "build() first"
        vectors = np.asarray(vectors, np.float32)
        si = int(np.argmin([s.ntotal for s in self._shards]))
        n = vectors.shape[0]
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        self._shards[si].add(vectors, ids=ids)
        self._shards[si].merge_pending()
        if self.refine == "int8":
            # the scale is fixed at build time; out-of-range rows clip
            src = (self._refine_src(vectors, self._shards[si].centroids)
                   if self._refine_residual else vectors)
            self._refine_rows_ins[si].append(
                np.clip(np.round(src / self._refine_scale), -127, 127
                        ).astype(np.int8)
            )
            self._refine_gids_ins[si].append(ids)
        self._dev = None

    def remove(self, ids) -> int:
        """Delete by global id: each shard compacts the ids it owns
        (IVFPQIndex.remove; unknown ids are ignored per shard). The
        wrapper's gid-keyed insertion-order refine store keeps stale rows
        for removed ids — _refine_arena_order only looks up SURVIVING
        arena ids, so stale rows cost bytes, not correctness. Freed ids
        are never reused (_next_id is monotonic)."""
        total = sum(sh.remove(ids) for sh in self._shards)
        if total:
            self._dev = None
        return total

    def _refine_arena_order(self, si: int) -> np.ndarray:
        """This shard's int8 refine rows permuted into CURRENT arena order
        (store keyed by global id; arena order changes on every merge)."""
        rows = np.concatenate(self._refine_rows_ins[si])
        gids = np.concatenate(self._refine_gids_ins[si])
        arena_ids = self._shards[si]._arena.ids
        sort_idx = np.argsort(gids, kind="stable")
        pos = sort_idx[np.searchsorted(gids[sort_idx], arena_ids)]
        return rows[pos]

    def _device_state(self):
        if self._dev is not None:
            return self._dev
        from cloudvectordb_tpu.parallel.mesh import stage_row_sharded

        s = self.nshards
        max_n = max(sh._arena.size for sh in self._shards)
        max_n = -(-max_n // 8) * 8
        m = self.kw.get("m", 64)
        dim = self._shards[0].dim
        cap = max([8] + [sh._arena.max_list_len for sh in self._shards])

        # per-shard pieces go straight to their device — the dense host
        # concat doubled host memory at scale
        def codes_piece(si):
            ar = self._shards[si]._arena
            out = np.zeros((max_n, m), np.uint8)
            out[: ar.size] = ar.payload
            return out

        def ids_piece(si):
            ar = self._shards[si]._arena
            out = np.zeros((1, max_n), np.int32)
            out[0, : ar.size] = ar.ids  # arena ids are already global
            return out

        def refine_piece(si):
            if self.refine != "int8":
                return np.zeros((1, 1), np.int8)
            rr = self._refine_arena_order(si)
            out = np.zeros((max_n, dim), np.int8)
            out[: rr.shape[0]] = rr
            return out

        from cloudvectordb_tpu.parallel.mesh import stage_replicated

        self._dev = dict(
            centroids=stage_replicated(self._shards[0].centroids, self.mesh),
            codebooks=stage_replicated(self._shards[0].codebooks, self.mesh),
            codes=stage_row_sharded(codes_piece, s, self.mesh),
            ids=stage_row_sharded(ids_piece, s, self.mesh),
            offsets=stage_row_sharded(
                lambda si: self._shards[si]._arena.offsets[:-1][None]
                .astype(np.int32), s, self.mesh),
            lens=stage_row_sharded(
                lambda si: self._shards[si]._arena.list_lens[None]
                .astype(np.int32), s, self.mesh),
            refine=stage_row_sharded(refine_piece, s, self.mesh),
            cap=cap,
        )
        return self._dev

    # -- persistence ------------------------------------------------------
    kind = "sharded_ivf_pq"

    def save(self, path, extra_meta: dict | None = None) -> None:
        """One atomic directory: per-shard IVF-PQ artifacts + the wrapper's
        insertion-order refine stores (rows keyed by global id — re-permuted
        to arena order at device staging, so they survive future merges)."""
        from cloudvectordb_tpu.parallel.persist import save_sharded

        def cat(chunks):
            return np.concatenate(chunks) if chunks else None

        extras = None
        if self.refine == "int8":
            extras = {
                "refine_rows": [cat(c) for c in self._refine_rows_ins],
                "refine_gids": [cat(c) for c in self._refine_gids_ins],
            }
        save_sharded(
            path,
            {
                "kind": self.kind, "kw": self.kw, "refine": self.refine,
                "refine_scale": self._refine_scale, "next_id": self._next_id,
                "op_point": self._op_point, **(extra_meta or {}),
            },
            self._shards,
            extras_per_shard=extras,
        )

    @classmethod
    def load(cls, path, mesh: Mesh | None = None,
             mmap: bool = True) -> "ShardedIVFPQIndex":
        from cloudvectordb_tpu.parallel.persist import (
            load_extras, load_shards, read_sharded_manifest)

        man = read_sharded_manifest(path)
        assert man["kind"] == cls.kind, man["kind"]
        if mesh is None:
            mesh = make_mesh(man["nshards"], axis_name="shard")
        idx = cls(mesh, refine=man["refine"], **man.get("kw", {}))
        idx._shards = load_shards(path, man, mmap=mmap)
        idx._refine_scale = man["refine_scale"]
        idx._next_id = man["next_id"]
        rows = load_extras(path, man, "refine_rows", mmap=mmap)
        gids = load_extras(path, man, "refine_gids", mmap=mmap)
        idx._refine_rows_ins = [[r] if r is not None else []
                                for r in (rows or [None] * man["nshards"])]
        idx._refine_gids_ins = [[g] if g is not None else []
                                for g in (gids or [None] * man["nshards"])]
        if not rows:  # refine='none' artifacts carry no extras
            idx._refine_rows_ins = [[] for _ in range(man["nshards"])]
            idx._refine_gids_ins = [[] for _ in range(man["nshards"])]
        if idx.nshards != man["nshards"]:
            idx._do_reshard(idx.nshards)  # elastic reshard (see _do_reshard)
        if man.get("op_point"):
            idx._op_point = dict(man["op_point"])
        return idx

    def _do_reshard(self, s_new: int) -> None:
        """Elastic reshard onto a different shard count (mesh 'shard' extent
        ≠ saved count at load): every shard's PQ codes export once and move
        VERBATIM (the quantizers are shared across shards by construction —
        no re-encoding), rows sort by global id and split contiguously, and
        each new shard runs one native arena sort. The wrapper's gid-keyed
        int8 refine store re-partitions by membership against each new
        shard's arena ids (stale rows for removed ids drop out here)."""
        codes_l, gids_l, asg_l = [], [], []
        for sh in self._shards:
            sh.merge_pending()
            ar = sh._arena
            codes_l.append(np.asarray(ar.payload))
            gids_l.append(np.asarray(ar.ids, np.int64))
            asg_l.append(np.repeat(np.arange(sh.nlist), ar.list_lens))
        codes = np.concatenate(codes_l)
        gid = np.concatenate(gids_l)
        assign = np.concatenate(asg_l).astype(np.int32)
        order = np.argsort(gid, kind="stable")
        codes, gid, assign = codes[order], gid[order], assign[order]
        proto = self._shards[0]
        if self.refine == "int8":
            r_all = np.concatenate([np.concatenate(c)
                                    for c in self._refine_rows_ins if c])
            g_all = np.concatenate([np.concatenate(c)
                                    for c in self._refine_gids_ins if c])
        bounds = np.linspace(0, gid.shape[0], s_new + 1).astype(int)
        shards, rows_ins, gids_ins = [], [], []
        for si in range(s_new):
            lo, hi = bounds[si], bounds[si + 1]
            assert hi > lo, f"reshard to {s_new}: shard {si} would be empty"
            sub = IVFPQIndex(proto.dim, **self.kw)
            sub.centroids = np.asarray(proto.centroids)
            sub.codebooks = np.asarray(proto.codebooks)
            sub._arena.merge(codes[lo:hi], gid[lo:hi], assign[lo:hi])
            shards.append(sub)
            if self.refine == "int8":
                sel = np.isin(g_all, gid[lo:hi])
                rows_ins.append([r_all[sel]])
                gids_ins.append([g_all[sel]])
            else:
                rows_ins.append([])
                gids_ins.append([])
        self._shards = shards
        self._refine_rows_ins = rows_ins
        self._refine_gids_ins = gids_ins
        self._dev = None

    # -- op-point tuning: tune()/_op_point from TunableMixin; the ladder is
    # the single-index family's (same nprobe/refine_factor search kwargs,
    # same nlist/refine config) — delegate instead of re-implementing
    def _tune_candidates(self, nq: int) -> list[dict]:
        return self._shards[0]._tune_candidates(nq)

    def _tune_reference_kw(self, nq: int) -> dict:
        return self._shards[0]._tune_reference_kw(nq)

    def search(self, queries, k: int, nprobe: int | None = None,
               batch: int = 256, refine_factor: int | None = None):
        queries = np.asarray(queries, np.float32)
        st = self._device_state()
        op = self._op_point or {}  # tuned knobs fill sentinel defaults
        if nprobe is None:
            nprobe = op.get("nprobe", 8)
        if refine_factor is None:
            refine_factor = op.get("refine_factor", 16)
        nprobe = min(nprobe, self.kw["nlist"])
        do_refine = self.refine == "int8" and any(self._refine_rows_ins)
        per_shard = max(sh.ntotal for sh in self._shards)
        k_cand = min(max(k * refine_factor, 32), per_shard) if do_refine else k
        from cloudvectordb_tpu.parallel.mesh import (
            assert_equal_across_processes, fetch_local, stage_queries)

        n_rep = dict(zip(self.mesh.axis_names,
                         self.mesh.devices.shape)).get("replica", 1)
        nproc = jax.process_count()
        if nproc > 1:
            # multi-host: queries are THIS process's traffic (per-host
            # slices on a replica-per-process mesh; the identical
            # broadcast batch otherwise — stage_queries verifies content).
            # The TOTAL count must match across hosts BEFORE the batch
            # loop: a host with more chunks would enter the collective
            # alone and deadlock it.
            # k_cand subsumes refine_factor (the only way it reaches the
            # compiled program); do_refine/metric derive from index state,
            # which the mutation contract keeps identical across hosts
            assert_equal_across_processes(
                (queries.shape[0], k, k_cand, nprobe, batch),
                "sharded IVF-PQ search batch")
        outs_v, outs_i = [], []
        for s0 in range(0, queries.shape[0], batch):
            qh = queries[s0 : s0 + batch]
            pad = (-qh.shape[0]) % (1 if nproc > 1 else n_rep)
            if pad:  # each replica's slice must be equal-sized
                qh = np.concatenate([qh, np.repeat(qh[-1:], pad, axis=0)])
            real = qh.shape[0] - pad
            qb = stage_queries(qh, self.mesh)
            v, i = _sharded_ivfpq_search(
                qb, st["centroids"], st["codebooks"], st["codes"], st["ids"],
                st["offsets"], st["lens"], st["refine"],
                k=k, k_cand=k_cand, nprobe=nprobe, cap=st["cap"],
                metric=self.metric, residual=self.residual, mesh=self.mesh,
                refine_scale=self._refine_scale if do_refine else 0.0,
                refine_residual=self._refine_residual,
            )
            outs_v.append(fetch_local(v)[:real])
            outs_i.append(fetch_local(i)[:real])
        return np.concatenate(outs_v), np.concatenate(outs_i)
