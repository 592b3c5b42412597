"""Sharded tile-pruned serving index — BASELINE config #4's fast path.

Rows partition across the 'shard' mesh axis; the coarse quantizer is shared
(trained once, replicated). Every device plans + scans its own int8 arena
with the tile scan, then the partial top-k merge rides one all_gather
(S·B·k floats; NCCL over NVLink on a multi-GPU host). Identical code on a
simulated CPU mesh and on real cards.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cloudvectordb_tpu.index.ivf_band import BandIVFIndex, _tiles_plan_search
from cloudvectordb_tpu.index.kmeans import train_kmeans
from cloudvectordb_tpu.eval.tune import TunableMixin
from cloudvectordb_tpu.index.range import RangeSearchMixin
from cloudvectordb_tpu.ops.backend import scan_impl
from cloudvectordb_tpu.ops.pallas_band import order_centroids
from cloudvectordb_tpu.parallel.mesh import make_mesh


@functools.partial(
    jax.jit,
    static_argnames=("k", "p_tiles", "tile_n", "tile_q", "impl", "mesh",
                     "int8_mode", "l2"),
)
def _sharded_band_search(
    q, centroids, payload, ids, tile_window, n_valid, db_scale,
    local_ids=None, valid_end=None, allowed=None,
    *, k, p_tiles, tile_n, tile_q, impl, mesh, int8_mode=True,
    l2: bool = False,
):
    """payload (S·n_pad, D) int8 row-sharded; ids (S, n_pad), tile_window
    (S, n_tiles, W), n_valid (S,) true per-shard row counts — all sharded on
    axis 0; queries/centroids replicated. Without the per-shard count the
    kernel's pad mask would use the (shared) padded size and zero-pad rows
    of short shards would surface as phantom global-id-0 candidates.
    local_ids (S, 1, n_pad) + valid_end (S, n_tiles, W) switch the
    per-shard scan to the residual-int8 form (its masking is per
    tile-list, not a scalar count — see ops/pallas_band.py)."""
    from cloudvectordb_tpu.index.ivf_band import _tiles_resid_plan_search

    residual = local_ids is not None
    # 2-D ('replica', 'shard') mesh: query batch splits across replicas
    # (each holding a full index copy), rows split across shards. On a 1-D
    # mesh queries are replicated. Identical kernel + merge either way.
    qs = P("replica") if "replica" in mesh.axis_names else P()

    def merge(v, gid):
        all_v = lax.all_gather(v, "shard", axis=0)  # (S, B, k)
        all_i = lax.all_gather(gid, "shard", axis=0)
        s, b, kk = all_v.shape
        cand_v = jnp.transpose(all_v, (1, 0, 2)).reshape(b, s * kk)
        cand_i = jnp.transpose(all_i, (1, 0, 2)).reshape(b, s * kk)
        # per-shard scans can surface fewer than k candidates (the kernel's
        # bucket pool), so the merged pool can be narrower than a
        # range-escalated k — return the pool width, never crash top_k
        best_v, pos = lax.top_k(cand_v, min(k, s * kk))
        return best_v, jnp.take_along_axis(cand_i, pos, axis=1)

    if residual:
        # filtered search: the replicated allow bitmap (global-id keyed)
        # reaches every shard, which gathers it through its own global-id
        # table into arena order (index/filters.py)
        def local(qb, c, pay, ids_l, tw, loc, ve, *alw):
            v, gid = _tiles_resid_plan_search(
                qb, c, pay, loc[0], db_scale, ids_l[0], tw[0], ve[0],
                allowed=alw[0] if alw else None,
                k=k, p_tiles=p_tiles, tile_n=tile_n, tile_q=tile_q,
                impl=impl,
                int8_q=(int8_mode != "precise"),  # scoring='precise' plumb
                l2=l2,  # per-shard −‖q−x̂‖² keys merge comparably (same q)
            )
            return merge(v, gid)

        specs = [qs, P(), P("shard"), P("shard"), P("shard"),
                 P("shard"), P("shard")]
        args = [q, centroids, payload, ids, tile_window,
                local_ids, valid_end]
        if allowed is not None:
            specs.append(P())
            args.append(allowed)
        return shard_map(
            local, mesh=mesh,
            in_specs=tuple(specs),
            out_specs=(qs, qs),
            check_vma=False,
        )(*args)
    assert allowed is None, (
        "filtered sharded search needs residual-int8 shards")

    def local(qb, c, pay, ids_l, tw, nv):
        v, gid = _tiles_plan_search(
            qb, c, pay, ids_l[0], tw[0], db_scale, nv[0],
            k=k, p_tiles=p_tiles, tile_n=tile_n, tile_q=tile_q,
            # whole-row int8 arenas have no f32 path; 'precise' → hybrid
            int8=("hybrid" if int8_mode == "precise" else int8_mode),
            impl=impl,
        )
        return merge(v, gid)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(qs, P(), P("shard"), P("shard"), P("shard"), P("shard")),
        out_specs=(qs, qs),
        check_vma=False,
    )(q, centroids, payload, ids, tile_window, n_valid)


class ShardedBandIndex(TunableMixin, RangeSearchMixin):
    """Row-partitioned BandIVFIndex with a shared coarse quantizer."""

    def __init__(self, mesh: Mesh | None = None, **band_kw):
        self.mesh = mesh or make_mesh(axis_name="shard")
        self.kw = band_kw
        self._shards: list[BandIVFIndex] = []
        self._dev = None
        self._scale = 1.0

    @property
    def nshards(self) -> int:
        return self.mesh.shape["shard"]

    @property
    def ntotal(self) -> int:
        return sum(s.ntotal for s in self._shards)

    @property
    def metric(self) -> str:
        return (self._shards[0].metric if self._shards
                else self.kw.get("metric", "ip"))

    @classmethod
    def build(cls, vectors, nlist: int, mesh: Mesh | None = None,
              train_sample: int = 262_144, **kw) -> "ShardedBandIndex":
        vectors = np.asarray(vectors, np.float32)
        idx = cls(mesh, **kw)
        s = idx.nshards
        dim = vectors.shape[1]
        ns = min(train_sample, vectors.shape[0])
        proto = BandIVFIndex(dim, nlist, **kw)
        sel = np.random.default_rng(proto.seed).choice(
            vectors.shape[0], ns, replace=False)
        c, _ = train_kmeans(jnp.asarray(vectors[np.sort(sel)]), nlist,
                            iters=proto.kmeans_iters, seed=proto.seed)
        c = np.asarray(c)
        centroids = c[order_centroids(c)]
        bounds = np.linspace(0, vectors.shape[0], s + 1).astype(int)
        for si in range(s):
            sub = BandIVFIndex(dim, nlist, **kw)
            sub.centroids = centroids
            sub._populate(jnp.asarray(vectors[bounds[si] : bounds[si + 1]]))
            # global ids = local order + partition base; slack arenas mark
            # hole slots with -1 — those must NOT be offset into the valid
            # id range (a phantom would alias a real row's id)
            ids = np.asarray(sub._ids, np.int64)
            sub._ids = np.where(ids >= 0, ids + bounds[si], -1).astype(
                np.int32)
            idx._shards.append(sub)
        # one global dequant scale (max across shards keeps scores comparable)
        idx._scale = max(sh._scale for sh in idx._shards)
        return idx

    @classmethod
    def build_streaming(
        cls, chunks, nlist: int, mesh: Mesh | None = None,
        train_sample: int = 262_144, **kw,
    ) -> "ShardedBandIndex":
        """Config-#4-scale build WITHOUT materializing the f32 corpus on the
        host: consume device-resident embedding chunks (e.g. straight from
        encode_corpus megabatches), train the shared quantizer on the first
        chunk, assign+int8-quantize every chunk on device, and split each
        chunk's compact payload across shards (balanced regardless of chunk
        count). Each shard assembles its arena once with the native sort.
        Host peak memory is the int8 payload (1 byte/dim), 4× under f32."""
        import jax.numpy as jnp

        from cloudvectordb_tpu.index.kmeans import train_kmeans
        from cloudvectordb_tpu.ops.assign import assign_clusters

        idx = cls(mesh, **kw)
        s = idx.nshards
        proto = None
        scale = 1e-12
        payloads: list[list[np.ndarray]] = [[] for _ in range(s)]
        assigns: list[list[np.ndarray]] = [[] for _ in range(s)]
        gids: list[list[np.ndarray]] = [[] for _ in range(s)]
        next_id = 0
        for chunk in chunks:
            chunk = jnp.asarray(chunk, jnp.float32)
            if proto is None:
                proto = BandIVFIndex(int(chunk.shape[1]), nlist, **kw)
                assert proto.dtype == "int8", "streaming build is the int8 path"
                ns = min(train_sample, chunk.shape[0])
                c, _ = train_kmeans(chunk[:ns], nlist,
                                    iters=proto.kmeans_iters, seed=proto.seed)
                c = np.asarray(c)
                centroids = c[order_centroids(c)]
                cdev = jnp.asarray(centroids)
            a, _ = assign_clusters(chunk, cdev)
            if proto._resid8:
                chunk = chunk - cdev[a]
            if scale == 1e-12:  # first chunk sets the (residual-aware) scale
                rms = float(jnp.sqrt(jnp.mean(chunk * chunk)))
                amax = float(jnp.max(jnp.abs(chunk)))
                scale = max(min(amax, 4.0 * rms) / 127.0, 1e-12)
            q8 = jnp.clip(jnp.round(chunk / scale), -127, 127).astype(jnp.int8)
            q8_h, a_h = np.asarray(q8), np.asarray(a)
            b = q8_h.shape[0]
            ids_h = np.arange(next_id, next_id + b, dtype=np.int64)
            next_id += b
            for si, sl in enumerate(np.array_split(np.arange(b), s)):
                if sl.size:
                    payloads[si].append(q8_h[sl])
                    assigns[si].append(a_h[sl])
                    gids[si].append(ids_h[sl])
        assert proto is not None, "empty stream"
        for si in range(s):
            assert payloads[si], f"shard {si} received no rows"
            sub = BandIVFIndex(proto.dim, nlist, **kw)
            sub.centroids = centroids
            sub._scale = scale
            sub._assemble_compact(
                np.concatenate(payloads[si]),
                np.concatenate(gids[si]),
                np.concatenate(assigns[si]),
            )
            idx._shards.append(sub)
        idx._scale = scale
        return idx

    def _device_state(self):
        if self._dev is not None:
            return self._dev
        from cloudvectordb_tpu.parallel.mesh import stage_row_sharded

        s = self.nshards
        tile_n = self._shards[0].tile_n
        max_pad = max(int(sh._payload.shape[0]) for sh in self._shards)
        max_pad = -(-max_pad // tile_n) * tile_n
        n_tiles = max_pad // tile_n
        w = max(sh._tile_window.shape[1] for sh in self._shards)
        dim = self._shards[0].dim

        # per-shard pieces staged straight onto their device (one at a time:
        # the dense (S, max_pad, dim) host concat doubled host memory at
        # 100M-scale)
        def payload_piece(si):
            sh = self._shards[si]
            p = np.asarray(sh._payload)
            if sh._scale != self._scale:  # requantize under the global scale
                p = np.clip(np.round(p.astype(np.float32)
                                     * (sh._scale / self._scale)), -127, 127
                            ).astype(np.int8)
            out = np.zeros((max_pad, dim), np.int8)
            out[: p.shape[0]] = p
            return out

        def ids_piece(si):
            out = np.zeros((1, max_pad), np.int32)
            out[0, : self._shards[si]._ids.shape[0]] = self._shards[si]._ids
            return out

        def tw_piece(si):
            stw = self._shards[si]._tile_window
            # pad rows (tiles) by repeating the last window, columns by
            # repeating each row's last list id (idempotent for max-scoring)
            if stw.shape[0] < n_tiles:
                stw = np.concatenate(
                    [stw, np.repeat(stw[-1:], n_tiles - stw.shape[0], axis=0)]
                )
            if stw.shape[1] < w:
                stw = np.concatenate(
                    [stw, np.repeat(stw[:, -1:], w - stw.shape[1], axis=1)],
                    axis=1,
                )
            return stw[None].astype(np.int32)

        from cloudvectordb_tpu.parallel.mesh import stage_replicated

        self._dev = dict(
            centroids=stage_replicated(self._shards[0].centroids, self.mesh),
            payload=stage_row_sharded(payload_piece, s, self.mesh),
            ids=stage_row_sharded(ids_piece, s, self.mesh),
            tile_window=stage_row_sharded(tw_piece, s, self.mesh),
            n_valid=stage_row_sharded(
                lambda si: np.asarray([self._shards[si]._n], np.int32),
                s, self.mesh),
            n_tiles=n_tiles,
        )
        if self._shards[0]._resid8:
            # per-row local list idx (pad rows: 0, masked by valid_end)
            def local_piece(si):
                out = np.zeros((1, 1, max_pad), np.uint8)
                sl = self._shards[si]._local
                out[0, 0, : sl.shape[1]] = sl[0]
                return out

            def ve_piece(si):
                # pad tiles/columns stay 0 → fully masked in-kernel
                out = np.zeros((1, n_tiles, w), np.int32)
                sve = self._shards[si]._valid_end
                out[0, : sve.shape[0], : sve.shape[1]] = sve
                return out

            self._dev["local"] = stage_row_sharded(local_piece, s, self.mesh)
            self._dev["valid_end"] = stage_row_sharded(ve_piece, s, self.mesh)
        return self._dev

    # -- persistence ------------------------------------------------------
    kind = "sharded_band_ivf"

    def save(self, path, extra_meta: dict | None = None) -> None:
        """Persist every shard (atomic single-index artifacts) + a top-level
        manifest under ONE directory — see parallel/persist.py. Device-
        resident shard arenas are fetched to the host once by each shard's
        ``_state_arrays`` (a PCIe copy on real hardware)."""
        from cloudvectordb_tpu.parallel.persist import save_sharded

        save_sharded(
            path,
            {"kind": self.kind, "scale": self._scale, "kw": self.kw,
             "op_point": self._op_point, **(extra_meta or {})},
            self._shards,
        )

    @classmethod
    def load(cls, path, mesh: Mesh | None = None,
             mmap: bool = True) -> "ShardedBandIndex":
        """Rebuild the wrapper from a saved artifact. ``mesh`` defaults to a
        fresh 1-D 'shard' mesh sized to the saved shard count (rows re-stage
        onto devices lazily on the first search). A mesh with a DIFFERENT
        'shard' extent triggers an elastic reshard: rows re-partition onto
        the new topology host-side (one native re-sort per new shard, ids/
        scores unchanged — search parity is exact up to the one global
        requantize when per-shard scales differed)."""
        from cloudvectordb_tpu.parallel.persist import (
            load_shards, read_sharded_manifest)

        man = read_sharded_manifest(path)
        assert man["kind"] == cls.kind, man["kind"]
        if mesh is None:
            mesh = make_mesh(man["nshards"], axis_name="shard")
        idx = cls(mesh, **man.get("kw", {}))
        idx._scale = man["scale"]
        shards = load_shards(path, man, mmap=mmap)
        if idx.nshards != man["nshards"]:
            shards = cls._reshard(shards, idx.nshards, man["scale"], idx.kw)
        idx._shards = shards
        if man.get("op_point"):
            idx._op_point = dict(man["op_point"])
        return idx

    @staticmethod
    def _reshard(shards: list[BandIVFIndex], s_new: int, scale: float,
                 kw: dict) -> list[BandIVFIndex]:
        """Re-partition loaded shard rows onto a different shard count —
        8 ↔ 16 shards without a rebuild. Every shard's valid
        rows export once (quantized payloads move verbatim; int8 payloads
        requantize to the wrapper's global scale where a shard's differed),
        sort by global id, and split contiguously; each new shard runs one
        native arena sort. Quantizers are shared across shards by
        construction, so no re-training or re-encoding happens."""
        pls, gds, asg = [], [], []
        for sh in shards:
            p, g, a = sh._export_rows()
            if sh.dtype == "int8" and sh._scale != scale:
                p = np.clip(np.round(p.astype(np.float32)
                                     * (sh._scale / scale)),
                            -127, 127).astype(np.int8)
            pls.append(p), gds.append(g), asg.append(a)
        payload = np.concatenate(pls)
        gid = np.concatenate(gds)
        assign = np.concatenate(asg)
        order = np.argsort(gid, kind="stable")
        payload, gid, assign = payload[order], gid[order], assign[order]
        proto = shards[0]
        bounds = np.linspace(0, gid.shape[0], s_new + 1).astype(int)
        out = []
        for si in range(s_new):
            lo, hi = bounds[si], bounds[si + 1]
            assert hi > lo, f"reshard to {s_new}: shard {si} would be empty"
            sub = BandIVFIndex(proto.dim, proto.nlist, **kw)
            sub.centroids = np.asarray(proto.centroids)
            sub._scale = scale
            sub._assemble_compact(payload[lo:hi], gid[lo:hi], assign[lo:hi])
            out.append(sub)
        return out

    # -- op-point tuning: tune()/_op_point from TunableMixin ---------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        """Cheapest per-shard tile budget meeting the recall target; the
        op point becomes search()'s default and persists via save()."""
        n_tiles = int(self._device_state()["n_tiles"])
        base = self._shards[0]._auto_p_tiles(nq, 32, n_tiles)
        out = []
        for mult in (1.0, 1.5, 2.5, 4.0, 7.0, 12.0):
            p = min(n_tiles, max(32, int(base * mult) // 32 * 32))
            out.append({"p_tiles": p})
            if p >= n_tiles:
                break
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        return {"p_tiles": int(self._device_state()["n_tiles"])}

    def make_filter(self, where):
        """IdFilter over the GLOBAL id space (see BandIVFIndex.make_filter);
        one replicated bitmap serves every shard."""
        from cloudvectordb_tpu.index.filters import IdFilter

        bound = max((sh._gid_bound() for sh in self._shards), default=0)
        return IdFilter.coerce(where, bound)

    def search(self, queries, k: int, nprobe: int = 32, p_tiles: int = 0,
               interpret: bool = False, scoring: str = "hybrid",
               where=None, top2: bool | None = None):
        queries = np.asarray(queries, np.float32)
        flt = self.make_filter(where) if where is not None else None
        nq = queries.shape[0]
        if p_tiles <= 0:  # tuned op point fills the sentinel
            p_tiles = (self._op_point or {}).get("p_tiles", 0)
        st = self._device_state()
        sh0 = self._shards[0]
        # each replica's query slice must itself be a tile_q multiple
        n_rep = dict(zip(self.mesh.axis_names,
                         self.mesh.devices.shape)).get("replica", 1)
        nproc = jax.process_count()
        if nproc > 1:
            # multi-host serving (init_multihost): `queries` is THIS
            # process's traffic. On a ('replica','shard') mesh whose
            # replica axis spans the hosts, each host serves its own
            # replica slice (per-host traffic, DCN only at staging time);
            # on a 1-D mesh every host must pass the identical batch
            # (broadcast semantics, merge all_gather rides the
            # cross-host interconnect). stage_queries enforces the
            # contract — equal shapes, equal static knobs, equal content
            # on broadcast meshes — so a mismatch raises on every host
            # instead of deadlocking the collective.
            nq_plan, q_mult = nq, sh0.tile_q
        else:
            nq_plan, q_mult = max(1, nq // n_rep), sh0.tile_q * n_rep
        if p_tiles <= 0:
            # span-aware budget (index layer doc); each replica plans over
            # its own query slice
            p_tiles = sh0._auto_p_tiles(nq_plan, nprobe, int(st["n_tiles"]))
        q_pad = -(-nq // q_mult) * q_mult
        qp = queries if q_pad == nq else np.concatenate(
            [queries, np.repeat(queries[-1:], q_pad - nq, axis=0)])
        from cloudvectordb_tpu.parallel.mesh import fetch_local, stage_queries

        # every knob that selects the compiled program is part of the
        # cross-process contract (assert_equal_across_processes takes
        # ints — scoring rides as its int8_mode code, the filter as a CRC
        # of its bitmap: a content mismatch would corrupt the merged
        # top-k, not deadlock)
        import zlib

        scoring_code = {"precise": 0, "int8": 1}.get(scoring, 2)
        flt_crc = (zlib.crc32(flt.mask_np.tobytes())
                   if flt is not None else 0)
        l2 = sh0.metric == "l2"
        qg = stage_queries(qp, self.mesh,
                           statics=(p_tiles, k, scoring_code, int(interpret),
                                    flt_crc, int(l2)))
        v, i = _sharded_band_search(
            qg, st["centroids"], st["payload"], st["ids"],
            st["tile_window"], st["n_valid"], self._scale,
            st.get("local"), st.get("valid_end"),
            allowed=(flt.staged_for_mesh(self.mesh)
                     if flt is not None else None),
            k=k, p_tiles=p_tiles, tile_n=sh0.tile_n, tile_q=sh0.tile_q,
            impl=scan_impl(interpret), mesh=self.mesh,
            int8_mode=("precise" if scoring == "precise"
                       else True if scoring == "int8" else "hybrid"),
            l2=l2,
        )
        out_v = fetch_local(v)[:nq]
        out_i = fetch_local(i)[:nq].astype(np.int64)
        if flt is not None:  # unfilled slots keep the (-inf, -1) convention
            out_i = np.where(out_v > -np.inf, out_i, -1)
        return out_v, out_i

    def add(self, vectors) -> np.ndarray:
        """Append to the smallest shard (keeps shards balanced) under
        wrapper-allocated global ids, fold the shard's pending buffer, and
        invalidate the staged mesh state so the next search() re-stages
        (the sharded scan reads only staged arenas — per-shard pending
        buffers are not part of the mesh fan-out). Returns the new rows'
        global ids. Per-add cost is one shard merge + a full re-stage;
        for high-rate in-place adds use the single-chip slack-arena path
        (BandIVFIndex.add) and shard afterwards.

        Multi-process: mutations must run on EVERY process with the same
        batch (SPMD — the next search stages collectively; a host whose
        staged state diverges would enter that collective alone and hang
        it). Same rule for remove()."""
        assert self._shards, "build() first"
        vectors = np.asarray(vectors, np.float32)
        nid = max(sh._gid_bound() for sh in self._shards)
        ids = np.arange(nid, nid + vectors.shape[0], dtype=np.int64)
        si = int(np.argmin([sh.ntotal for sh in self._shards]))
        sh = self._shards[si]
        sh.add(jnp.asarray(vectors), ids=ids)
        sh.merge_pending()
        self._dev = None
        return ids

    def remove(self, ids) -> int:
        """Delete by global id: each shard removes the ids it owns
        (BandIVFIndex.remove — O(batch) in-place swap-remove on
        residual-int8 shards; unknown ids are ignored per shard, so the
        full request fans out to every shard). The staged mesh state is
        rebuilt on the next search."""
        total = sum(sh.remove(ids) for sh in self._shards)
        if total:
            self._dev = None
        return total
