"""IVF-Flat: coarse quantizer + raw-vector lists (BASELINE config #2).

Build: k-means (XLA scan) → assign every vector → list-sorted arena.
Search: coarse top-nprobe as one matmul, then a query-major gather of fixed-cap
list windows scanned per probe under ``lax.scan`` (static shapes; tails
masked). Incremental `add` goes through the LSM pending buffer (arena.py);
pending rows are scanned flat at query time, so results are identical to a
fully-merged index.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from cloudvectordb_tpu.index.arena import ListArena, PendingBuffer
from cloudvectordb_tpu.index.base import Index
from cloudvectordb_tpu.index.kmeans import train_kmeans
from cloudvectordb_tpu.ops.assign import assign_clusters
from cloudvectordb_tpu.ops.topk import NEG_INF, merge_topk, tiled_topk

MERGE_FRACTION = 0.1  # merge pending into the arena beyond this fraction


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "cap", "metric"))
def _ivf_scan_search(q, centroids, vecs, ids, offsets, lens, n_valid, *, k, nprobe, cap, metric):
    """Jittable probe-scan search over the list arena.

    q (B, D) f32; vecs (N, D); ids (N,) i32; offsets/lens (nlist,) i32.
    Returns (scores (B, k) f32, ids (B, k) i32).
    """
    bq = q.shape[0]
    # coarse probe always ranks by L2 — the metric that ASSIGNED vectors to
    # lists. IP-ranked probing mis-probes when centroid norms vary (the exact
    # scores of scanned candidates still use the index metric below).
    _, probe_lists = tiled_topk(
        centroids, q, nprobe, metric="l2", tile=min(8192, centroids.shape[0])
    )  # (B, nprobe)
    starts = offsets[probe_lists]  # (B, nprobe)
    ll = lens[probe_lists]
    window = jnp.arange(cap, dtype=jnp.int32)
    qf = q.astype(jnp.float32)
    q_sq = jnp.sum(qf * qf, axis=1)

    def probe_step(carry, inp):
        best_v, best_i = carry
        p_start, p_len = inp  # (B,), (B,)
        rows = p_start[:, None] + window[None, :]  # (B, cap)
        valid = window[None, :] < p_len[:, None]
        rows_c = jnp.clip(rows, 0, vecs.shape[0] - 1)
        cand = vecs[rows_c].astype(jnp.float32)  # (B, cap, D) gather
        dots = jnp.einsum("bd,bcd->bc", qf, cand, preferred_element_type=jnp.float32)
        if metric == "ip":
            s = dots
        else:
            c_sq = jnp.sum(cand * cand, axis=2)
            s = 2.0 * dots - c_sq - q_sq[:, None]
        s = jnp.where(valid, s, NEG_INF)
        kk = min(k, cap)
        tv, tp = lax.top_k(s, kk)
        trows = jnp.take_along_axis(rows_c, tp, axis=1)
        tids = ids[trows]
        if kk < k:
            pad = k - kk
            tv = jnp.concatenate([tv, jnp.full((bq, pad), NEG_INF)], axis=1)
            tids = jnp.concatenate([tids, jnp.zeros((bq, pad), tids.dtype)], axis=1)
        return merge_topk(best_v, best_i, tv, tids, k), None

    init = (jnp.full((bq, k), NEG_INF, jnp.float32), jnp.zeros((bq, k), jnp.int32))
    (best_v, best_i), _ = lax.scan(
        probe_step, init, (starts.T, ll.T)
    )  # scan over nprobe
    return best_v, best_i


class IVFFlatIndex(Index):
    kind = "ivf_flat"

    def __init__(
        self,
        dim: int,
        nlist: int,
        metric: str = "ip",
        dtype: str = "float32",
        kmeans_iters: int = 20,
        seed: int = 0,
    ):
        assert metric in ("ip", "l2")
        self.dim = dim
        self.metric = metric
        self.nlist = nlist
        self.dtype = dtype
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.centroids: np.ndarray | None = None
        self._arena = ListArena(nlist, dim, np.dtype(dtype).type if dtype != "bfloat16" else np.float32)
        self._pending = PendingBuffer(dim, np.float32)
        self._next_id = 0
        self._dev = None  # cached device arrays

    @property
    def ntotal(self) -> int:
        return self._arena.size + self._pending.size

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    def train(self, sample) -> None:
        """Fit the coarse quantizer on a training sample."""
        sample = np.asarray(sample, np.float32)
        c, _ = train_kmeans(
            jnp.asarray(sample), self.nlist, iters=self.kmeans_iters, seed=self.seed
        )
        self.centroids = np.asarray(c)
        self._dev = None

    @classmethod
    def build(
        cls, vectors, nlist: int, metric: str = "ip", train_sample: int = 262_144, **kw
    ) -> "IVFFlatIndex":
        vectors = np.asarray(vectors, np.float32)
        idx = cls(vectors.shape[1], nlist, metric=metric, **kw)
        ns = min(train_sample, vectors.shape[0])
        rs = np.random.default_rng(idx.seed).choice(vectors.shape[0], ns, replace=False)
        idx.train(vectors[rs])
        idx.add(vectors)
        idx.merge_pending()
        return idx

    def _assign(self, vectors: np.ndarray) -> np.ndarray:
        a, _ = assign_clusters(jnp.asarray(vectors), jnp.asarray(self.centroids))
        return np.asarray(a)

    def add(self, vectors) -> None:
        assert self.is_trained, "call train() before add()"
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        self._pending.append(vectors, ids, self._assign(vectors))
        if self._pending.size > max(4096, MERGE_FRACTION * self._arena.size):
            self.merge_pending()
        self._dev = None

    def merge_pending(self) -> None:
        p, i, a = self._pending.drain()
        if p.shape[0]:
            self._arena.merge(p, i, a)
        self._dev = None

    def remove(self, ids) -> int:
        """Delete rows by global id: pending chunks filter in place, the
        arena compacts via one boolean-mask pass (ListArena.remove_ids).
        Returns the number removed; unknown ids are ignored; freed ids are
        never reused (adds keep allocating from _next_id)."""
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
                vecs=jnp.asarray(ar.payload, jnp.float32),
                ids=jnp.asarray(ar.ids, jnp.int32),
                offsets=jnp.asarray(ar.offsets[:-1], jnp.int32),
                lens=jnp.asarray(ar.list_lens, jnp.int32),
                cap=max(8, ar.max_list_len),
            )
        return self._dev

    def search(self, queries, k: int, nprobe: int | None = None,
               batch: int = 256):
        assert self.is_trained
        queries = np.asarray(queries, np.float32)
        if nprobe is None:  # tuned op point (Index.tune), else default 8
            nprobe = (self._op_point or {}).get("nprobe", 8)
        nprobe = min(nprobe, self.nlist)
        st = self._device_state()
        outs_v, outs_i = [], []
        for s in range(0, queries.shape[0], batch):
            qb = jnp.asarray(queries[s : s + batch])
            if self._arena.size:
                v, i = _ivf_scan_search(
                    qb,
                    st["centroids"],
                    st["vecs"],
                    st["ids"],
                    st["offsets"],
                    st["lens"],
                    self._arena.size,
                    k=k,
                    nprobe=nprobe,
                    cap=st["cap"],
                    metric=self.metric,
                )
            else:
                v = jnp.full((qb.shape[0], k), -np.inf, jnp.float32)
                i = jnp.zeros((qb.shape[0], k), jnp.int32)
            snap = self._pending.snapshot()
            if snap is not None:
                pv, pi = snap
                fv, fpos = tiled_topk(
                    jnp.asarray(pv), qb, min(k, pv.shape[0]), metric=self.metric,
                    tile=max(256, min(8192, pv.shape[0])),
                )
                fids = jnp.asarray(pi, jnp.int32)[fpos]
                if fv.shape[1] < k:
                    pad = k - fv.shape[1]
                    fv = jnp.concatenate(
                        [fv, jnp.full((fv.shape[0], pad), -np.inf)], axis=1
                    )
                    fids = jnp.concatenate(
                        [fids, jnp.zeros((fids.shape[0], pad), jnp.int32)], axis=1
                    )
                v, i = merge_topk(v, i, fv, fids, k)
            outs_v.append(np.asarray(v))
            outs_i.append(np.asarray(i))
        return np.concatenate(outs_v), np.concatenate(outs_i)

    # -- op-point tuning (eval/tune.py) -----------------------------------
    def _tune_candidates(self, nq: int) -> list[dict]:
        p, out = 1, []
        while p < self.nlist:
            out.append({"nprobe": p})
            p *= 2
        out.append({"nprobe": self.nlist})
        return out

    def _tune_reference_kw(self, nq: int) -> dict:
        return {"nprobe": self.nlist}  # ≡ exhaustive scan (recall ceiling)

    # -- persistence ------------------------------------------------------
    def _state_arrays(self):
        self.merge_pending()
        return {
            "centroids": self.centroids,
            "payload": self._arena.payload,
            "ids": self._arena.ids,
            "offsets": self._arena.offsets,
        }

    def _state_meta(self):
        return {
            "nlist": self.nlist,
            "dtype": self.dtype,
            "kmeans_iters": self.kmeans_iters,
            "seed": self.seed,
            "next_id": self._next_id,
        }

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict) -> "IVFFlatIndex":
        m = manifest["meta"]
        idx = cls(
            manifest["dim"], m["nlist"], manifest["metric"], m["dtype"],
            m["kmeans_iters"], m["seed"],
        )
        idx.centroids = arrays["centroids"]
        idx._arena.payload = arrays["payload"]
        idx._arena.ids = arrays["ids"]
        idx._arena.offsets = arrays["offsets"]
        idx._next_id = m["next_id"]
        return idx
