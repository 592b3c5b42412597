"""Exact brute-force index — ground truth + small/medium-scale serving.

Vectors live in device memory (bf16 or f32; int8 symmetric quantization
for memory-bound scales — 100M×768d raw f32 is 307 GB, SURVEY.md §7.3 item
4). Search is the exact XLA tiled scan (ops/topk.py) on every backend; an
int8 store is widened to f32 one tile at a time inside the scan, never as
a whole.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from cloudvectordb_tpu.index.base import Index
from cloudvectordb_tpu.ops.topk import tiled_topk

_STORE_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}


class FlatIndex(Index):
    kind = "flat"

    def __init__(self, dim: int, metric: str = "ip", dtype: str = "float32"):
        assert metric in ("ip", "l2")
        assert dtype in _STORE_DTYPES
        if dtype == "int8" and metric != "ip":
            # int8 symmetric quantization is the memory-bound serving path for
            # normalized embeddings (cosine/IP); L2 would need per-row dequant
            # norms and isn't worth the complexity.
            raise ValueError("int8 FlatIndex supports metric='ip' only")
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self._vecs = jnp.zeros((0, dim), _STORE_DTYPES[dtype])
        self._sqnorms = jnp.zeros((0,), jnp.float32)
        self._scale = 1.0  # int8 dequant scale
        # ids are IMPLICIT row positions until the first remove() creates
        # gaps; then _ids maps position → global id (sorted ascending:
        # built from arange, compaction preserves order, adds append
        # ids > every existing one)
        self._ids: np.ndarray | None = None
        self._next_id = 0

    @property
    def ntotal(self) -> int:
        return int(self._vecs.shape[0])

    @classmethod
    def build(cls, vectors, metric: str = "ip", dtype: str = "float32") -> "FlatIndex":
        idx = cls(int(vectors.shape[1]), metric=metric, dtype=dtype)
        idx.add(vectors)
        return idx

    def add(self, vectors) -> None:
        vectors = jnp.asarray(vectors)
        assert vectors.shape[1] == self.dim
        if self.dtype == "int8":
            # clip-scale at 4×rms: spending the 8-bit range on the bulk of
            # the distribution (not outliers) measurably improves recall
            amax = float(jnp.max(jnp.abs(vectors)))
            rms = float(jnp.sqrt(jnp.mean(vectors.astype(jnp.float32) ** 2)))
            batch_scale = min(amax, 4.0 * rms) / 127.0
            new_scale = max(self._scale if self.ntotal else 0.0, batch_scale, 1e-12)
            if self.ntotal and new_scale != self._scale:
                # requantize existing store under the widened scale
                self._vecs = jnp.clip(
                    jnp.round(
                        self._vecs.astype(jnp.float32) * (self._scale / new_scale)
                    ),
                    -127,
                    127,
                ).astype(jnp.int8)
            self._scale = new_scale
            q = jnp.clip(jnp.round(vectors / self._scale), -127, 127).astype(jnp.int8)
            self._vecs = jnp.concatenate([self._vecs, q], axis=0)
        else:
            self._vecs = jnp.concatenate(
                [self._vecs, vectors.astype(self._vecs.dtype)], axis=0
            )
        if self.metric == "l2":
            sq = jnp.sum(
                vectors.astype(jnp.float32) * vectors.astype(jnp.float32), axis=1
            )
            self._sqnorms = jnp.concatenate([self._sqnorms, sq])
        n = int(vectors.shape[0])
        if self._ids is not None:
            self._ids = np.concatenate(
                [self._ids, np.arange(self._next_id, self._next_id + n)])
        self._next_id = max(self._next_id, self.ntotal - n) + n

    def remove(self, ids) -> int:
        """Delete rows by global id: one device compaction gather (the
        store never crosses the host link — O(N) at HBM bandwidth).
        Returns the number removed; unknown ids ignored; freed ids never
        reused (search keeps returning ORIGINAL ids via the id map the
        first remove materializes)."""
        from cloudvectordb_tpu.index.arena import normalize_remove_ids

        req = normalize_remove_ids(ids)
        if req.size == 0 or self.ntotal == 0:
            return 0
        cur = (self._ids if self._ids is not None
               else np.arange(self.ntotal, dtype=np.int64))
        self._next_id = max(self._next_id, self.ntotal)
        keep = ~np.isin(cur, req)
        n_rem = int(self.ntotal - keep.sum())
        if n_rem == 0:
            return 0
        kidx = jnp.asarray(np.flatnonzero(keep).astype(np.int32))
        self._vecs = jnp.take(self._vecs, kidx, axis=0)
        if self.metric == "l2":
            self._sqnorms = jnp.take(self._sqnorms, kidx)
        self._ids = cur[keep]
        return n_rem

    def _search_arrays(self):
        if self.dtype == "int8":
            return self._vecs, self._scale
        return self._vecs, 1.0

    def search(self, queries, k: int, tile: int = 8192):
        """Exact top-k (scores dequantized for int8 stores)."""
        queries = jnp.asarray(queries)
        vecs, scale = self._search_arrays()
        sqnorms = self._sqnorms if self.metric == "l2" else None
        if self.dtype == "int8":
            # pre-scale the query so int8-row scores come out dequantized
            queries = (queries * scale).astype(jnp.float32)
        s, i = tiled_topk(
            vecs, queries, k, metric=self.metric,
            tile=min(tile, max(256, self.ntotal)), db_sqnorms=sqnorms,
        )
        s, i = np.asarray(s), np.asarray(i)
        if self._ids is not None:  # post-remove: positions → original ids
            i = self._ids[np.clip(i, 0, self.ntotal - 1)]
        return s, i

    def _positions(self, ids) -> np.ndarray:
        """Global ids → current row positions (_ids stays sorted: arange
        origin, order-preserving compaction, ascending appends)."""
        ids = np.asarray(ids)
        if self._ids is None:
            return ids
        pos = np.searchsorted(self._ids, ids)
        assert (pos < self._ids.shape[0]).all() and (
            self._ids[pos] == ids).all(), "unknown (removed?) id"
        return pos

    def reconstruct(self, ids) -> np.ndarray:
        v = np.asarray(self._vecs)[self._positions(ids)]
        if self.dtype == "int8":
            return v.astype(np.float32) * self._scale
        return v.astype(np.float32)

    # -- persistence ------------------------------------------------------
    def _state_arrays(self):
        out = {"vecs": np.asarray(self._vecs)}
        if self.metric == "l2":
            out["sqnorms"] = np.asarray(self._sqnorms)
        if self._ids is not None:
            out["ids"] = self._ids
        return out

    def _state_meta(self):
        return {"dtype": self.dtype, "scale": self._scale,
                "next_id": max(self._next_id, self.ntotal)}

    @classmethod
    def _from_state(cls, manifest: dict, arrays: dict) -> "FlatIndex":
        idx = cls(manifest["dim"], manifest["metric"], manifest["meta"]["dtype"])
        idx._vecs = jnp.asarray(arrays["vecs"])
        idx._scale = manifest["meta"]["scale"]
        if "sqnorms" in arrays:
            idx._sqnorms = jnp.asarray(arrays["sqnorms"])
        if "ids" in arrays:
            idx._ids = np.array(arrays["ids"], np.int64, copy=True)
        idx._next_id = manifest["meta"].get("next_id", idx.ntotal)
        return idx
