"""Distributed query fan-out + top-k merge over a device mesh.

Index shards live in device memory across a mesh, queries are broadcast
and the per-shard partial top-k merges via all-gather.

Implementation: ``shard_map`` over the 'shard' axis — each device scans its
row-partition with the exact tiled top-k, partial (k) results are
all-gathered (S·k·B floats, tiny; NCCL over NVLink on a multi-GPU host)
and reduced to the global top-k on every device. The same code runs on a
simulated CPU mesh (SURVEY.md §2.3, §4.2).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from cloudvectordb_tpu.ops.topk import tiled_topk
from cloudvectordb_tpu.parallel.mesh import make_mesh


@functools.partial(jax.jit, static_argnames=("k", "metric", "mesh"))
def _dist_flat_search(queries, db_sharded, n_valid, *, k, metric, mesh):
    """queries replicated, db row-sharded over 'shard'. Returns global top-k."""
    rows_per_shard = db_sharded.shape[0] // mesh.shape["shard"]

    def local(q, db_local, nv):
        shard_id = lax.axis_index("shard")
        base = shard_id * rows_per_shard
        # rows beyond n_valid are zero padding on the last shard; mask by
        # clamping the local count.
        local_n = jnp.clip(nv[0] - base, 0, rows_per_shard)
        v, i = tiled_topk(db_local, q, k, metric=metric,
                          tile=min(8192, rows_per_shard))
        v = jnp.where(i < local_n, v, -jnp.inf)
        i = i + base
        # fan-in: gather all shards' partial top-k
        all_v = lax.all_gather(v, "shard", axis=0)  # (S, B, k)
        all_i = lax.all_gather(i, "shard", axis=0)
        s, b, kk = all_v.shape
        cand_v = jnp.transpose(all_v, (1, 0, 2)).reshape(b, s * kk)
        cand_i = jnp.transpose(all_i, (1, 0, 2)).reshape(b, s * kk)
        best_v, pos = lax.top_k(cand_v, k)
        best_i = jnp.take_along_axis(cand_i, pos, axis=1)
        return best_v, best_i

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P("shard"), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(queries, db_sharded, n_valid)


class DistributedFlatIndex:
    """Row-sharded exact index across a mesh (config #4 skeleton at Flat level)."""

    def __init__(self, mesh: Mesh | None = None, metric: str = "ip"):
        self.mesh = mesh or make_mesh(axis_name="shard")
        self.metric = metric
        self._db = None
        self._n = 0
        # original-id map, materialized by the first remove() (until then
        # row position == id); new ids keep allocating past _next_id
        self._ids = None
        self._next_id = 0

    @property
    def ntotal(self) -> int:
        return self._n

    @classmethod
    def build(cls, vectors, mesh: Mesh | None = None, metric: str = "ip"):
        idx = cls(mesh, metric)
        idx.add(vectors)
        return idx

    def _place(self, rows) -> None:
        """Pad the compact row matrix to a shard multiple and re-shard."""
        self._n = int(rows.shape[0])
        pad = (-self._n) % self.mesh.shape["shard"]
        if pad:
            rows = jnp.concatenate(
                [rows, jnp.zeros((pad, rows.shape[1]), rows.dtype)])
        self._db = jax.device_put(rows, NamedSharding(self.mesh, P("shard")))

    def add(self, vectors) -> None:
        vectors = jnp.asarray(vectors, jnp.float32)
        if self._ids is not None:  # id map live after a remove()
            b = int(vectors.shape[0])
            self._ids = np.concatenate([
                self._ids,
                np.arange(self._next_id, self._next_id + b, dtype=np.int64)])
            self._next_id += b
        if self._db is not None:
            vectors = jnp.concatenate([self._db[: self._n], vectors], axis=0)
        self._place(vectors)

    def remove(self, ids) -> int:
        """Delete by original id: one device compaction (jnp.take of the
        survivors) + re-shard; the id map materializes on first remove so
        search keeps returning ORIGINAL ids (same contract as FlatIndex).
        Freed ids are never reused."""
        from cloudvectordb_tpu.index.arena import normalize_remove_ids

        req = normalize_remove_ids(ids)
        if req.size == 0 or self._n == 0:
            return 0
        cur = (self._ids if self._ids is not None
               else np.arange(self._n, dtype=np.int64))
        self._next_id = max(self._next_id, self._n)
        keep = ~np.isin(cur, req)
        n_rem = int((~keep).sum())
        if n_rem == 0:
            return 0
        kept_rows = jnp.asarray(np.flatnonzero(keep).astype(np.int32))
        self._ids = cur[keep]
        self._place(jnp.take(self._db[: self._n], kept_rows, axis=0))
        return n_rem

    def search(self, queries, k: int):
        queries = jnp.asarray(queries, jnp.float32)
        v, i = _dist_flat_search(
            queries, self._db, jnp.array([self._n], jnp.int32),
            k=k, metric=self.metric, mesh=self.mesh,
        )
        i = np.asarray(i)
        if self._ids is not None:  # map positions → original ids
            i = self._ids[np.clip(i, 0, self._ids.shape[0] - 1)]
        return np.asarray(v), i
