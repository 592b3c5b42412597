"""Predicate filters for filtered ANN search (the IDSelector analog —
multi-tenant serving, soft deletes, attribute pre-filters).

Design (no reference counterpart — the reference README names only the
vectordb): a filter is a dense ALLOW-BITMAP keyed by GLOBAL
id, staged on device once per filter object. Each search gathers it through
the index's live device id table into arena order (one (N,) int8 gather that
is always coherent with in-place adds/removes — no invalidation protocol),
and the residual tiles kernel masks scores BEFORE any candidate slot fills:
exact score-time filtering at ~0.13% extra HBM traffic, correct at any
selectivity. Families without score-time masking use `filtered_search`
(oversample + post-filter — exact only when enough allowed rows land in the
oversampled set; under-filled slots return (-inf, -1), the unfilled-slot
convention used across the package).
"""

from __future__ import annotations

import numpy as np


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class IdFilter:
    """Dense allow-bitmap over global ids. Build once, reuse across
    searches; the device copy uploads lazily on first device-path use.

    The bitmap is padded to a power-of-2 length so filters over slightly
    different id bounds reuse the same compiled search executables; pad
    entries are 0 (disallowed), and gid -1 (hole/unfilled slots) is always
    disallowed."""

    def __init__(self, mask_by_gid: np.ndarray):
        mask = np.asarray(mask_by_gid)
        assert mask.ndim == 1, "mask must be (gid_bound,)"
        n_pad = _next_pow2(max(int(mask.shape[0]), 1024))
        self.mask_np = np.zeros(n_pad, np.uint8)
        self.mask_np[: mask.shape[0]] = mask.astype(bool)
        self._mask_dev = None

    @classmethod
    def coerce(cls, where, gid_bound: int) -> "IdFilter":
        """Accept an IdFilter (pass-through), a bool/int mask indexed by
        gid, or an array of allowed gids."""
        if isinstance(where, IdFilter):
            return where
        arr = np.asarray(where)
        if arr.dtype == np.bool_ or (arr.ndim == 1 and arr.size >= gid_bound
                                     and arr.dtype == np.uint8):
            return cls(arr)
        assert np.issubdtype(arr.dtype, np.integer), (
            "where= takes an IdFilter, a bool mask indexed by global id, "
            "or an integer array of allowed ids")
        mask = np.zeros(max(gid_bound, int(arr.max(initial=-1)) + 1),
                        np.uint8)
        mask[arr[arr >= 0]] = 1
        return cls(mask)

    @property
    def n_allowed(self) -> int:
        return int(self.mask_np.sum())

    def allowed_np(self, gids: np.ndarray) -> np.ndarray:
        """Bool allow decision per (possibly negative) global id, host."""
        g = np.asarray(gids)
        ok = self.mask_np[np.clip(g, 0, self.mask_np.shape[0] - 1)] > 0
        return ok & (g >= 0) & (g < self.mask_np.shape[0])

    def mask_device(self):
        """(n_pad,) int8 allow bits on device (cached)."""
        import jax.numpy as jnp

        if self._mask_dev is None:
            self._mask_dev = jnp.asarray(self.mask_np.astype(np.int8))
        return self._mask_dev

    def allowed_dev(self, gids):
        """Device twin of allowed_np (gids any int dtype, any shape)."""
        import jax.numpy as jnp

        m = self.mask_device()
        ok = m[jnp.clip(gids, 0, m.shape[0] - 1)] > 0
        return ok & (gids >= 0) & (gids < m.shape[0])

    def staged_for_mesh(self, mesh):
        """Allow bitmap replicated onto a serving mesh (cached per mesh):
        shards gather it through their own global-id tables, so one
        replicated copy serves every shard and replica."""
        key = id(mesh)
        staged = getattr(self, "_mesh_staged", None)
        if staged is None:
            staged = self._mesh_staged = {}
        if key not in staged:
            from cloudvectordb_tpu.parallel.mesh import stage_replicated

            staged[key] = stage_replicated(self.mask_np.astype(np.int8),
                                           mesh)
        return staged[key]


def filtered_search(index, queries, k: int, where, oversample: int = 8,
                    **search_kw):
    """Oversample + post-filter fallback for index families without
    score-time masking (flat / IVF-Flat / the PQ-code kernel path): fetch
    k·oversample candidates, drop disallowed ids, keep the top k. Exact
    whenever ≥ k allowed rows survive per query; rows that under-fill pad
    with (-inf, -1). Families with kernel masking (the residual-int8
    arenas) take `where=` on search() directly instead."""
    flt = IdFilter.coerce(where, getattr(index, "_gid_bound", lambda: 0)()
                          or index.ntotal)
    kk = max(k, min(k * oversample, index.ntotal))
    v, g = index.search(queries, kk, **search_kw)
    v, g = np.asarray(v), np.asarray(g)
    v = np.where(flt.allowed_np(g), v, -np.inf)
    sel = np.argsort(-v, axis=1, kind="stable")[:, :k]
    v2 = np.take_along_axis(v, sel, axis=1)
    g2 = np.where(v2 > -np.inf, np.take_along_axis(g, sel, axis=1), -1)
    return v2, g2
