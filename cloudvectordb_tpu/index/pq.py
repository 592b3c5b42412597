"""Product quantization: codebook training, encode, decode (SURVEY.md §2.2).

Training is m independent sub-space k-means runs, vmapped so all sub-spaces
optimize simultaneously as matmuls (BASELINE config #3: m=64, nbits=8).

The query-time decode lives in ops/pq_scan.py (a codebook gather); the
decode here serves build/test paths.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from cloudvectordb_tpu.index.kmeans import train_kmeans
from cloudvectordb_tpu.ops.assign import assign_clusters


def _split(x, m: int):
    """(N, D) -> (m, N, D/m) sub-vectors."""
    n, d = x.shape
    assert d % m == 0, f"dim {d} not divisible by m={m}"
    return jnp.transpose(x.reshape(n, m, d // m), (1, 0, 2))


@functools.partial(jax.jit, static_argnames=("m", "nbits", "iters"))
def train_pq(x, m: int, nbits: int = 8, iters: int = 12, seed: int = 0):
    """Train codebooks (m, 2**nbits, D/m) f32 on training vectors x (N, D)."""
    ncode = 2 ** nbits
    subs = _split(x, m)  # (m, N, dsub)

    def one(sub, s):
        c, _ = train_kmeans(sub, ncode, iters=iters, seed=s, tile=4096)
        return c

    seeds = seed + jnp.arange(m)
    return jax.vmap(one)(subs, seeds)


@functools.partial(
    jax.jit, static_argnames=("m", "nbits", "iters", "tile")
)
def train_pq_aniso(
    x,
    xdir,
    m: int,
    nbits: int = 8,
    iters: int = 8,
    eta: float = 4.0,
    seed: int = 0,
    tile: int = 4096,
):
    """Anisotropic (score-aware) PQ codebooks (m, 2**nbits, D/m).

    For inner-product search, reconstruction error PARALLEL to the datapoint
    direction changes scores; orthogonal error mostly cancels (public
    technique: Guo et al., "Accelerating Large-Scale Inference with
    Anisotropic Vector Quantization", 2020 — derived independently here).
    Per-point loss in each subspace: ``||e||^2 + (eta-1)(u.e)^2`` with
    ``e = sub - codeword`` and ``u`` the unit sub-vector of `xdir` (pass the
    ORIGINAL vectors when `x` holds coarse residuals — the score direction is
    the full datapoint, not the residual). eta=1 reduces exactly to Lloyd.

    Assignment is the tiled matmul expansion
    ``base + (eta-1)(p_i - u_i.c_k)^2`` (two matmuls per tile); the codeword
    update solves the per-cluster normal equations
    ``(n_k I + (eta-1) U_k^T U_k) c = sum x + (eta-1) U_k^T p_k`` — segment
    sums feed batched (dsub, dsub) solves, all inside one ``fori_loop``.
    Sub-spaces run under ``lax.map`` (sequential) to bound the N x dsub^2
    outer-product buffer.
    """
    ncode = 2 ** nbits
    n, d = x.shape
    subs = _split(x, m)  # (m, N, dsub)
    us = _split(xdir, m)
    us = us / jnp.maximum(jnp.linalg.norm(us, axis=2, keepdims=True), 1e-9)
    ds = d // m
    etam1 = jnp.float32(eta - 1.0)
    eye = jnp.eye(ds, dtype=jnp.float32)
    n_pad = (-n) % tile
    seeds = seed + jnp.arange(m)

    def one(args):
        sub, u, s = args
        sub = sub.astype(jnp.float32)
        u = u.astype(jnp.float32)
        p = jnp.sum(u * sub, axis=1)  # (N,) score-direction components
        x_sq = jnp.sum(sub * sub, axis=1)
        pad = lambda v: (
            jnp.concatenate([v, jnp.zeros((n_pad, *v.shape[1:]), v.dtype)])
            if n_pad else v
        )
        sub_t = pad(sub).reshape(-1, tile, ds)
        u_t = pad(u).reshape(-1, tile, ds)
        p_t = pad(p).reshape(-1, tile)
        xsq_t = pad(x_sq).reshape(-1, tile)

        def assign(cb):
            cb_sq = jnp.sum(cb * cb, axis=1)

            def blk(blk_args):
                st, ut, pt, xt = blk_args
                base = xt[:, None] - 2.0 * st @ cb.T + cb_sq[None, :]
                dlt = pt[:, None] - ut @ cb.T
                return jnp.argmin(base + etam1 * dlt * dlt, axis=1).astype(
                    jnp.int32
                )

            return lax.map(blk, (sub_t, u_t, p_t, xsq_t)).reshape(-1)[:n]

        cb0, _ = train_kmeans(sub, ncode, iters=2, seed=s, tile=tile)
        uu = (u[:, :, None] * u[:, None, :]).reshape(n, ds * ds)
        rhs_rows = sub + etam1 * p[:, None] * u

        def body(i, cb):
            a = assign(cb)
            nk = jax.ops.segment_sum(
                jnp.ones((n,), jnp.float32), a, num_segments=ncode
            )
            A = (
                etam1
                * jax.ops.segment_sum(uu, a, num_segments=ncode).reshape(
                    ncode, ds, ds
                )
                + (nk[:, None, None] + 1e-6) * eye[None]
            )
            b = jax.ops.segment_sum(rhs_rows, a, num_segments=ncode)
            cb_new = jnp.linalg.solve(A, b[..., None])[..., 0]
            return jnp.where((nk > 0.0)[:, None], cb_new, cb)

        return lax.fori_loop(0, iters, body, cb0)

    return lax.map(one, (subs, us, seeds))


@functools.partial(jax.jit, static_argnames=("tile",))
def pq_encode_aniso(x, xdir, codebooks, eta: float, tile: int = 4096):
    """Encode under the anisotropic metric the codebooks were trained with.

    Plain nearest-codeword encoding is metric-mismatched for anisotropic
    codebooks (it trades parallel error back for orthogonal error); matching
    the training assignment rule preserves the score-aware tradeoff.

    Memory shape: a ``fori_loop`` over ROW blocks sliced straight out of the
    caller's arrays (``dynamic_slice`` — no padded (N, D) copies, no
    (N, m, dsub) split), all m sub-spaces batched into one (m, tile, ncode)
    einsum per block. Peak HBM beyond the inputs is one block's distance
    tensor + the (N, m) uint8 output.
    """
    m, ncode, ds = codebooks.shape
    n, d = x.shape
    etam1 = jnp.float32(eta - 1.0)
    cb = codebooks.astype(jnp.float32)
    cb_sq = jnp.sum(cb * cb, axis=2)  # (m, ncode)
    xf = x.astype(jnp.float32)
    uf = xdir.astype(jnp.float32)

    def blk(xb, ub):
        t = xb.shape[0]
        xs = jnp.transpose(xb.reshape(t, m, ds), (1, 0, 2))  # (m, T, ds)
        us = jnp.transpose(ub.reshape(t, m, ds), (1, 0, 2))
        us = us / jnp.maximum(
            jnp.linalg.norm(us, axis=2, keepdims=True), 1e-9)
        p = jnp.sum(us * xs, axis=2)  # (m, T)
        x_sq = jnp.sum(xs * xs, axis=2)
        xc = jnp.einsum("mtd,mkd->mtk", xs, cb,
                        preferred_element_type=jnp.float32)
        uc = jnp.einsum("mtd,mkd->mtk", us, cb,
                        preferred_element_type=jnp.float32)
        dlt = p[:, :, None] - uc
        dist = (x_sq[:, :, None] - 2.0 * xc + cb_sq[:, None, :]
                + etam1 * dlt * dlt)
        return jnp.transpose(
            jnp.argmin(dist, axis=2).astype(jnp.uint8))  # (T, m)

    n_full = (n // tile) * tile
    if n_full == 0:  # single sub-tile block — no loop to trace
        return blk(xf, uf)

    def body(i, out):
        xb = lax.dynamic_slice_in_dim(xf, i * tile, tile)
        ub = lax.dynamic_slice_in_dim(uf, i * tile, tile)
        return lax.dynamic_update_slice_in_dim(out, blk(xb, ub), i * tile, 0)

    out = lax.fori_loop(0, n // tile, body, jnp.zeros((n_full, m), jnp.uint8))
    if n_full == n:
        return out
    tail = blk(xf[n_full:], uf[n_full:])  # one sub-tile block
    return jnp.concatenate([out, tail])


@functools.partial(jax.jit, static_argnames=())
def pq_encode(x, codebooks):
    """(N, D) -> uint8 codes (N, m)."""
    m = codebooks.shape[0]
    subs = _split(x, m)  # (m, N, dsub)

    def one(sub, cb):
        a, _ = assign_clusters(sub, cb, tile=8192)
        return a

    codes = jax.vmap(one)(subs, codebooks)  # (m, N)
    return jnp.transpose(codes).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=())
def pq_decode(codes, codebooks):
    """uint8 (N, m) -> reconstructed (N, D) f32 (gather path, off hot loop)."""
    m, ncode, dsub = codebooks.shape
    parts = jax.vmap(lambda j: codebooks[j][codes[:, j].astype(jnp.int32)])(
        jnp.arange(m)
    )  # (m, N, dsub)
    return jnp.transpose(parts, (1, 0, 2)).reshape(codes.shape[0], m * dsub)


def pq_reconstruction_mse(x, codebooks) -> float:
    codes = pq_encode(x, codebooks)
    xr = pq_decode(codes, codebooks)
    return float(jnp.mean(jnp.sum((x - xr) ** 2, axis=1)))
