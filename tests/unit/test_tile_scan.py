"""The Triton tile-scan kernel (Pallas interpreter on the CPU) against its
plain-XLA reference, the reference against a numpy oracle, and the one
place that decides how a scan runs (ops/backend.py)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cloudvectordb_tpu.ops.backend import scan_impl
from cloudvectordb_tpu.ops.pallas_band import tiles_topk, tiles_topk_resid


def _resid_case(d=96, tile_n=256, n_tiles=6, w=3, nq=32, tile_q=16, p=4,
                seed=0):
    """Residual arena with the layout's features: per-tile list runs,
    slack holes and tail padding (valid_end below each run's end)."""
    rng = np.random.default_rng(seed)
    n = tile_n * n_tiles
    nlist = n_tiles * w
    db = rng.integers(-127, 128, (n, d)).astype(np.int8)
    local = ((np.arange(n) % tile_n) * w // tile_n).astype(np.uint8)[None]
    tw = (np.arange(n_tiles)[:, None] * w + np.arange(w)[None]).astype(np.int32)
    run_end = (np.arange(n_tiles)[:, None] * tile_n
               + (np.arange(w)[None] + 1) * (tile_n // w))
    ve = (run_end - rng.integers(0, 20, (n_tiles, w))).astype(np.int32)
    cent = rng.standard_normal((nlist, d)).astype(np.float32) / np.sqrt(d)
    q = rng.standard_normal((nq, d)).astype(np.float32) / np.sqrt(d)
    tt = np.stack([rng.choice(n_tiles, p, replace=False)
                   for _ in range(nq // tile_q)]).astype(np.int32)
    mask = (rng.random((1, n)) < 0.7).astype(np.int8)
    return dict(db=db, local=local, tw=tw, ve=ve, cent=cent, q=q, tt=tt,
                mask=mask, tile_n=tile_n, tile_q=tile_q)


def _sorted(v, i):
    v, i = np.asarray(v), np.asarray(i)
    o = np.argsort(-v, axis=1, kind="stable")
    return np.take_along_axis(v, o, 1), np.take_along_axis(i, o, 1)


def _assert_same(vk, ik, vr, ir, atol, group=0):
    """Sorted scores agree within atol; every reference id whose score
    clears the row's last kept score by more than 2·atol (no tie at the
    cut) is among the kernel's ids. ``group``: compare each run of that
    many columns on its own (the kernel's per-slice top-K candidates)."""
    if group:
        vk, ik, vr, ir = (np.asarray(a).reshape(-1, group)
                          for a in (vk, ik, vr, ir))
    vk, ik = _sorted(vk, ik)
    vr, ir = _sorted(vr, ir)
    fin = np.isfinite(vr)
    assert (np.isfinite(vk) == fin).all()
    np.testing.assert_allclose(vk[fin], vr[fin], atol=atol, rtol=0)
    last = np.where(fin, vr, np.inf).min(axis=1, keepdims=True)
    inside = fin & (vr > last + 2 * atol)
    for row in range(vr.shape[0]):
        assert set(ir[row][inside[row]]) <= set(ik[row])


def _resid_args(c, qc=None):
    qc = c["q"] @ c["cent"].T if qc is None else qc
    return (jnp.asarray(c["db"]), jnp.asarray(c["local"]), jnp.asarray(c["tw"]),
            jnp.asarray(c["ve"]), jnp.asarray(qc), 0.01, jnp.asarray(c["q"]),
            jnp.asarray(c["tt"]))


@pytest.mark.parametrize("int8_q,l2,masked",
                         list(itertools.product([True, False], repeat=3)))
def test_resid_kernel_matches_reference(int8_q, l2, masked):
    """D=96 (no 128 multiple), slack holes, tail padding, filter mask."""
    c = _resid_case(seed=int(int8_q) * 4 + int(l2) * 2 + int(masked))
    kw = dict(tile_n=c["tile_n"], tile_q=c["tile_q"], int8_q=int8_q, l2=l2,
              row_mask=jnp.asarray(c["mask"]) if masked else None,
              centroids=jnp.asarray(c["cent"]), candidates=True)
    vk, ik = tiles_topk_resid(*_resid_args(c), 10, impl="interpret", **kw)
    vr, ir = tiles_topk_resid(*_resid_args(c), 10, impl="xla", **kw)
    _assert_same(vk, ik, vr, ir, atol=1e-4, group=16)
    # no masked row (hole, padding, filtered) ever surfaces
    ik, vk = np.asarray(ik), np.asarray(vk)
    t, loc = ik // c["tile_n"], c["local"][0, ik]
    live = ik < c["ve"][t, loc]
    if masked:
        live &= c["mask"][0, ik] != 0
    assert live[np.isfinite(vk)].all()


@pytest.mark.parametrize("int8", [True, "hybrid", False])
def test_plain_kernel_matches_reference(int8):
    c = _resid_case(d=128, seed=11)
    q = c["q"]
    db = c["db"]
    if int8 is True:
        q = np.clip(np.round(q * 400), -127, 127).astype(np.int8)
    elif int8 is False:
        db = db.astype(np.float32) / 127.0
    n_valid = db.shape[0] - 100  # the tail is padding
    kw = dict(tile_n=c["tile_n"], tile_q=c["tile_q"], int8=int8,
              n_valid=n_valid, candidates=True)
    args = (jnp.asarray(db), jnp.asarray(q), jnp.asarray(c["tt"]), 10)
    vk, ik = tiles_topk(*args, impl="interpret", **kw)
    vr, ir = tiles_topk(*args, impl="xla", **kw)
    _assert_same(vk, ik, vr, ir, atol=1e-3, group=16)
    assert (np.asarray(ik)[np.isfinite(np.asarray(vk))] < n_valid).all()


@pytest.mark.parametrize("tile_q,k", [(4, 10), (16, 40)])
def test_kernel_small_groups_and_deep_k(tile_q, k):
    """Tiny query groups widen to the kernel's 16-row minimum and shrink
    back; k > 16 deepens the per-block top-K (range-search widths)."""
    c = _resid_case(nq=32, tile_q=tile_q, p=3, seed=21)
    kw = dict(tile_n=c["tile_n"], tile_q=tile_q, l2=False,
              centroids=jnp.asarray(c["cent"]))
    vk, ik = tiles_topk_resid(*_resid_args(c), k, impl="interpret", **kw)
    vr, ir = tiles_topk_resid(*_resid_args(c), k, impl="xla", **kw)
    assert vk.shape == vr.shape == (32, k)
    _assert_same(vk, ik, vr, ir, atol=1e-4)


def test_reference_matches_numpy_oracle():
    """The plain form is an exact top-k over the planned tiles."""
    c = _resid_case(d=64, seed=3)
    v, i = tiles_topk_resid(*_resid_args(c), 10, impl="xla",
                            tile_n=c["tile_n"], tile_q=c["tile_q"],
                            int8_q=False, centroids=jnp.asarray(c["cent"]))
    q, tn, tq = c["q"], c["tile_n"], c["tile_q"]
    qb = q.astype(jnp.bfloat16).astype(np.float32)
    for g in range(q.shape[0] // tq):
        rows = (c["tt"][g][:, None] * tn + np.arange(tn)[None]).reshape(-1)
        lists = c["tw"][rows // tn, c["local"][0, rows]]
        live = rows < c["ve"][rows // tn, c["local"][0, rows]]
        for r in range(g * tq, (g + 1) * tq):
            s = (q[r] @ c["cent"][lists].T
                 + 0.01 * (qb[r] @ c["db"][rows].astype(np.float32).T))
            s = np.where(live, s, -np.inf)
            top = np.argsort(-s, kind="stable")[:10]
            np.testing.assert_allclose(np.asarray(v)[r], s[top], atol=1e-4)
            assert set(np.asarray(i)[r]) == set(rows[top])


def test_backend_decision():
    """Interpret mode only on request; the GPU always gets the compiled
    kernel; a backend without Triton gets the plain form."""
    assert scan_impl(False, "gpu") == "triton"
    assert scan_impl(True, "gpu") == "interpret"
    assert scan_impl(False, "cpu") == "xla"
    assert scan_impl(True, "cpu") == "interpret"
    assert scan_impl() == ("triton" if jax.default_backend() == "gpu"
                           else "xla")


def test_kernel_lowers_for_cuda():
    """The kernel lowers to Triton IR for the GPU (compiling to PTX needs
    the card; chip_smoke.py phase 1 does that)."""
    c = _resid_case(d=768, tile_n=2048, n_tiles=4, nq=256, tile_q=256, p=4)

    def f(*a):
        return tiles_topk_resid(*a, 10, impl="triton", tile_n=2048,
                                tile_q=256, l2=True,
                                row_mask=jnp.asarray(c["mask"]),
                                centroids=jnp.asarray(c["cent"]))

    low = jax.jit(f).trace(*_resid_args(c)).lower(
        lowering_platforms=("cuda",))
    assert "tile_scan" in low.as_text()


@pytest.mark.gpu
def test_kernel_on_card_matches_reference():
    c = _resid_case(d=768, tile_n=2048, n_tiles=16, nq=512, tile_q=256, p=8)
    kw = dict(tile_n=2048, tile_q=256, l2=True, candidates=True,
              row_mask=jnp.asarray(c["mask"]), centroids=jnp.asarray(c["cent"]))
    vk, ik = tiles_topk_resid(*_resid_args(c), 10, impl="triton", **kw)
    with jax.default_matmul_precision("highest"):
        vr, ir = tiles_topk_resid(*_resid_args(c), 10, impl="xla", **kw)
    _assert_same(vk, ik, vr, ir, atol=1e-4, group=16)
