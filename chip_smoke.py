"""Smoke test of the system's main path on NVIDIA GPUs.

    python chip_smoke.py              # phases 0-3 on one card
    python chip_smoke.py --cards 4    # phase 4 only, on four cards

Phases (one process; the first failure stops the run with a non-zero exit):
  0. device: a GPU must be present; prints the card's name and power limit,
     the JAX version, XLA_FLAGS and the compile-cache directory.
  1. kernel parity: the Triton tile-scan kernel, compiled for the card, vs
     its plain-XLA reference at D=768 and the index's tile shapes.
  2. text pipeline: `python -m cloudvectordb_tpu pipeline` with the
     minilm-l6-384 encoder (max_len 128) over 20k synthetic passages, a
     residual-int8 band_ivf index, then the CLI `search` command.
  3. the store at real size: BandIVFIndex.build_device_streaming at
     12.5M×768 residual int8, nlist=4096; recall@10 ≥ 0.95 against an exact
     f32 ground truth on 1,024 queries, then QPS at B=4096 (information).
  4. (--cards 4) one data-parallel train step vs the same step on one card,
     and a 4-shard ShardedBandIndex at 4×12.5M×768 vs exact f32 and vs a
     host merge of its shards' own top-k.

The last line of stdout is one JSON object: {"ok": true, "device": {...}}.

``--rehearse`` runs the same phases at toy sizes on the CPU, with the
kernel in the Pallas interpreter (on four virtual CPU devices with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``); it proves the
control flow only and prints no device numbers worth keeping.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

D, K, B, LATENT, NCENTERS = 768, 10, 4096, 32, 256
N_SCALE, CHUNK, NLIST = 12_500_000, 500_000, 4096
NQ_GT = 1024
P_LADDER = (128, 192, 256, 384, 512, 768, 1024)
IMPL = "triton"
PIPE = dict(num_docs=20000, preset="minilm-l6-384", batch=256, steps=40,
            nlist=128)
TRAIN_B = 512


def _rehearsal_sizes() -> None:
    global B, N_SCALE, CHUNK, NLIST, NQ_GT, P_LADDER, IMPL, TRAIN_B
    B, N_SCALE, CHUNK, NLIST, NQ_GT = 256, 40_000, 10_000, 32, 64
    P_LADDER, IMPL, TRAIN_B = (4, 8, 16, 32), "interpret", 16
    PIPE.update(num_docs=400, preset="tiny-test", batch=16, steps=20,
                nlist=8)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 0 -----------------------------------------------------------------

def phase_device(cards: int, rehearse: bool = False):
    import jax

    from cloudvectordb_tpu.utils.runtime import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu" and not rehearse:
        raise SystemExit(f"phase 0 FAILED: no GPU (JAX sees {devs[0].platform})")
    if len(devs) < cards:
        raise SystemExit(f"phase 0 FAILED: {cards} cards asked, {len(devs)} seen")
    if not rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        for line in smi.stdout.strip().splitlines():
            log(f"[phase0] card: {line.strip()}")
    log(f"[phase0] jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {cache}")
    return devs


# -- helpers -------------------------------------------------------------------

def _sorted_rows(v, i):
    import numpy as np

    v, i = np.asarray(v), np.asarray(i)
    o = np.argsort(-v, axis=1, kind="stable")
    return np.take_along_axis(v, o, 1), np.take_along_axis(i, o, 1)


def check_same_topk(vk, ik, vr, ir, atol: float, what: str,
                    group: int = 0) -> int:
    """Sorted scores agree within atol; every reference id whose score
    clears the row's last kept score by more than 2·atol (no tie at the
    cut) is among the kernel's ids. ``group``: compare each run of that
    many columns on its own (the kernel's per-slice top-K candidates).
    Returns how many ids differ (ties)."""
    import numpy as np

    if group:
        vk, ik, vr, ir = (np.asarray(a).reshape(-1, group)
                          for a in (vk, ik, vr, ir))
    vk, ik = _sorted_rows(vk, ik)
    vr, ir = _sorted_rows(vr, ir)
    fin = np.isfinite(vr)
    assert (np.isfinite(vk) == fin).all(), f"{what}: -inf slots differ"
    err = float(np.abs(vk[fin] - vr[fin]).max()) if fin.any() else 0.0
    assert err <= atol, f"{what}: score error {err:.3g} > {atol:.3g}"
    last = np.where(fin, vr, np.inf).min(axis=1, keepdims=True)
    inside = fin & (vr > last + 2 * atol)
    rows = [r for r in range(vr.shape[0])
            if set(ir[r][inside[r]]) - set(ik[r])]
    assert not rows, (
        f"{what}: ids missing outside ties in {len(rows)} rows; first row "
        f"{rows[:1]}: kernel {list(zip(vk[rows[0]][:12], ik[rows[0]][:12]))} "
        f"reference {list(zip(vr[rows[0]][:12], ir[rows[0]][:12]))}"
        if rows else "")
    return int(((ik != ir) & fin).sum())


def corpus_gen():
    """bench-style synthetic corpus: unit vectors from a 32-d latent
    mixture, one chunk per PRNG key (deterministic — builds read it twice)."""
    import functools

    import jax
    import jax.numpy as jnp

    kw, kc = jax.random.split(jax.random.PRNGKey(1000))
    w = jax.random.normal(kw, (LATENT, D), jnp.float32) / (LATENT ** 0.5)
    centers = jax.random.normal(kc, (NCENTERS, LATENT), jnp.float32)
    centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)

    @functools.partial(jax.jit, static_argnames=("m",))
    def gen(key, m):
        ka, kn = jax.random.split(key)
        a = jax.random.randint(ka, (m,), 0, NCENTERS)
        z = centers[a] + (0.3 / (LATENT ** 0.5)) * jax.random.normal(
            kn, (m, LATENT), jnp.float32)
        x = z @ w
        return x / jnp.linalg.norm(x, axis=1, keepdims=True)

    return gen


def make_queries(chunk0, nq, seed=7777):
    import jax
    import jax.numpy as jnp

    kq, kn = jax.random.split(jax.random.PRNGKey(seed))
    sel = jax.random.randint(kq, (nq,), 0, chunk0.shape[0])
    q = chunk0[sel] + (0.15 / (D ** 0.5)) * jax.random.normal(
        kn, (nq, D), jnp.float32)
    return q / jnp.linalg.norm(q, axis=1, keepdims=True)


def exact_ground_truth(chunk_fn, n_chunks, q, k):
    """Exact f32 top-k over the streamed corpus (Precision.HIGHEST)."""
    import jax
    import jax.numpy as jnp

    from cloudvectordb_tpu.ops.topk import tiled_topk

    @jax.jit
    def merge(bv, bi, cv, ci, base):
        v, p = jax.lax.top_k(jnp.concatenate([bv, cv], 1), k)
        return v, jnp.take_along_axis(jnp.concatenate([bi, ci + base], 1), p, 1)

    bv = jnp.full((q.shape[0], k), -jnp.inf)
    bi = jnp.zeros((q.shape[0], k), jnp.int32)
    for ci in range(n_chunks):
        cv, cidx = tiled_topk(chunk_fn(ci), q, k, tile=8192)
        bv, bi = merge(bv, bi, cv, cidx, ci * CHUNK)
    return jax.device_get(bi)


# -- phase 1 -----------------------------------------------------------------

def phase_kernels():
    """Compiled kernel vs plain reference, every variant the index uses."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cloudvectordb_tpu.index.ivf_band import BandIVFIndex
    from cloudvectordb_tpu.ops.pallas_band import (
        _keep, tiles_topk, tiles_topk_resid)

    proto = BandIVFIndex(D, NLIST, residual=True)
    tile_n, tile_q = proto.tile_n, proto.tile_q
    n_tiles, w, p, nq = 64, 4, 40, 4 * tile_q
    if IMPL == "interpret":
        n_tiles, p, nq = 4, 3, tile_q
    nlist = n_tiles * w
    n = n_tiles * tile_n
    ks = jax.random.split(jax.random.PRNGKey(5), 8)
    db = jax.random.randint(ks[0], (n, D), -127, 128, jnp.int32).astype(jnp.int8)
    run = (jnp.arange(n) % tile_n) * w // tile_n  # each tile: w list runs
    local = run.astype(jnp.uint8)[None, :]
    tw = (jnp.arange(n_tiles)[:, None] * w + jnp.arange(w)[None, :]).astype(
        jnp.int32)
    holes = jax.random.randint(ks[1], (n_tiles, w), 0, 64)  # slack + tail
    ve = (jnp.arange(n_tiles)[:, None] * tile_n
          + (jnp.arange(w)[None, :] + 1) * (tile_n // w) - holes).astype(jnp.int32)
    cent = jax.random.normal(ks[2], (nlist, D), jnp.float32) / np.sqrt(D)
    q = jax.random.normal(ks[3], (nq, D), jnp.float32) / np.sqrt(D)
    with jax.default_matmul_precision("highest"):
        qc = q @ cent.T
    tt = jnp.stack([jax.random.permutation(k, n_tiles)[:p]
                    for k in jax.random.split(ks[4], nq // tile_q)]).astype(
                        jnp.int32)
    mask = jax.random.bernoulli(ks[5], 0.7, (1, n)).astype(jnp.int8)
    scale = 0.002
    keep = _keep(K)  # candidates come as per-slice top-K runs
    for int8_q in (True, False):
        for l2 in (False, True):
            for masked in (False, True):
                kw = dict(tile_n=tile_n, tile_q=tile_q, int8_q=int8_q, l2=l2,
                          row_mask=mask if masked else None, centroids=cent)
                args = (db, local, tw, ve, qc, scale, q, tt, K)
                t0 = time.perf_counter()
                vk, ik = jax.block_until_ready(
                    tiles_topk_resid(*args, impl=IMPL, candidates=True, **kw))
                t_compile = time.perf_counter() - t0
                with jax.default_matmul_precision("highest"):
                    vr, ir = tiles_topk_resid(*args, impl="xla",
                                              candidates=True, **kw)
                # scores: the int8 dot is exact (int32); the bf16 dot has
                # exact products and differs only in f32 summation order;
                # the rest is a few f32 ops in another order. 1e-5 of the
                # largest score bounds all of it with margin.
                atol = 1e-5 * float(jnp.max(jnp.abs(jnp.where(
                    jnp.isfinite(vr), vr, 0)))) + 1e-6
                ties = check_same_topk(vk, ik, vr, ir, atol,
                                       f"resid int8_q={int8_q} l2={l2} "
                                       f"mask={masked}", group=keep)
                fk = tiles_topk_resid(*args, impl=IMPL, **kw)
                with jax.default_matmul_precision("highest"):
                    fr = tiles_topk_resid(*args, impl="xla", **kw)
                check_same_topk(*fk, *fr, atol, "resid final top-k")
                log(f"[phase1] tile_scan resid int8_q={int8_q} l2={l2} "
                    f"mask={masked}: ok (atol {atol:.2e}, {ties} tie swaps, "
                    f"first call {t_compile:.1f}s)")
    # deep k (range search widths; what top2 used to widen): K=128 per
    # block trades query rows for register room (32-row blocks)
    kw = dict(tile_n=tile_n, tile_q=tile_q, row_mask=mask, centroids=cent)
    fk = tiles_topk_resid(db, local, tw, ve, qc, scale, q, tt, 100,
                          impl=IMPL, **kw)
    with jax.default_matmul_precision("highest"):
        fr = tiles_topk_resid(db, local, tw, ve, qc, scale, q, tt, 100,
                              impl="xla", **kw)
    atol = 1e-5 * float(jnp.max(jnp.abs(jnp.where(
        jnp.isfinite(fr[0]), fr[0], 0)))) + 1e-6
    ties = check_same_topk(*fk, *fr, atol, "resid k=100")
    log(f"[phase1] tile_scan resid k=100 mask=True: ok (atol {atol:.2e}, "
        f"{ties} tie swaps)")
    dbf = (db.astype(jnp.float32) / 127.0)
    for mode, arena, qq in (
            (True, db, jnp.clip(jnp.round(q * 127 / jnp.max(jnp.abs(q))),
                                -127, 127).astype(jnp.int8)),
            ("hybrid", db, q), (False, dbf, q)):
        kw = dict(tile_n=tile_n, tile_q=tile_q, int8=mode, n_valid=n - 1000)
        vk, ik = tiles_topk(arena, qq, tt, K, impl=IMPL, candidates=True,
                            **kw)
        with jax.default_matmul_precision("highest"):
            vr, ir = tiles_topk(arena, qq, tt, K, impl="xla", candidates=True,
                                **kw)
        # f32 arena: the kernel's dot runs in IEEE f32, not TF32
        atol = 1e-5 * float(jnp.max(jnp.abs(jnp.where(
            jnp.isfinite(vr), vr, 0)))) + 1e-6
        ties = check_same_topk(vk, ik, vr, ir, atol, f"plain int8={mode}",
                               group=keep)
        log(f"[phase1] tile_scan plain int8={mode}: ok (atol {atol:.2e}, "
            f"{ties} tie swaps)")


# -- phase 2 -----------------------------------------------------------------

def phase_pipeline():
    import numpy as np

    from cloudvectordb_tpu.cli import main as cli_main

    work = HERE / "artifacts" / "chip_smoke_pipeline"
    if work.exists():
        import shutil

        shutil.rmtree(work)
    sets = {
        "workdir": str(work),
        "data.num_docs": PIPE["num_docs"],
        "data.max_len": 128,
        "mining.num_triplets": PIPE["batch"] * PIPE["steps"],
        "train.encoder_preset": PIPE["preset"],
        "train.encoder.max_len": 128,
        "train.batch_size": PIPE["batch"],
        "train.total_steps": PIPE["steps"],
        "train.warmup_steps": 5,
        "train.lr": 1e-4,  # 5e-4 collapses the from-scratch encoder
        "train.uniformity_weight": 0.1,  # keeps the embeddings off a cone
        "train.log_every": 5,
        "train.ckpt_every": 40,
        "train.ckpt_dir": str(work / "ckpt"),
        "index.kind": "band_ivf",
        "index.residual": True,
        "index.nlist": PIPE["nlist"],
        "index.nprobe": 128,
        "index.train_sample": 20000,
        "encode_batch": 1024,
        "eval_queries": 1024,
    }
    argv = []
    for k, v in sets.items():
        argv += ["--set", f"{k}={json.dumps(v)}"]
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["pipeline", *argv])
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    dt = time.perf_counter() - t0
    metrics = [json.loads(line) for line in
               (work / "metrics.jsonl").read_text().splitlines()]
    losses = [m["loss"] for m in metrics if m["event"] == "train_step"]
    n_pass = len(np.load(work / "embeddings.npy", mmap_mode="r"))
    assert n_pass >= PIPE["num_docs"], n_pass
    assert len(losses) >= 4 and losses[-1] < losses[0], losses
    # the 0.95 bar is phase 3's; here recall only shows the index is wired
    # to the trained encoder (a few dozen steps from scratch leave the
    # embeddings close together, which int8 residuals resolve only partly)
    assert result["recall_at_k"] >= 0.8, result
    log(f"[phase2] pipeline: {n_pass} passages, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {len(losses)} logs, band_ivf recall@10 "
        f"{result['recall_at_k']:.4f}, eval qps {result['qps']:.0f} "
        f"({dt:.0f}s incl. compile)")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["search", "--query", "the telescope and the galaxy",
                  "-k", "5", *argv])
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 5 and lines[0].lstrip().startswith("1. ["), lines
    for ln in lines:
        log(f"[phase2] search: {ln.strip()[:100]}")


# -- phase 3 -----------------------------------------------------------------

def phase_store():
    import jax

    from cloudvectordb_tpu.eval.recall import recall_at_k
    from cloudvectordb_tpu.index.ivf_band import (
        BandIVFIndex, _tiles_resid_plan_search)

    gen = corpus_gen()
    n_chunks = N_SCALE // CHUNK

    def chunk_fn(i):
        return gen(jax.random.PRNGKey(i), CHUNK)

    t0 = time.perf_counter()
    q = make_queries(chunk_fn(0), B)
    gt = exact_ground_truth(chunk_fn, n_chunks, q[:NQ_GT], K)
    t_gt = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = BandIVFIndex.build_device_streaming(
        chunk_fn, n_chunks, nlist=NLIST, kmeans_iters=10, residual=True)
    st = idx._device_state()
    jax.block_until_ready(st["payload"])
    t_build = time.perf_counter() - t0
    n_tiles = int(idx._payload.shape[0]) // idx.tile_n
    log(f"[phase3] built {idx.ntotal} x {D} residual int8, nlist={NLIST}, "
        f"{n_tiles} tiles of {idx.tile_n} in {t_build:.0f}s "
        f"(exact f32 ground truth {t_gt:.0f}s)")

    def run(p, impl=IMPL, queries=q):
        return _tiles_resid_plan_search(
            queries, st["centroids"], st["payload"], st["local"], idx._scale,
            st["ids"], st["tile_window"], st["valid_end"], k=K, p_tiles=p,
            tile_n=idx.tile_n, tile_q=idx.tile_q, impl=impl)

    chosen = None
    for p in P_LADDER:
        _, ids = run(min(p, n_tiles))
        r = recall_at_k(jax.device_get(ids)[:NQ_GT], gt)
        log(f"[phase3] p_tiles={p}: recall@10 {r:.4f} on {NQ_GT} queries")
        if r >= 0.95:
            chosen = (min(p, n_tiles), r)
            break
    assert chosen is not None, "recall@10 < 0.95 on the whole p_tiles ladder"
    p, r = chosen

    def qps_of(impl):
        jax.block_until_ready(run(p, impl))
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(run(p, impl))
        return B * reps / (time.perf_counter() - t0)

    qps_kernel = qps_of(IMPL)
    qps_xla = qps_of("xla")
    qps_kernel2 = qps_of(IMPL)
    _, ids_dev = idx.search_device(q, K, p_tiles=p,
                                   interpret=IMPL == "interpret")
    r_api = recall_at_k(jax.device_get(ids_dev)[:NQ_GT], gt)
    assert r_api >= 0.95, r_api
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    log(f"[phase3] recall@10 {r:.4f} at p_tiles={p} of {n_tiles} "
        f"(tile_q={idx.tile_q}); search_device recall {r_api:.4f}")
    log(f"[phase3] QPS at B={B}, k={K}: {IMPL} tile scan "
        f"{qps_kernel:.0f} / {qps_kernel2:.0f}, plain XLA form {qps_xla:.0f} "
        f"(information); peak device memory {peak / 2**30:.2f} GiB")


# -- phase 4 -----------------------------------------------------------------

def phase_four_cards():
    import dataclasses

    import jax
    import numpy as np

    from cloudvectordb_tpu.eval.recall import recall_at_k
    from cloudvectordb_tpu.models.presets import get_preset
    from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex
    from cloudvectordb_tpu.parallel.mesh import make_mesh
    from cloudvectordb_tpu.train.trainer import Trainer
    from cloudvectordb_tpu.utils.config import TrainConfig

    devs = jax.devices()[:4]
    # data-parallel step: dropout off so one card and four compute the same
    # function; only the gradient all-reduce order differs
    enc = dataclasses.replace(get_preset("minilm-l6-384"), max_len=128,
                              dropout=0.0, attn_dropout=0.0)
    rng = np.random.default_rng(0)
    batch = {}
    for name in ("anchor", "pos", "neg"):
        ids = rng.integers(4, enc.vocab_size, (TRAIN_B, 128)).astype(np.int32)
        mask = np.ones((TRAIN_B, 128), np.int32)
        mask[:, 96:] = 0
        batch[f"{name}_ids"], batch[f"{name}_mask"] = ids, mask
    losses = {}
    for cards in (4, 1):
        cfg = TrainConfig(encoder=enc, batch_size=TRAIN_B, total_steps=10,
                          warmup_steps=1, lr=1e-3)
        tr = Trainer(cfg, mesh=make_mesh(cards, axis_name="data",
                                         devices=devs[:cards]))
        state = tr.init_state(seed=0)
        out = []
        for _ in range(3):  # step 1 runs at warmup lr 0; 2-3 see updates
            state, m = tr.step_fn(state, tr.place_batch(batch))
            out.append(float(m["loss"]))
        losses[cards] = out
        del state
    # bf16 activations: per-example math is the same on 1 and 4 cards, but
    # the library may pick other kernels for 512 vs 128 rows; 2e-3 relative
    # covers bf16 rounding differences of the mean loss
    for a, b in zip(losses[4], losses[1]):
        assert abs(a - b) <= 2e-3 * abs(b), losses
    log(f"[phase4] data-parallel minilm-l6-384 step, global batch {TRAIN_B}: "
        f"losses 4 cards {losses[4]} vs 1 card {losses[1]}")

    gen = corpus_gen()
    n_chunks = 4 * N_SCALE // CHUNK

    def chunk_fn(i):
        return gen(jax.random.PRNGKey(i), CHUNK)

    t0 = time.perf_counter()
    mesh = make_mesh(4, axis_name="shard", devices=devs)
    idx = ShardedBandIndex.build_streaming(
        (chunk_fn(i) for i in range(n_chunks)), nlist=NLIST, mesh=mesh,
        dtype="int8", residual=True, kmeans_iters=10)
    st = idx._device_state()
    jax.block_until_ready(st["payload"])
    placed = {d.id for d in st["payload"].sharding.device_set}
    assert placed == {d.id for d in devs}, placed
    t_build = time.perf_counter() - t0
    q = make_queries(chunk_fn(0), B)
    gt = exact_ground_truth(chunk_fn, n_chunks, q[:NQ_GT], K)
    log(f"[phase4] sharded build {idx.ntotal} x {D} over devices "
        f"{sorted(placed)} in {t_build:.0f}s")
    qh = np.asarray(q)
    chosen = None
    for p in P_LADDER:
        p = min(p, int(st["n_tiles"]))
        v, ids = idx.search(qh, K, p_tiles=p, interpret=IMPL == "interpret")
        r = recall_at_k(ids[:NQ_GT], gt)
        log(f"[phase4] sharded p_tiles={p}: recall@10 {r:.4f}")
        if r >= 0.95:
            chosen = p
            break
    assert chosen is not None, "sharded recall@10 < 0.95 on the ladder"
    # host merge of each shard's own search on its own card
    pv, pi = [], []
    for sh, dev in zip(idx._shards, devs):
        with jax.default_device(dev):
            sv, si = sh.search(qh, K, p_tiles=chosen,
                               interpret=IMPL == "interpret")
        pv.append(sv)
        pi.append(si)
        sh._dev = None  # free the per-shard copy
    cv, ci = np.concatenate(pv, 1), np.concatenate(pi, 1)
    o = np.argsort(-cv, axis=1, kind="stable")[:, :K]
    hv, hi = np.take_along_axis(cv, o, 1), np.take_along_axis(ci, o, 1)
    atol = 1e-5 * float(np.abs(hv).max())
    ties = check_same_topk(v, ids, hv, hi, atol, "sharded vs host merge")
    log(f"[phase4] sharded ids == host merge of per-shard top-k "
        f"({ties} tie swaps) at p_tiles={chosen}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card phase")
    ap.add_argument("--phases", default="0,1,2,3",
                    help="comma list of one-card phases to run (debugging)")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on the CPU, kernel interpreted")
    args = ap.parse_args()
    if args.rehearse:
        _rehearsal_sizes()
    t_all = time.perf_counter()
    devs = phase_device(args.cards, args.rehearse)
    if args.cards == 4:
        phase_four_cards()
    else:
        phases = {int(x) for x in args.phases.split(",")}
        for ph, fn in ((1, phase_kernels), (2, phase_pipeline),
                       (3, phase_store)):
            if ph in phases:
                t0 = time.perf_counter()
                fn()
                log(f"[phase{ph}] done in {time.perf_counter() - t0:.0f}s")
    log(f"[chip_smoke] all phases passed in {time.perf_counter() - t_all:.0f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
