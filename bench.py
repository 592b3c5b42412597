"""Headline benchmark on one NVIDIA GPU.

    python bench.py

BASELINE config #4's per-card share as sized so far (ROADMAP W1): 12.5M×768
unit vectors (a 32-d latent mixture generated on the device from fixed
PRNG keys), residual-int8 tile-pruned IVF (index/ivf_band.py,
residual=True) built device-resident with nlist=4096, batch 4096, k=10.
The smallest p_tiles of a fixed ladder whose recall@10 against an exact
streamed f32 ground truth (Precision.HIGHEST, 1,024 queries) reaches 0.95
is served; QPS is timed with jax.block_until_ready.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "recall_at_10", "p_tiles", "device"}.
Fails unless JAX runs on a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402  (corpus, queries, exact ground truth)

REPS = 8


def main() -> None:
    import jax

    from cloudvectordb_tpu.eval.qps import device_info
    from cloudvectordb_tpu.eval.recall import recall_at_k
    from cloudvectordb_tpu.index.ivf_band import BandIVFIndex
    from cloudvectordb_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    dev = device_info()
    if dev["platform"] != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX runs on {dev['platform']}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[bench] card: {card}", flush=True)

    gen = cs.corpus_gen()
    n_chunks = cs.N_SCALE // cs.CHUNK

    def chunk_fn(i):
        return gen(jax.random.PRNGKey(i), cs.CHUNK)

    q = cs.make_queries(chunk_fn(0), cs.B)
    gt = cs.exact_ground_truth(chunk_fn, n_chunks, q[: cs.NQ_GT], cs.K)
    idx = BandIVFIndex.build_device_streaming(
        chunk_fn, n_chunks, nlist=cs.NLIST, kmeans_iters=10, residual=True)
    n_tiles = int(idx._payload.shape[0]) // idx.tile_n
    chosen = None
    for p in cs.P_LADDER:
        p = min(p, n_tiles)
        _, ids = idx.search_device(q, cs.K, p_tiles=p)
        r = recall_at_k(jax.device_get(ids)[: cs.NQ_GT], gt)
        print(f"[bench] p_tiles={p}: recall@10 {r:.4f}", flush=True)
        if r >= 0.95:
            chosen = (p, r)
            break
    assert chosen is not None, "recall@10 < 0.95 on the whole ladder"
    p, r = chosen
    jax.block_until_ready(idx.search_device(q, cs.K, p_tiles=p))
    t0 = time.perf_counter()
    for _ in range(REPS):
        jax.block_until_ready(idx.search_device(q, cs.K, p_tiles=p))
    qps = cs.B * REPS / (time.perf_counter() - t0)
    print(json.dumps({
        "metric": f"resid8_tiles_qps_{cs.N_SCALE}x{cs.D}_k{cs.K}_b{cs.B}",
        "value": qps, "unit": "qps", "recall_at_10": r,
        "p_tiles": p, "n_tiles": n_tiles, "device": dev, "card": card,
    }))


if __name__ == "__main__":
    main()
