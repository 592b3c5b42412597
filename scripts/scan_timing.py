"""Tile-scan op points on the GPU: the Triton kernel vs its plain-XLA form.

    python scripts/scan_timing.py

Builds chip_smoke.py's phase-3 store (12.5M×768 residual int8, nlist=4096,
device-resident) once, then for each planner query-group size tile_q walks
the p_tiles ladder to the first op point with recall@10 ≥ 0.95 (exact f32
ground truth, 1,024 queries) and times a B=4096, k=10 batch there with the
Triton kernel and with the plain XLA form (mean of fenced calls). Prints
the card's name and power limit first. Needs a GPU.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

TILE_QS = (64, 128, 256)
REPS = 5


def main() -> None:
    import jax

    from cloudvectordb_tpu.eval.recall import recall_at_k
    from cloudvectordb_tpu.index.ivf_band import (
        BandIVFIndex, _tiles_resid_plan_search)
    from cloudvectordb_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    assert jax.devices()[0].platform == "gpu", "needs a GPU"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = cs.corpus_gen()
    n_chunks = cs.N_SCALE // cs.CHUNK

    def chunk_fn(i):
        return gen(jax.random.PRNGKey(i), cs.CHUNK)

    q = cs.make_queries(chunk_fn(0), cs.B)
    gt = cs.exact_ground_truth(chunk_fn, n_chunks, q[: cs.NQ_GT], cs.K)
    idx = BandIVFIndex.build_device_streaming(
        chunk_fn, n_chunks, nlist=cs.NLIST, kmeans_iters=10, residual=True)
    st = idx._device_state()
    n_tiles = int(idx._payload.shape[0]) // idx.tile_n

    def run(p, tq, impl):
        return _tiles_resid_plan_search(
            q, st["centroids"], st["payload"], st["local"], idx._scale,
            st["ids"], st["tile_window"], st["valid_end"], k=cs.K,
            p_tiles=p, tile_n=idx.tile_n, tile_q=tq, impl=impl)

    def ms(p, tq, impl):
        jax.block_until_ready(run(p, tq, impl))
        t0 = time.perf_counter()
        for _ in range(REPS):
            jax.block_until_ready(run(p, tq, impl))
        return 1e3 * (time.perf_counter() - t0) / REPS

    for tq in TILE_QS:
        for p in cs.P_LADDER:
            p = min(p, n_tiles)
            _, ids = run(p, tq, "triton")
            r = recall_at_k(jax.device_get(ids)[: cs.NQ_GT], gt)
            if r >= 0.95:
                break
        t_k, t_x = ms(p, tq, "triton"), ms(p, tq, "xla")
        t_k2 = ms(p, tq, "triton")
        print(f"tile_q={tq} p_tiles={p}/{n_tiles} recall@10={r:.4f} "
              f"B={cs.B}: triton {t_k:.2f}/{t_k2:.2f} ms "
              f"({cs.B / t_k * 1e3:.0f} qps), xla {t_x:.2f} ms "
              f"({cs.B / t_x * 1e3:.0f} qps)", flush=True)


if __name__ == "__main__":
    main()
