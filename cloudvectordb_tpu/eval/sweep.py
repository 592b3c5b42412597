"""nprobe sweep harness (BASELINE config #2: recall-vs-QPS tradeoff curves).

For an IVF index and query set: measure recall@k against the exact oracle and
steady-state QPS at each nprobe; emit the operating-point table.
"""

from __future__ import annotations

import time

import numpy as np

from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k


def nprobe_sweep(
    index,
    vectors: np.ndarray,
    queries: np.ndarray,
    k: int = 10,
    nprobes=(1, 2, 4, 8, 16, 32, 64),
    batch: int = 256,
    time_iters: int = 3,
    gt_ids: np.ndarray | None = None,
) -> list[dict]:
    """Returns [{nprobe, recall, qps, latency_ms}, ...]."""
    import inspect

    if gt_ids is None:
        _, gt_ids = brute_force_topk(vectors, queries, k, metric=index.metric)
    # band indexes batch internally and take no `batch=` kwarg — only pass
    # it to search() signatures that accept it (probe-scan IVF family)
    sig = inspect.signature(index.search)
    kw = (
        {"batch": batch}
        if "batch" in sig.parameters
        or any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values())
        else {}
    )
    out = []
    for nprobe in nprobes:
        nprobe = min(nprobe, getattr(index, "nlist", nprobe))
        _, found = index.search(queries, k, nprobe=nprobe, **kw)
        r = recall_at_k(found, gt_ids)
        index.search(queries[:batch], k, nprobe=nprobe, **kw)  # warm
        t0 = time.perf_counter()
        for _ in range(time_iters):  # numpy outputs fence each call
            index.search(queries, k, nprobe=nprobe, **kw)
        dt = time.perf_counter() - t0
        qps = queries.shape[0] * time_iters / dt
        out.append(
            {
                "nprobe": int(nprobe),
                "recall": float(r),
                "qps": float(qps),
                "latency_ms": 1000.0 * dt / (time_iters * max(1, len(queries) // batch)),
            }
        )
        if r >= 0.9999:
            break
    return out


def operating_point(sweep: list[dict], min_recall: float = 0.95) -> dict | None:
    """Cheapest nprobe meeting the recall floor (the serving config)."""
    for row in sweep:
        if row["recall"] >= min_recall:
            return row
    return None
