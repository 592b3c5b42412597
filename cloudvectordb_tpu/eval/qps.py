"""Query-throughput measurement (SURVEY.md §5.1).

Fencing: ``jax.block_until_ready`` on the outputs of the timed work — JAX
returns before the device finishes, so a timing without it measures the
enqueue. Each result names the device it ran on (``device_info``); a
number from a CPU run is a CPU number.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def step_seconds(step_fn: Callable, *args, reps: int = 16) -> float:
    """Mean wall-clock seconds of ``step_fn(*args)`` once compiled: one
    warm call, then ``reps`` calls, each fenced by block_until_ready."""
    jax.block_until_ready(step_fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(step_fn(*args))
    return (time.perf_counter() - t0) / reps


def qps_bench(
    search_fn: Callable,
    queries,
    *,
    batch: int | None = None,
    warmup: int = 1,
    iters: int = 3,
) -> dict:
    """Steady-state queries/second of ``search_fn(queries_batch)`` (device
    or numpy outputs; device outputs are fenced)."""
    queries = jnp.asarray(queries)
    nq = queries.shape[0]
    if batch is None:
        batch = nq

    def run_once():
        for s in range(0, nq, batch):
            jax.block_until_ready(search_fn(queries[s : s + batch]))

    for _ in range(warmup):
        run_once()
    t0 = time.perf_counter()
    for _ in range(iters):
        run_once()
    dt = time.perf_counter() - t0
    return {
        "qps": nq * iters / dt,
        "latency_ms": 1000.0 * dt / (iters * max(1, -(-nq // batch))),
        "batch": batch,
        "device": device_info(),
    }
