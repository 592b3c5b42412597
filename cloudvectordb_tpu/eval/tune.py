"""Op-point auto-tuner (SURVEY.md §7.1 M8) with fastest-measured
selection.

``Index.tune(queries, target_recall)`` replaces hand-carried env knobs
(p_tiles / tile_q / k_cand / n_pools / nprobe): each index family supplies a
cost-ordered candidate ladder (``Index._tune_candidates``) and a max-effort
reference config (``Index._tune_reference_kw``); the engine walks the ladder
cheapest-first measuring recall@k against the reference (or a caller-
supplied exact ground truth). Selection is by MEASURED throughput, not by
the static cost proxy: the first passing config in each ``tile_q`` branch
becomes a finalist (within a branch, deeper coverage at the same tile_q is
strictly more work, so the first pass is that branch's fastest pass — but
ACROSS branches the proxy is wrong: a larger tile_q amortizes dispatch and
can be faster at 3.5x the tile coverage, the r3 p=448/tq=128 vs r4
p=128/tq=32 inversion), every finalist is wall-clock timed on the fenced
loop (every call fenced — eval/qps.py), and the fastest measured passing
config wins. The chosen op point
is stored on the index (``_op_point``) where ``search()`` picks it up for
any knob the caller leaves at its sentinel default, and persisted in the
artifact manifest so a loaded index serves tuned out of the box.

Recall semantics: with ``gt=None`` the reference is the index's OWN
max-effort configuration, so recall is relative to the index's ceiling
(quantizer loss excluded) — the right objective for knob tuning. Pass an
exact ``gt`` (brute-force ids) to tune against absolute recall instead.
"""

from __future__ import annotations

import time

import numpy as np

from cloudvectordb_tpu.eval.recall import recall_at_k


class TunableMixin:
    """``tune()`` + tuned-op-point storage, shared by single indexes
    (index/base.py) and the sharded wrappers (parallel/dist_*.py) so the
    tune contract lives in exactly one place. Subclasses supply
    ``_tune_candidates(nq)`` (cost-ordered ladder of search() kwargs) and
    ``_tune_reference_kw(nq)`` (max-effort config)."""

    #: tuned serving knobs — search() uses these for any parameter the
    #: caller leaves at its sentinel default; persisted in the manifest
    _op_point: dict | None = None

    def _tune_candidates(self, nq: int) -> list[dict]:
        raise NotImplementedError(
            f"{type(self).__name__} does not support tune()")

    def _tune_reference_kw(self, nq: int) -> dict:
        raise NotImplementedError

    def tune(self, queries, k: int = 10, target_recall: float = 0.95,
             gt: np.ndarray | None = None, time_iters: int = 3,
             verbose: bool = False, max_finalists: int = 4) -> dict:
        """Pick the fastest MEASURED serving config meeting
        ``target_recall`` on ``queries`` and make it this index's default
        op point (also saved in the manifest). Returns the tune report —
        see tune_index."""
        report = tune_index(self, queries, k, target_recall, gt,
                            time_iters=time_iters, verbose=verbose,
                            max_finalists=max_finalists)
        self._op_point = report["op"]
        return report


def _time_search(index, queries, k: int, kw: dict, iters: int = 3) -> dict:
    """Wall-clock of index.search (its numpy outputs fence every call)."""
    t0 = time.perf_counter()
    for _ in range(iters):
        index.search(queries, k, **kw)
    dt = (time.perf_counter() - t0) / iters
    return {"qps": queries.shape[0] / dt, "latency_ms": 1000.0 * dt}


def _proxy_cost(cfg: dict) -> float:
    """Per-query scan-work proxy, family-agnostic: coverage knob times the
    refine-depth multipliers. Used ONLY to bound how far past the first
    finalist the ladder keeps evaluating — selection itself is by measured
    wall-clock (this proxy mispredicts across tile_q, which is the whole
    reason finalists are timed)."""
    c = float(cfg.get("p_tiles") or cfg.get("nprobe") or 1)
    c *= 1 + cfg.get("refine_factor", 0) / 256.0
    c *= 1 + cfg.get("host_factor", 0) / 512.0
    return c


def tune_index(
    index,
    queries,
    k: int = 10,
    target_recall: float = 0.95,
    gt: np.ndarray | None = None,
    time_iters: int = 3,
    verbose: bool = False,
    max_finalists: int = 4,
) -> dict:
    """Walk the index's candidate ladder; return the chosen op point.

    Returns ``{"op": dict, "recall": float, "met": bool, "qps": float,
    "latency_ms": float,
    "tried": [...], "finalists": [...]}. ``met=False`` means no candidate
    reached the target and ``op`` is the best-recall candidate instead
    (its recall is reported). When candidates pass, the first passing
    config in each tile_q branch (up to ``max_finalists``) is wall-clock
    timed and the FASTEST MEASURED one is chosen — the static cost proxy
    only orders the walk, it does not pick the winner (tile_q amortizes
    dispatch, so the proxy-cheapest pass can be 30%
    slower than a deeper-coverage/larger-tile_q pass)."""
    queries = np.asarray(queries, np.float32)
    nq = queries.shape[0]
    candidates = index._tune_candidates(nq)
    assert candidates, "index supplied an empty tune ladder"
    if gt is None:
        # the max-effort reference is the deepest-coverage config of all —
        # the one most likely to run out of device memory at scale. Fall
        # back down the ladder (most expensive first) so one failure
        # degrades the reference instead of aborting the whole tune.
        ref_err = None
        for ref_kw in [index._tune_reference_kw(nq)] + candidates[::-1]:
            try:
                _, gt = index.search(queries, k, **ref_kw)
                break
            except Exception as e:  # noqa: BLE001 — see ladder except below
                ref_err = e
                if verbose:
                    print(f"[tune] reference {ref_kw}: FAILED "
                          f"{type(e).__name__}", flush=True)
        if gt is None:
            raise RuntimeError(
                f"no reference config compiled; last error: {ref_err}")
    tried = []
    best = None  # (recall, cfg) fallback when nothing meets target
    finalists: dict = {}  # tile_q branch -> (recall, cfg), first pass each
    n_branches = len({c.get("tile_q") for c in candidates})
    for cfg in candidates:
        branch = cfg.get("tile_q")
        if branch in finalists:
            continue  # within a branch the first pass is its fastest pass
        if finalists and _proxy_cost(cfg) > 4.0 * min(
                _proxy_cost(f[1]) for f in finalists.values()):
            # a branch whose cheapest pass needs >4x the scan work of an
            # already-passing config cannot win on wall-clock (dispatch
            # amortization buys ~1.3x, not 4x) — stop burning device time
            continue
        try:
            _, found = index.search(queries, k, **cfg)
        except Exception as e:  # noqa: BLE001 — a single config must not
            # abort the ladder: deep/large-p combos can run out of device
            # memory at scale
            tried.append({**cfg, "error": f"{type(e).__name__}: {e}"[:160]})
            if verbose:
                print(f"[tune] {cfg}: FAILED {type(e).__name__}", flush=True)
            continue
        r = float(recall_at_k(found, gt))
        tried.append({**cfg, "recall": r})
        if verbose:
            print(f"[tune] {cfg}: recall@{k}={r:.4f}", flush=True)
        if best is None or r > best[0]:
            best = (r, cfg)
        if r >= target_recall:
            finalists[branch] = (r, cfg)
            if len(finalists) >= min(max_finalists, n_branches):
                break
    if best is None:
        raise RuntimeError(f"every tune candidate failed: {tried}")
    if not finalists:
        recall, op = best
        timing = _time_search(index, queries, k, op, iters=time_iters)
        return {"op": dict(op), "recall": recall, "met": False, **timing,
                "tried": tried, "finalists": []}
    # fastest MEASURED passing config wins (recall breaks qps ties)
    measured = []
    for r, cfg in finalists.values():
        t = _time_search(index, queries, k, cfg, iters=time_iters)
        measured.append({"op": dict(cfg), "recall": r, **t})
        if verbose:
            print(f"[tune] finalist {cfg}: {t['qps']:,.0f} qps "
                  f"(recall {r:.4f})", flush=True)
    measured.sort(key=lambda m: (-m["qps"], -m["recall"]))
    win = measured[0]
    return {"op": win["op"], "recall": win["recall"], "met": True,
            "qps": win["qps"], "latency_ms": win["latency_ms"],
            "tried": tried, "finalists": measured}
