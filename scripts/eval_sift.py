"""BASELINE config #1/#2 harness: SIFT1M-format exact + IVF nprobe sweep.

With real SIFT1M files (`--base sift_base.fvecs --query sift_query.fvecs
[--gt sift_groundtruth.ivecs]`) this evaluates on the actual dataset; offline
it falls back to synthetic clustered 128-d vectors of the same shape
(SURVEY.md §4.2). Prints a recall/QPS table per nprobe plus the exact-path
sanity row.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default=None)
    ap.add_argument("--query", default=None)
    ap.add_argument("--gt", default=None)
    ap.add_argument("--n", type=int, default=200_000, help="synthetic DB size")
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--metric", default="l2", choices=["l2", "ip"])
    args = ap.parse_args()

    from cloudvectordb_tpu.data.synthetic import (
        clustered_vectors, queries_from, read_fvecs, read_ivecs,
    )
    from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
    from cloudvectordb_tpu.eval.sweep import nprobe_sweep, operating_point
    from cloudvectordb_tpu.index import FlatIndex, IVFFlatIndex

    if args.base:
        base = read_fvecs(args.base)
        queries = read_fvecs(args.query, max_rows=args.nq)
        gt = read_ivecs(args.gt, max_rows=args.nq) if args.gt else None
        print(f"SIFT: base {base.shape}, queries {queries.shape}")
    else:
        base = clustered_vectors(args.n, 128, n_clusters=256, seed=0)
        queries = queries_from(base, args.nq, seed=1)
        gt = None
        print(f"synthetic SIFT-shape: base {base.shape}, queries {queries.shape}")

    if gt is None:
        _, gt = brute_force_topk(base, queries, args.k, metric=args.metric)

    # config #1: exact brute-force sanity
    flat = FlatIndex.build(base, metric=args.metric)
    _, i_flat = flat.search(queries, args.k)
    print(f"exact recall@{args.k}: {recall_at_k(i_flat, gt):.4f} (must be 1.0)")

    # config #2 shape: IVF-Flat nprobe sweep
    ivf = IVFFlatIndex.build(base, nlist=args.nlist, metric=args.metric,
                             kmeans_iters=10)
    rows = nprobe_sweep(ivf, base, queries, k=args.k,
                        nprobes=(1, 2, 4, 8, 16, 32, 64, 128), gt_ids=gt)
    for r in rows:
        print(json.dumps(r))
    op = operating_point(rows, 0.95)
    print("operating point (recall≥0.95):", json.dumps(op))


if __name__ == "__main__":
    main()
