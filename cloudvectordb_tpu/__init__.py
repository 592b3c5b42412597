"""cloudvectordb_tpu — a dataset→encoder→embeddings→vectordb framework in JAX,
running on NVIDIA GPUs (the package name records the accelerator it was
first built for).

A from-scratch JAX/XLA/Pallas rebuild of the capability surface stated by the
reference (``/root/reference/README.md:2``): "building a very large dataset of
triplets, then training encoders, then building the embeddings with the
encoder, then building the vectordb with the encoder."

Layers (see SURVEY.md §1.2):
  L0 ops/       — tile-scan kernel (Pallas/Triton), top-k, PQ scans, assignment
  L1 parallel/  — device mesh, sharding specs, distributed query fan-out/merge
  L2 train/     — contrastive losses, data-parallel train step, checkpointing
  L3 index/     — Flat, IVF-Flat, IVF-PQ, OPQ; k-means + PQ codebook training
  L4 data/      — corpus streaming, tokenization, triplet mining
  L5 models/    — plain-JAX transformer sentence encoder + large-batch encode
  L6 pipeline/  — stage sequencing (mine → train → encode → build → eval)
  L7 eval/      — brute-force ground truth, recall@k, QPS harness
"""

__version__ = "0.1.0"

from cloudvectordb_tpu.utils.config import (  # noqa: F401
    EncoderConfig,
    IndexConfig,
    MiningConfig,
    PipelineConfig,
    TrainConfig,
)
