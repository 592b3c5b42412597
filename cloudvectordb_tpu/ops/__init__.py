"""L0 kernels: distance+top-k, PQ decode/ADC, k-means assignment.

Every hot op has a plain XLA form (``lax.scan``/``lax.map`` over tiles)
that runs on any backend. The tile-pruned residual-int8 scan — the
serving hot path — also has a Pallas kernel compiled through Triton for
the GPU (ops/pallas_band.py), which keeps the gathered tiles and the
score matrix out of device memory; ops/backend.py decides which runs.
"""

import functools

from cloudvectordb_tpu.ops.topk import tiled_topk, merge_topk  # noqa: F401
from cloudvectordb_tpu.ops.assign import assign_clusters  # noqa: F401
from cloudvectordb_tpu.ops.adc import adc_scan  # noqa: F401

# SURVEY.md §1.2 L0 public interface names
topk_ip = functools.partial(tiled_topk, metric="ip")
topk_l2 = functools.partial(tiled_topk, metric="l2")
assign_centroids = assign_clusters
