"""L1 mesh & collectives: device mesh, sharding rules, distributed query path.

All collective use is confined to this package (SURVEY.md §5.8) so the
single-device, simulated-CPU-mesh, and multi-GPU paths share code.
"""

from cloudvectordb_tpu.parallel.mesh import (  # noqa: F401
    init_multihost,
    make_2d_mesh,
    make_mesh,
    data_sharding,
    replicated,
    shard_rows,
    stage_replicated,
    stage_row_sharded,
)
from cloudvectordb_tpu.parallel.dist_search import DistributedFlatIndex  # noqa: F401
from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex  # noqa: F401
from cloudvectordb_tpu.parallel.dist_band_pq import ShardedBandIVFPQIndex  # noqa: F401
from cloudvectordb_tpu.parallel.dist_ivf import ShardedIVFPQIndex  # noqa: F401
