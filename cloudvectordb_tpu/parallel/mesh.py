"""Mesh construction + sharding specs (SURVEY.md §2.3).

Axes:
  'data'  — batch axis for training / encoding (DP);
  'shard' — database axis for the index (the vectordb analog of TP): index
            rows live sharded across device memory, queries are broadcast.

Meshes take the visible devices in order: the cards of one host reach each
other all to all over NVLink, so no torus shape matters. TP/PP for the
encoder are deliberately absent: MiniLM-class models fit on one card
(SURVEY.md §2.3, documented decision).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              devices=None) -> Mesh:
    """1-D mesh over the first n of ``devices`` (default: all visible)."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None,
                   cpu_collectives: str | None = None) -> int:
    """Phase-2 multi-slice scale-out over DCN (SURVEY.md §2.3 last row).

    Wraps jax.distributed.initialize; after this, jax.devices() spans all
    hosts and the same make_mesh/shard_map code runs across slices (XLA
    routes intra-host collectives over NVLink and inter-host over the
    network).
    Returns the global device count. No-op when already initialized.

    cpu_collectives: set to "gloo" (or "mpi") to run cross-PROCESS
    collectives on the CPU backend — the DCN stand-in this environment can
    actually execute: N processes × M simulated devices each behave exactly
    like N hosts of an N×M slice (tests/distributed/test_multihost.py runs
    the sharded serving path this way, 2 processes over TCP).
    """
    if cpu_collectives is not None:
        jax.config.update("jax_cpu_collectives_implementation",
                          cpu_collectives)
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        # re-raise real failures; only an actually-initialized runtime may
        # pass (a blanket pass here silently degraded to single-process)
        if not jax.distributed.is_initialized():
            raise
    return len(jax.devices())


def assert_equal_across_processes(values, context: str) -> None:
    """Raise (on EVERY process, no deadlock) when an int tuple differs
    across processes. Multi-process SPMD compiles one program per process
    from process-local values — a silent mismatch (different batch sizes,
    different static knobs) deadlocks or corrupts the cross-host
    collectives, so serving paths check the contract up front. Costs one
    tiny (len(values),) all-gather; no-op single-process."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    mine = np.asarray(values, np.int64)
    everyone = np.asarray(multihost_utils.process_allgather(mine))
    if not (everyone == mine[None]).all():
        raise ValueError(
            f"multi-process contract violated ({context}): every process "
            f"must pass identical values, got\n{everyone}")


def stage_queries(qp: np.ndarray, mesh: Mesh, *, statics=(),
                  crc_check: bool | None = None):
    """Stage a (padded) query batch for a multi-process collective search.

    Contract enforced (see assert_equal_across_processes): every process
    passes the same batch SHAPE and the same static knobs. On a mesh whose
    'replica' axis spans the processes, `qp` is this host's own traffic
    slice (content may differ per host); on any other mesh the batch is
    broadcast — all hosts must pass the IDENTICAL array, verified by a
    CRC (crc_check defaults to exactly that rule). Single-process returns
    qp placed as usual."""
    qp = np.ascontiguousarray(qp)
    nproc = jax.process_count()
    if nproc == 1:
        import jax.numpy as jnp

        return jnp.asarray(qp)
    n_rep = dict(zip(mesh.axis_names, mesh.devices.shape)).get("replica", 1)
    assert n_rep in (1, nproc), (
        "multi-process serving needs one replica per process (or a 1-D "
        f"mesh): n_replica={n_rep}, processes={nproc}")
    per_host_traffic = n_rep == nproc
    if crc_check is None:
        crc_check = not per_host_traffic
    import zlib

    crc = zlib.crc32(qp.tobytes()) if crc_check else 0
    assert_equal_across_processes(
        (*qp.shape, crc, *statics), "query batch shape"
        + ("+content" if crc_check else "") + "+static knobs")
    spec = P("replica") if per_host_traffic else P()
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), qp)


def fetch_local(arr) -> np.ndarray:
    """This process's slice of a collective-search output (the full batch
    when the out-spec is replicated, this host's replica slice otherwise).
    Works single-process too (plain device fetch)."""
    if jax.process_count() == 1:
        return np.asarray(arr)
    return np.asarray(jax.device_get(arr.addressable_data(0)))


def stage_replicated(x, mesh: Mesh):
    """Replicate a host array onto every device of the mesh, multi-process
    safe: single-process uses a plain device_put; under multi-host each
    process contributes its (identical) full copy and receives a GLOBAL
    array — required because a collective jit rejects process-local inputs."""
    x = np.ascontiguousarray(x)
    sharding = NamedSharding(mesh, P())
    if jax.process_count() > 1:
        return jax.make_array_from_process_local_data(sharding, x)
    return jax.device_put(x, sharding)


def make_2d_mesh(n_replica: int, n_shard: int) -> Mesh:
    """('replica', 'shard') mesh for multi-slice serving: index rows sharded
    within a host, whole-index replicas across hosts — query
    traffic splits across replicas, each query fans out over its slice."""
    devs = np.array(jax.devices()[: n_replica * n_shard]).reshape(
        n_replica, n_shard
    )
    return Mesh(devs, ("replica", "shard"))


def data_sharding(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    """Shard the leading (batch) axis."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_rows(x, mesh: Mesh, axis_name: str = "shard"):
    """Place (N, ...) array row-sharded over the mesh, padding N to a multiple
    of the axis size. Returns (sharded array, original N)."""
    import jax.numpy as jnp

    n = x.shape[0]
    size = mesh.shape[axis_name]
    pad = (-n) % size
    if pad:
        x = jnp.concatenate([jnp.asarray(x), jnp.zeros((pad, *x.shape[1:]), x.dtype)])
    return jax.device_put(x, NamedSharding(mesh, P(axis_name))), n


def stage_row_sharded(piece_fn, n_shards: int, mesh: Mesh,
                      axis_name: str = "shard"):
    """Assemble a row-sharded global array from PER-SHARD host pieces without
    ever materializing the dense (S·rows, ...) host buffer: piece_fn(si)
    returns shard si's (rows, ...) numpy block (all equal shapes), which is
    placed directly on device si and stitched with
    make_array_from_single_device_arrays. Host peak = one piece at a time —
    at 100M-scale staging this halves host memory vs the dense concat.

    On a 2-D ('replica', 'shard') mesh each piece is placed on EVERY device
    of its shard column (index replicas across slices; one host→device copy
    per replica — on real multi-slice hardware each host stages its own).

    Multi-process (init_multihost): each process materializes and places
    ONLY the pieces whose devices it addresses — piece_fn never runs for a
    remote shard, so per-host staging memory and host→device traffic stay
    1/P of the index. The global array is assembled collectively (every
    process must call this with the same shapes). Requires every process
    to own at least one shard device (true for any even mesh split).
    """
    import numpy as np

    sharding = NamedSharding(mesh, P(axis_name))
    if "replica" in mesh.axis_names:
        dev_grid = mesh.devices  # (n_replica, n_shard)
        # P('shard') splits dim0 over EVERY shard column — a partial cover
        # fails deep inside make_array_from_single_device_arrays
        assert dev_grid.shape[1] == n_shards, (dev_grid.shape, n_shards)
        cols = [list(dev_grid[:, si]) for si in range(n_shards)]
    else:
        cols = [[d] for d in list(mesh.devices.flat)[:n_shards]]
    me = jax.process_index()
    arrs = []
    shape0 = None
    for si, col in enumerate(cols):
        local = [d for d in col if d.process_index == me]
        if not local:
            continue  # a remote host stages this shard
        piece = np.ascontiguousarray(piece_fn(si))
        if shape0 is None:
            shape0 = piece.shape
        assert piece.shape == shape0, (piece.shape, shape0)
        for d in local:
            arrs.append(jax.device_put(piece, d))
    assert shape0 is not None, "process owns no shard device"
    global_shape = (n_shards * shape0[0], *shape0[1:])
    return jax.make_array_from_single_device_arrays(global_shape, sharding, arrs)
