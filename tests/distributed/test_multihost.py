"""Multi-host DCN path, EXECUTED: 2 OS processes × 4 simulated devices over
TCP (jax.distributed + gloo CPU collectives) — the runnable stand-in for a
2-host cluster (SURVEY §2.3 multi-host row).

What actually crosses the process boundary:
- staging: make_array_from_single_device_arrays assembles the row-sharded
  arenas from per-process pieces (each process materializes ONLY its own
  shards — mesh.stage_row_sharded); queries ride
  make_array_from_process_local_data;
- serving (1-D mesh): the partial-top-k merge all_gather — the exact
  collective that rides DCN on real multi-host hardware.

Parity is asserted EXACTLY against the same build + search on the
single-process 8-device mesh: identical inputs, identical SPMD program,
collectives only move data, so ids must match bit-for-bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from cloudvectordb_tpu.data.synthetic import clustered_vectors, queries_from
from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex
from cloudvectordb_tpu.parallel.mesh import make_2d_mesh, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = os.path.join(REPO, "tests", "distributed", "_mh_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def expected():
    """Single-process reference on the same 8-device topology."""
    import jax
    import jax.numpy as jnp

    from cloudvectordb_tpu.parallel.dist_ivf import ShardedIVFPQIndex
    from cloudvectordb_tpu.train.losses import infonce_loss

    db = clustered_vectors(1024, 32, n_clusters=16, seed=50, normalize=True)
    q = queries_from(db, 32, seed=51, normalize=True)
    kw = dict(dtype="int8", residual=True, kmeans_iters=4, tile_n=128,
              tile_q=8, seed=5)
    one = ShardedBandIndex.build(db, nlist=8,
                                 mesh=make_mesh(axis_name="shard"), **kw)
    st = one._device_state()
    _, ids_1d = one.search(q, 5, p_tiles=int(st["n_tiles"]))
    two = ShardedBandIndex.build(db, nlist=8, mesh=make_2d_mesh(2, 4), **kw)
    st2 = two._device_state()
    _, ids_2d = two.search(q, 5, p_tiles=int(st2["n_tiles"]))
    pq = ShardedIVFPQIndex.build(
        db, nlist=8, m=8, mesh=make_mesh(axis_name="shard"), nbits=4,
        kmeans_iters=4, pq_train_iters=4, refine="int8", seed=5)
    _, ids_pq = pq.search(q, 5, nprobe=8)

    from cloudvectordb_tpu.parallel.dist_band_pq import ShardedBandIVFPQIndex

    c5 = ShardedBandIVFPQIndex.build(
        db, nlist=8, m=8, nbits=4, refine="pq2+host", m2=8,
        mesh=make_mesh(axis_name="shard"), kmeans_iters=4, pq_train_iters=4,
        tile_n=128, tile_q=8, seed=5)
    st5 = c5._device_state()
    _, ids_c5 = c5.search(q, 5, p_tiles=int(st5["n_tiles"]),
                          refine_factor=16, host_factor=8)

    # single-process DP train step on the full batch (same arithmetic the
    # workers split across hosts; the grad all-reduce must not change it)
    rngb = np.random.default_rng(7)
    wdim = 16
    w0 = jnp.asarray(rngb.normal(size=(wdim, wdim)).astype(np.float32))
    a_all = rngb.normal(size=(32, wdim)).astype(np.float32)
    p_all = (a_all + 0.1 * rngb.normal(size=(32, wdim))).astype(np.float32)

    def loss_fn(w, a, p):
        return infonce_loss(a @ w, p @ w, temperature=0.1)[0]

    loss, grad = jax.value_and_grad(loss_fn)(w0, jnp.asarray(a_all),
                                             jnp.asarray(p_all))
    train_ref = np.array([float(loss),
                          float(np.abs(np.asarray(w0 - 0.1 * grad)).mean())])
    return ids_1d, ids_2d, ids_pq, ids_c5, train_ref


def _run_workers(nproc, port, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", WORKER, str(p), str(nproc), str(port),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(nproc)
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-host workers timed out\n" + "\n".join(logs))
    return [p.returncode for p in procs], logs


def test_two_process_serving_parity(tmp_path, expected):
    nproc = 2
    # _free_port is a TOCTOU probe — another process can grab the port
    # before the jax coordinator binds it; retry on a fresh one
    for attempt in range(3):
        rcs, logs = _run_workers(nproc, _free_port(), tmp_path)
        if all(rc == 0 for rc in rcs):
            break
        if not any("already in use" in lg.lower() for lg in logs):
            break
    for pi, (rc, lg) in enumerate(zip(rcs, logs)):
        assert rc == 0, f"worker {pi} failed (rc={rc}):\n{lg[-4000:]}"
        assert f"WORKER {pi} OK" in lg

    ids_1d, ids_2d, ids_pq, ids_c5, train_ref = expected
    # (a) 1-D: both processes hold the SAME replicated result, equal to the
    # single-process mesh — the cross-process all_gather merged correctly
    for pi in range(nproc):
        got = np.load(tmp_path / f"oned_{pi}.npy")
        np.testing.assert_array_equal(got, ids_1d)
    # (b) 2-D one-replica-per-host: each process serves exactly its own
    # traffic slice of the single-process result
    per_host = ids_2d.shape[0] // nproc
    for pi in range(nproc):
        got = np.load(tmp_path / f"twod_{pi}.npy")
        np.testing.assert_array_equal(
            got, ids_2d[pi * per_host:(pi + 1) * per_host])
    # (c) probe-scan wrapper family, same cross-host topology
    for pi in range(nproc):
        got = np.load(tmp_path / f"pq_{pi}.npy")
        np.testing.assert_array_equal(got, ids_pq)
    # (e) config-#5 pq2+host cascade: per-process shard-slice host gather +
    # cross-process dispatch-2 merge reproduce the single-process result
    for pi in range(nproc):
        got = np.load(tmp_path / f"c5_{pi}.npy")
        np.testing.assert_array_equal(got, ids_c5)
    # (d) DP train step: per-host batch shards + cross-host grad all-reduce
    # reproduce the single-process loss/update (f32 reduction-order jitter)
    for pi in range(nproc):
        got = np.load(tmp_path / f"train_{pi}.npy")
        np.testing.assert_allclose(got, train_ref, rtol=2e-5, atol=2e-6)
