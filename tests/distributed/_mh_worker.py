"""Multi-host worker: one PROCESS of the simulated-DCN serving test.

Launched by test_multihost.py (N processes over TCP, gloo collectives,
M simulated CPU devices each — the executable stand-in for N hosts of an
N×M-device cluster). Builds the sharded serving index, searches, and dumps the
result ids for the parent test to compare against the single-process mesh.

Not a pytest module (underscore prefix keeps it out of collection).
"""

import os
import sys


def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    port, outdir = sys.argv[3], sys.argv[4]
    local_devices = 8 // nproc
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}")

    import jax

    jax.config.update("jax_platforms", "cpu")

    from cloudvectordb_tpu.parallel.mesh import (
        init_multihost, make_2d_mesh, make_mesh)

    n = init_multihost(f"127.0.0.1:{port}", nproc, pid,
                       cpu_collectives="gloo")
    assert n == 8, n
    assert jax.process_count() == nproc

    import numpy as np

    from cloudvectordb_tpu.data.synthetic import (
        clustered_vectors, queries_from)
    from cloudvectordb_tpu.parallel.dist_band import ShardedBandIndex

    db = clustered_vectors(1024, 32, n_clusters=16, seed=50, normalize=True)
    q = queries_from(db, 32, seed=51, normalize=True)
    kw = dict(dtype="int8", residual=True, kmeans_iters=4, tile_n=128,
              tile_q=8, seed=5)

    # (a) 1-D 'shard' mesh spanning both processes: every host passes the
    # same broadcast batch; the partial-top-k merge all_gather crosses the
    # process boundary (the DCN hop).
    idx = ShardedBandIndex.build(db, nlist=8,
                                 mesh=make_mesh(axis_name="shard"), **kw)
    st = idx._device_state()
    _, ids = idx.search(q, 5, p_tiles=int(st["n_tiles"]))
    np.save(os.path.join(outdir, f"oned_{pid}.npy"), ids)

    # (b) ('replica', 'shard') mesh, one replica per process: each host
    # stages a full index copy and serves ITS OWN traffic slice — queries
    # never cross hosts, only the staging collective does.
    idx2 = ShardedBandIndex.build(
        db, nlist=8, mesh=make_2d_mesh(nproc, 8 // nproc), **kw)
    st2 = idx2._device_state()
    per_host = q.shape[0] // nproc
    qslice = q[pid * per_host:(pid + 1) * per_host]
    _, ids2 = idx2.search(qslice, 5, p_tiles=int(st2["n_tiles"]))
    np.save(os.path.join(outdir, f"twod_{pid}.npy"), ids2)

    # (c) the probe-scan wrapper family over the same 1-D cross-host mesh
    from cloudvectordb_tpu.parallel.dist_ivf import ShardedIVFPQIndex

    pq = ShardedIVFPQIndex.build(
        db, nlist=8, m=8, mesh=make_mesh(axis_name="shard"), nbits=4,
        kmeans_iters=4, pq_train_iters=4, refine="int8", seed=5)
    _, ids3 = pq.search(q, 5, nprobe=8)
    np.save(os.path.join(outdir, f"pq_{pid}.npy"), ids3)

    # (e) config-#5 host-tier CASCADE across processes:
    # dispatch-1 stacked shortlists stay per-device, each process gathers
    # ONLY its own shards' rows from its own host stores, and dispatch-2's
    # merge all_gather crosses the process boundary.
    from cloudvectordb_tpu.parallel.dist_band_pq import ShardedBandIVFPQIndex

    c5 = ShardedBandIVFPQIndex.build(
        db, nlist=8, m=8, nbits=4, refine="pq2+host", m2=8,
        mesh=make_mesh(axis_name="shard"), kmeans_iters=4, pq_train_iters=4,
        tile_n=128, tile_q=8, seed=5)
    st5 = c5._device_state()
    _, ids5 = c5.search(q, 5, p_tiles=int(st5["n_tiles"]), refine_factor=16,
                        host_factor=8)
    np.save(os.path.join(outdir, f"c5_{pid}.npy"), ids5)

    # (d) DP training step across hosts: each process feeds ITS OWN batch
    # shard; the gradient all-reduce crosses the process boundary. The
    # loss must match the single-process step on the concatenated batch.
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cloudvectordb_tpu.train.losses import infonce_loss

    mesh = make_mesh(axis_name="data")
    rngb = np.random.default_rng(7)
    wdim = 16
    params = jnp.asarray(rngb.normal(size=(wdim, wdim)).astype(np.float32))
    params = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), np.asarray(params))
    a_all = rngb.normal(size=(32, wdim)).astype(np.float32)
    p_all = (a_all + 0.1 * rngb.normal(size=(32, wdim))).astype(np.float32)
    half = 32 // nproc

    def loss_fn(w, a, p):
        return infonce_loss(a @ w, p @ w, temperature=0.1)[0]

    @jax.jit
    def step(w, a, p):
        l, g = jax.value_and_grad(loss_fn)(w, a, p)
        return l, w - 0.1 * g

    sh = NamedSharding(mesh, P("data"))
    a_g = jax.make_array_from_process_local_data(
        sh, a_all[pid * half:(pid + 1) * half])
    p_g = jax.make_array_from_process_local_data(
        sh, p_all[pid * half:(pid + 1) * half])
    loss, new_w = step(params, a_g, p_g)
    out = np.array([float(jax.device_get(loss.addressable_data(0))),
                    float(np.abs(jax.device_get(
                        new_w.addressable_data(0))).mean())])
    np.save(os.path.join(outdir, f"train_{pid}.npy"), out)
    print(f"WORKER {pid} OK", flush=True)


if __name__ == "__main__":
    main()
