"""Data-parallel contrastive training loop (SURVEY.md §2.1 Trainer, §3.2).

One jitted train step under a 1-D 'data' mesh: the (anchor, positive,
negative) token batches are sharded on the batch axis, params replicated;
XLA inserts the gradient all-reduce (NCCL on a multi-GPU host). The three
encoder forwards run as ONE forward on the stacked 3B batch (bigger
matmuls, one weight read).

Checkpoints carry params + opt state + step + RNG + data cursor so training
resumes exactly (SURVEY.md §5.4).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Iterator

import jax
import jax.numpy as jnp
import optax

from cloudvectordb_tpu.models.encoder import Encoder, init_encoder
from cloudvectordb_tpu.parallel.mesh import data_sharding, make_mesh, replicated
from cloudvectordb_tpu.train.losses import infonce_loss, triplet_margin_loss
from cloudvectordb_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint
from cloudvectordb_tpu.utils.config import TrainConfig
from cloudvectordb_tpu.utils.metrics import MetricsWriter, get_logger

log = get_logger("cvdb.train")


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["params", "opt_state", "step", "rng"],
                   meta_fields=[])
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Registered pytree; its treedef string matches the flax PyTreeNode
    it replaced, so existing checkpoints restore."""

    params: dict
    opt_state: optax.OptState
    step: jnp.ndarray
    rng: jnp.ndarray


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.lr,
        warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.total_steps, cfg.warmup_steps + 1),
    )
    tx = optax.adamw(sched, weight_decay=cfg.weight_decay)
    if cfg.grad_accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=cfg.grad_accum)
    return tx


class Trainer:
    def __init__(self, cfg: TrainConfig, mesh=None, metrics: MetricsWriter | None = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(
            cfg.mesh_data_axis or None, axis_name="data")
        self.model = Encoder(cfg.encoder)
        self.tx = make_optimizer(cfg)
        self.metrics = metrics or MetricsWriter(None)
        self._step_fn = None

    def init_state(self, seed: int | None = None) -> TrainState:
        seed = self.cfg.seed if seed is None else seed
        _, params = init_encoder(self.cfg.encoder, seed=seed)
        state = TrainState(
            params=params,
            opt_state=self.tx.init(params),
            step=jnp.zeros((), jnp.int32),
            # dropout-mask RNG under TrainConfig.rng_impl. Stored as RAW
            # key data (uint32) so checkpoints stay plain arrays; the step
            # re-wraps it under the configured impl.
            rng=jax.random.key_data(
                jax.random.key(seed, impl=self.cfg.rng_impl)),
        )
        return jax.device_put(state, replicated(self.mesh))

    # -- the jitted step ---------------------------------------------------
    def _build_step(self):
        cfg = self.cfg
        model = self.model
        tx = self.tx

        def loss_of(params, batch, rng):
            ids = jnp.concatenate(
                [batch["anchor_ids"], batch["pos_ids"], batch["neg_ids"]], axis=0
            )
            mask = jnp.concatenate(
                [batch["anchor_mask"], batch["pos_mask"], batch["neg_mask"]], axis=0
            )
            emb = model.apply(
                {"params": params}, ids, mask, deterministic=False,
                rngs={"dropout": rng},
            )
            b = batch["anchor_ids"].shape[0]
            a, p, n = emb[:b], emb[b : 2 * b], emb[2 * b :]
            if cfg.loss == "infonce":
                loss, acc = infonce_loss(a, p, n, temperature=cfg.temperature)
                if cfg.uniformity_weight > 0.0:
                    from cloudvectordb_tpu.train.losses import uniformity_loss

                    loss = loss + cfg.uniformity_weight * uniformity_loss(a)
            else:
                loss = triplet_margin_loss(a, p, n, margin=cfg.margin)
                acc = jnp.mean(
                    jnp.sum((a - p) ** 2, -1) < jnp.sum((a - n) ** 2, -1)
                )
            return loss, acc

        rng_impl = cfg.rng_impl

        def step_fn(state: TrainState, batch):
            key = jax.random.wrap_key_data(state.rng, impl=rng_impl)
            rng, new_key = jax.random.split(key)
            new_rng = jax.random.key_data(new_key)
            (loss, acc), grads = jax.value_and_grad(loss_of, has_aux=True)(
                state.params, batch, rng
            )
            updates, new_opt = tx.update(grads, state.opt_state, state.params)
            new_params = optax.apply_updates(state.params, updates)
            gnorm = optax.global_norm(grads)
            new_state = TrainState(
                params=new_params, opt_state=new_opt,
                step=state.step + 1, rng=new_rng,
            )
            return new_state, {"loss": loss, "acc": acc, "grad_norm": gnorm}

        shard = data_sharding(self.mesh)
        repl = replicated(self.mesh)
        return jax.jit(
            step_fn,
            in_shardings=(repl, shard),
            out_shardings=(repl, repl),
            donate_argnums=(0,),
        )

    @property
    def step_fn(self):
        if self._step_fn is None:
            self._step_fn = self._build_step()
        return self._step_fn

    def place_batch(self, batch: dict):
        """Host numpy batch → device, batch axis sharded over 'data'."""
        shard = data_sharding(self.mesh)
        return {k: jax.device_put(jnp.asarray(v), shard) for k, v in batch.items()}

    # -- the loop ------------------------------------------------------------
    def fit(
        self,
        batches: Iterator[dict],
        state: TrainState | None = None,
        resume: bool = True,
    ) -> TrainState:
        cfg = self.cfg
        state = state or self.init_state()
        skipper = batches if hasattr(batches, "skip") else None
        batches = iter(batches)
        start_step = 0
        if resume:
            restored, step, meta = restore_checkpoint(cfg.ckpt_dir, state)
            if restored is not None:
                state = jax.device_put(restored, replicated(self.mesh))
                start_step = step
                # exact resume: the data stream restarts from its beginning on
                # every fit() call (deterministic batch order), so skip the
                # batches the checkpointed run already consumed — otherwise
                # seen data replays against a later optimizer step. Sources
                # with a skip() protocol (data/triplets.py::triplet_batches)
                # fast-forward without tokenizing the skipped batches.
                cursor = int(meta.get("data_cursor", step))
                if skipper is not None:
                    skipper.skip(cursor)
                else:
                    for _ in range(cursor):
                        if next(batches, None) is None:
                            break
                log.info("resumed from step %d (data cursor %d)", step, cursor)
        t0 = time.perf_counter()
        seen = 0
        for i, batch in enumerate(batches):
            step_idx = start_step + i
            if step_idx >= cfg.total_steps:
                break
            state, m = self.step_fn(state, self.place_batch(batch))
            seen += batch["anchor_ids"].shape[0]
            if (step_idx + 1) % cfg.log_every == 0:
                m = jax.device_get(m)
                dt = time.perf_counter() - t0
                self.metrics.log(
                    "train_step", step=step_idx + 1, loss=float(m["loss"]),
                    acc=float(m["acc"]), grad_norm=float(m["grad_norm"]),
                    examples_per_s=seen / dt,
                )
                log.info(
                    "step %d loss %.4f acc %.3f (%.0f ex/s)",
                    step_idx + 1, m["loss"], m["acc"], seen / dt,
                )
            if (step_idx + 1) % cfg.ckpt_every == 0 or step_idx + 1 == cfg.total_steps:
                save_checkpoint(
                    cfg.ckpt_dir, step_idx + 1, jax.device_get(state),
                    meta={"data_cursor": step_idx + 1},
                    keep_last=cfg.keep_last,
                )
        return state
