"""Encoder attention on the GPU: the materialized-logits XLA path ('naive')
vs cuDNN's fused attention ('cudnn'), minilm-l6-384 geometry.

    python scripts/attn_timing.py

Times (ms, mean of fenced calls after one warm call): a train step at
L=128 (the trainer's stacked 3×batch forward + backward + AdamW), with and
without attention-probs dropout; a passage encode forward at L=128; a
query encode forward at L=32; and, at L=32, the attention op alone in
three layouts — naive, cuDNN, and the removed 'packed_batch' layout
(128/L sequences per block-diagonal attention block), the comparison its
removal rests on. Prints one line per case and, first, the card's name
and power limit. Needs a GPU.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cloudvectordb_tpu.eval.qps import step_seconds
    from cloudvectordb_tpu.models.encoder import init_encoder
    from cloudvectordb_tpu.models.presets import get_preset
    from cloudvectordb_tpu.train.trainer import Trainer
    from cloudvectordb_tpu.utils.config import TrainConfig
    from cloudvectordb_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    assert jax.devices()[0].platform == "gpu", "needs a GPU"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    base = get_preset("minilm-l6-384")
    rng = np.random.default_rng(0)

    def batch_of(b, length):
        ids = rng.integers(4, base.vocab_size, (b, length)).astype(np.int32)
        mask = np.ones((b, length), np.int32)
        mask[:, int(length * 0.75):] = 0  # a padded tail, as real batches
        return jnp.asarray(ids), jnp.asarray(mask)

    def train_ms(impl, attn_drop, b=256, length=128):
        enc = dataclasses.replace(base, max_len=length, attn_impl=impl,
                                  attn_dropout=attn_drop)
        tr = Trainer(TrainConfig(encoder=enc, batch_size=b, total_steps=100,
                                 warmup_steps=1))
        state = tr.init_state()
        ids, mask = batch_of(b, length)
        batch = tr.place_batch({f"{n}_{f}": x for n in ("anchor", "pos", "neg")
                                for f, x in (("ids", ids), ("mask", mask))})
        box = [state]

        def step():
            box[0], m = tr.step_fn(box[0], batch)
            return m["loss"]

        return 1e3 * step_seconds(step, reps=10)

    def fwd_ms(impl, b, length):
        enc = dataclasses.replace(base, max_len=length, attn_impl=impl)
        model, params = init_encoder(enc)
        params = jax.device_put(params)
        fn = jax.jit(lambda p, i, m: model.apply({"params": p}, i, m, True))
        ids, mask = batch_of(b, length)
        return 1e3 * step_seconds(fn, params, ids, mask, reps=20)

    for impl, drop in (("naive", 0.1), ("naive", 0.0), ("cudnn", 0.0)):
        print(f"train step L=128 B=256x3 attn={impl} attn_dropout={drop}: "
              f"{train_ms(impl, drop):.2f} ms", flush=True)
    for b, length in ((1024, 128), (4096, 32)):
        for impl in ("naive", "cudnn"):
            print(f"encode fwd L={length} B={b} attn={impl}: "
                  f"{fwd_ms(impl, b, length):.2f} ms", flush=True)

    # the attention op alone at the query shape, three layouts
    b, length, heads = 4096, 32, base.num_heads
    hd = base.hidden_dim // heads
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q, k, v = (jax.random.normal(kk, (b, length, heads, hd), jnp.bfloat16)
               for kk in ks)
    mask = jnp.asarray(batch_of(b, length)[1]).astype(bool)
    scale = hd ** -0.5

    def naive(q, k, v, mask):
        s = jnp.einsum("bqhd,bkhd->bhqk", q * scale, k).astype(jnp.float32)
        s = jnp.where(mask[:, None, None, :], s, jnp.finfo(jnp.float32).min)
        p_ = jax.nn.softmax(s, axis=-1).astype(q.dtype)
        return jnp.einsum("bhqk,bkhd->bqhd", p_, v)

    def cudnn(q, k, v, mask):
        return jax.nn.dot_product_attention(
            q, k, v, scale=scale, implementation="cudnn",
            key_value_seq_lengths=jnp.sum(mask, axis=1).astype(jnp.int32))

    def packed(q, k, v, mask):
        g = 128 // length  # sequences per 128-row block
        qp, kp, vp = (x.reshape(b // g, g * length, heads, hd)
                      for x in (q, k, v))
        s = jnp.einsum("bqhd,bkhd->bhqk", qp * scale, kp).astype(jnp.float32)
        blk = jnp.kron(jnp.eye(g, dtype=jnp.int32),
                       jnp.ones((length, length), jnp.int32)).astype(bool)
        allowed = blk[None, None] & mask.reshape(b // g, g * length)[
            :, None, None, :]
        s = jnp.where(allowed, s, jnp.finfo(jnp.float32).min)
        p_ = jax.nn.softmax(s, axis=-1).astype(q.dtype)
        out = jnp.einsum("bhqk,bkhd->bqhd", p_, vp)
        return out.reshape(b, length, heads, hd)

    ref = jax.jit(naive)(q, k, v, mask)
    for name, fn in (("naive", naive), ("cudnn", cudnn),
                     ("packed_batch", packed)):
        f = jax.jit(fn)
        err = float(jnp.max(jnp.abs(f(q, k, v, mask).astype(jnp.float32)
                                    - ref.astype(jnp.float32))))
        print(f"attention op L={length} B={b} {name}: "
              f"{1e3 * step_seconds(f, q, k, v, mask, reps=50):.3f} ms "
              f"(max |diff| vs naive {err:.3g})", flush=True)


if __name__ == "__main__":
    main()
