"""Transformer sentence encoder (MiniLM-L6-class; BASELINE.json:8-9).

BERT-style post-LN encoder in plain JAX:
  - activations in bfloat16 by default, parameters in float32 (master
    weights); LayerNorm statistics and softmax run in float32;
  - static max_len, attention as one fused dot_general pair (or cuDNN's
    fused attention on the GPU, ``attn_impl``);
  - mean/CLS pooling + optional L2 normalization — the output feeds the
    index directly.

The module keeps the ``Encoder(cfg).init(rng, ids, mask)`` /
``.apply({"params": p}, ids, mask, deterministic, rngs={"dropout": key})``
interface and the parameter tree of the original flax module
(``tok_emb/embedding``, ``layer_{i}/attention/query/kernel`` …), so
checkpoints and the HuggingFace import (models/hf_import.py) carry over.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cloudvectordb_tpu.utils.config import EncoderConfig

_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

#: shortest sequence at which attn_impl='auto' takes cuDNN on the GPU when
#: no attention-probs dropout is pending: on an H100 (700 W) cuDNN won at L=128
#: (train step 36.1 vs 43.1 ms, encode 14.8 vs 18.1 ms) and lost at the
#: L=32 query encode (18.8 vs 14.7 ms) — PERF.md, scripts/attn_timing.py
_CUDNN_MIN_LEN = 128


def _dense(p, x, dtype, contract=1):
    """x @ kernel + bias over the last ``contract`` axes of x (flax
    Dense/DenseGeneral semantics: operands cast to the compute dtype)."""
    k = p["kernel"].astype(dtype)
    y = jnp.tensordot(x.astype(dtype), k, axes=contract)
    return y + p["bias"].astype(dtype)


def _layer_norm(p, x, dtype, eps: float = 1e-6):
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mu), axis=-1, keepdims=True)
    y = (xf - mu) * jax.lax.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).astype(dtype)


def _dropout(x, rate: float, key):
    if key is None or rate == 0.0:
        return x
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), 0).astype(x.dtype)


class _Keys:
    """Distinct dropout keys per call site (None when deterministic)."""

    def __init__(self, key):
        self._key, self._n = key, 0

    def __call__(self):
        if self._key is None:
            return None
        self._n += 1
        return jax.random.fold_in(self._key, self._n)


def attn_dispatch(cfg: EncoderConfig, attn_p: float, deterministic: bool,
                  seq_len: int, platform: str | None = None) -> str:
    """'naive' (materialized logits, the dropout-carrying path) or 'cudnn'
    (jax.nn.dot_product_attention through cuDNN — GPU only, bf16, no
    attention-probs dropout)."""
    impl = cfg.attn_impl
    no_drop = deterministic or attn_p == 0.0
    if impl == "cudnn":
        assert no_drop, (
            "attn_impl='cudnn' has no attention-probs dropout: set "
            "attn_dropout=0.0 or run deterministic")
        return impl
    if impl == "naive":
        return impl
    assert impl == "auto", f"unknown attn_impl {impl!r}"
    platform = platform or jax.default_backend()
    if (platform == "gpu" and no_drop and cfg.dtype == "bfloat16"
            and seq_len >= _CUDNN_MIN_LEN):
        return "cudnn"
    return "naive"


def _attention(p, x, mask, cfg, dtype, deterministic, keys):
    nh = cfg.num_heads
    hd = cfg.hidden_dim // nh
    q = _dense(p["query"], x, dtype)  # (B, L, H, hd)
    k = _dense(p["key"], x, dtype)
    v = _dense(p["value"], x, dtype)
    scale = hd ** -0.5
    attn_p = cfg.dropout if cfg.attn_dropout is None else cfg.attn_dropout
    if attn_dispatch(cfg, attn_p, deterministic, x.shape[1]) == "cudnn":
        out = jax.nn.dot_product_attention(
            q, k, v, scale=scale, implementation="cudnn",
            key_value_seq_lengths=jnp.sum(mask, axis=1).astype(jnp.int32))
    else:
        logits = jnp.einsum("bqhd,bkhd->bhqk", q * scale, k)
        neg = jnp.finfo(jnp.float32).min
        logits = jnp.where(mask[:, None, None, :],
                           logits.astype(jnp.float32), neg)
        probs = jax.nn.softmax(logits, axis=-1).astype(dtype)
        probs = _dropout(probs, attn_p, keys())
        out = jnp.einsum("bhqk,bkhd->bqhd", probs, v)
    return _dense(p["out"], out, dtype, contract=2)


def _layer(p, x, mask, cfg, dtype, deterministic, keys):
    attn = _attention(p["attention"], x, mask, cfg, dtype, deterministic, keys)
    attn = _dropout(attn, cfg.dropout, keys())
    x = _layer_norm(p["attention_ln"], x + attn, dtype)
    h = _dense(p["mlp_in"], x, dtype)
    h = jax.nn.gelu(h, approximate=True)
    h = _dense(p["mlp_out"], h, dtype)
    h = _dropout(h, cfg.dropout, keys())
    return _layer_norm(p["mlp_ln"], x + h, dtype)


class Encoder:
    """token ids (B, L) + mask (B, L) → sentence embeddings (B, out_dim)."""

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg

    @property
    def embed_dim(self) -> int:
        return self.cfg.out_dim or self.cfg.hidden_dim

    def init(self, rng, input_ids=None, attention_mask=None,
             deterministic: bool = True) -> dict:
        """Fresh parameters (flax's default initializers: LeCun-normal
        kernels, zero biases, N(0, 1/hidden) embeddings, unit LayerNorm)."""
        del input_ids, attention_mask, deterministic
        c = self.cfg
        hd = c.hidden_dim // c.num_heads
        lecun = jax.nn.initializers.lecun_normal()
        emb = jax.nn.initializers.variance_scaling(1.0, "fan_in", "normal",
                                                   out_axis=0)
        keys = iter(jax.random.split(rng, 4 + 6 * c.num_layers))

        def dense(shape_in, shape_out):
            fan_in = 1
            for s in shape_in:
                fan_in *= s
            fan_out = 1
            for s in shape_out:
                fan_out *= s
            w = lecun(next(keys), (fan_in, fan_out), jnp.float32)
            return {"kernel": w.reshape(shape_in + shape_out),
                    "bias": jnp.zeros(shape_out, jnp.float32)}

        def ln():
            return {"scale": jnp.ones((c.hidden_dim,), jnp.float32),
                    "bias": jnp.zeros((c.hidden_dim,), jnp.float32)}

        h = c.hidden_dim
        params = {
            "tok_emb": {"embedding": emb(next(keys), (c.vocab_size, h))},
            "pos_emb": {"embedding": emb(next(keys), (c.max_len, h))},
            "emb_ln": ln(),
        }
        for i in range(c.num_layers):
            params[f"layer_{i}"] = {
                "attention": {
                    "query": dense((h,), (c.num_heads, hd)),
                    "key": dense((h,), (c.num_heads, hd)),
                    "value": dense((h,), (c.num_heads, hd)),
                    "out": dense((c.num_heads, hd), (h,)),
                },
                "attention_ln": ln(),
                "mlp_in": dense((h,), (c.mlp_dim,)),
                "mlp_out": dense((c.mlp_dim,), (h,)),
                "mlp_ln": ln(),
            }
        if c.out_dim and c.out_dim != h:
            params["proj"] = dense((h,), (c.out_dim,))
        return {"params": params}

    def apply(self, variables, input_ids, attention_mask,
              deterministic: bool = True, rngs: dict | None = None):
        c = self.cfg
        p = variables["params"]
        dtype = _DTYPES[c.dtype]
        key = None if deterministic else (rngs or {}).get("dropout")
        assert deterministic or key is not None, (
            "a non-deterministic forward needs rngs={'dropout': key}")
        keys = _Keys(key)
        tok = p["tok_emb"]["embedding"][input_ids].astype(dtype)
        pos = p["pos_emb"]["embedding"][: input_ids.shape[1]].astype(dtype)
        x = _layer_norm(p["emb_ln"], tok + pos[None], dtype)
        x = _dropout(x, c.dropout, keys())
        mask = attention_mask.astype(bool)
        for i in range(c.num_layers):
            lk = _Keys(keys())

            def run(lp, x, mask, lk=lk):
                return _layer(lp, x, mask, c, dtype, deterministic, lk)

            if c.remat:
                # recompute layer activations in the backward pass — frees
                # device memory for bigger contrastive batches
                run = jax.checkpoint(run)
            x = run(p[f"layer_{i}"], x, mask)
        if c.pooling == "cls":
            pooled = x[:, 0, :]
        else:  # masked mean pooling
            w = attention_mask.astype(jnp.float32)[:, :, None]
            pooled = jnp.sum(x.astype(jnp.float32) * w, axis=1) / jnp.maximum(
                jnp.sum(w, axis=1), 1.0
            )
        if c.out_dim and c.out_dim != c.hidden_dim:
            pooled = _dense(p["proj"], pooled, jnp.float32)
        pooled = pooled.astype(jnp.float32)
        if c.normalize:
            pooled = pooled / jnp.maximum(
                jnp.linalg.norm(pooled, axis=-1, keepdims=True), 1e-12
            )
        return pooled


def init_encoder(cfg: EncoderConfig, seed: int = 0):
    """Returns (model, params)."""
    model = Encoder(cfg)
    return model, model.init(jax.random.PRNGKey(seed))["params"]
