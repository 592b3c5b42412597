"""The plain-JAX encoder against an independent numpy BERT reference:
forward values, and gradients against central differences of the numpy
forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cloudvectordb_tpu.models.encoder import Encoder, attn_dispatch
from cloudvectordb_tpu.utils.config import EncoderConfig

CFG = EncoderConfig(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=4,
                    mlp_dim=48, max_len=12, dropout=0.0, dtype="float32")


def _np_forward(p, ids, mask, c=CFG):
    """BERT post-LN encoder, mean pooling, L2 normalisation (float64)."""
    def ln(q, x):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + 1e-6) * q["scale"] + q["bias"]

    def gelu(x):  # tanh approximation
        return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (x + 0.044715 * x ** 3)))

    x = p["tok_emb"]["embedding"][ids] + p["pos_emb"]["embedding"][None,
                                                                  : ids.shape[1]]
    x = ln(p["emb_ln"], x)
    hd = c.hidden_dim // c.num_heads
    for i in range(c.num_layers):
        lp = p[f"layer_{i}"]
        a = lp["attention"]
        q, k, v = (np.einsum("blh,hnd->blnd", x, a[n]["kernel"]) + a[n]["bias"]
                   for n in ("query", "key", "value"))
        logits = np.einsum("bqnd,bknd->bnqk", q / np.sqrt(hd), k)
        logits = np.where(mask[:, None, None, :] > 0, logits, -1e30)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        o = np.einsum("bnqk,bknd->bqnd", probs, v)
        o = np.einsum("bqnd,ndh->bqh", o, a["out"]["kernel"]) + a["out"]["bias"]
        x = ln(lp["attention_ln"], x + o)
        h = gelu(x @ lp["mlp_in"]["kernel"] + lp["mlp_in"]["bias"])
        h = h @ lp["mlp_out"]["kernel"] + lp["mlp_out"]["bias"]
        x = ln(lp["mlp_ln"], x + h)
    w = mask[:, :, None].astype(np.float64)
    pooled = (x * w).sum(1) / np.maximum(w.sum(1), 1.0)
    return pooled / np.linalg.norm(pooled, axis=-1, keepdims=True)


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, CFG.vocab_size, (3, CFG.max_len)).astype(np.int32)
    mask = np.ones((3, CFG.max_len), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    return ids, mask


def test_forward_matches_numpy_reference():
    model = Encoder(CFG)
    params = model.init(jax.random.PRNGKey(0))["params"]
    ids, mask = _inputs()
    with jax.default_matmul_precision("highest"):
        out = model.apply({"params": params}, jnp.asarray(ids),
                          jnp.asarray(mask))
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    np.testing.assert_allclose(np.asarray(out), _np_forward(p64, ids, mask),
                               atol=2e-5)


def test_gradient_matches_numpy_central_differences():
    model = Encoder(CFG)
    params = model.init(jax.random.PRNGKey(1))["params"]
    ids, mask = _inputs()
    target = np.random.default_rng(2).standard_normal((3, CFG.hidden_dim))

    def loss(p):
        with jax.default_matmul_precision("highest"):
            e = model.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))
        return jnp.sum(e * target)

    grads = jax.grad(loss)(params)
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    rng = np.random.default_rng(3)
    for path in (("layer_0", "attention", "query", "kernel"),
                 ("layer_1", "mlp_in", "kernel"), ("emb_ln", "scale"),
                 ("layer_0", "attention", "out", "kernel"),
                 ("tok_emb", "embedding")):
        leaf = p64
        g = grads
        for k in path:
            leaf, g = leaf[k], g[k]
        for _ in range(3):
            if path[-1] == "embedding":  # only used rows carry gradient
                at = (int(ids[0, rng.integers(0, 7)]),
                      int(rng.integers(0, leaf.shape[1])))
            else:
                at = tuple(int(rng.integers(0, s)) for s in leaf.shape)
            old = leaf[at]
            eps = 1e-5
            leaf[at] = old + eps
            up = np.sum(_np_forward(p64, ids, mask) * target)
            leaf[at] = old - eps
            dn = np.sum(_np_forward(p64, ids, mask) * target)
            leaf[at] = old
            fd = (up - dn) / (2 * eps)
            assert abs(float(np.asarray(g)[at]) - fd) <= 1e-4 + 1e-3 * abs(fd), (
                path, at, float(np.asarray(g)[at]), fd)


@pytest.mark.parametrize("impl,platform,drop,det,seq_len,dtype,want", [
    ("auto", "cpu", 0.0, True, 128, "bfloat16", "naive"),
    ("auto", "gpu", 0.1, False, 128, "bfloat16", "naive"),  # probs dropout
    ("auto", "gpu", 0.0, True, 128, "bfloat16", "cudnn"),
    ("auto", "gpu", 0.0, True, 128, "float32", "naive"),  # cuDNN is bf16
    ("auto", "gpu", 0.1, True, 32, "bfloat16", "naive"),  # short queries
    ("naive", "gpu", 0.0, True, 128, "bfloat16", "naive"),
    ("cudnn", "gpu", 0.0, True, 32, "bfloat16", "cudnn"),
])
def test_attention_dispatch(impl, platform, drop, det, seq_len, dtype, want):
    import dataclasses

    cfg = dataclasses.replace(CFG, attn_impl=impl, dtype=dtype)
    assert attn_dispatch(cfg, drop, det, seq_len, platform) == want


@pytest.mark.gpu
def test_cudnn_attention_matches_naive():
    import dataclasses

    ids, mask = _inputs()
    outs = []
    for impl in ("naive", "cudnn"):
        cfg = dataclasses.replace(CFG, attn_impl=impl, dtype="bfloat16")
        model = Encoder(cfg)
        params = model.init(jax.random.PRNGKey(0))["params"]
        outs.append(np.asarray(model.apply({"params": params},
                                           jnp.asarray(ids),
                                           jnp.asarray(mask))))
    np.testing.assert_allclose(outs[0], outs[1], atol=2e-2)
