"""Encoder forward: shapes, normalization, padding invariance."""

import numpy as np
import jax.numpy as jnp

from cloudvectordb_tpu.models.encoder import init_encoder
from cloudvectordb_tpu.utils.config import EncoderConfig

CFG = EncoderConfig(
    vocab_size=128, hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
    max_len=16, dropout=0.0, dtype="float32",
)


def test_forward_shape_and_norm():
    model, params = init_encoder(CFG, seed=0)
    ids = jnp.ones((4, 16), jnp.int32)
    mask = jnp.ones((4, 16), jnp.int32)
    out = model.apply({"params": params}, ids, mask)
    assert out.shape == (4, 32)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(out), axis=1), 1.0, rtol=1e-5)


def test_padding_invariance():
    """Extra padded positions must not change the pooled embedding."""
    model, params = init_encoder(CFG, seed=0)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 128, size=(2, 8))
    ids_a = np.zeros((2, 16), np.int32)
    ids_a[:, :8] = toks
    mask_a = np.zeros((2, 16), np.int32)
    mask_a[:, :8] = 1
    ids_b = ids_a.copy()
    ids_b[:, 8:] = 77  # garbage under the mask
    out_a = model.apply({"params": params}, jnp.asarray(ids_a), jnp.asarray(mask_a))
    out_b = model.apply({"params": params}, jnp.asarray(ids_b), jnp.asarray(mask_b := mask_a))
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(out_b), atol=1e-5)


def test_projection_head():
    cfg = EncoderConfig(**{**CFG.__dict__, "out_dim": 24})
    model, params = init_encoder(cfg, seed=0)
    out = model.apply(
        {"params": params}, jnp.ones((2, 16), jnp.int32), jnp.ones((2, 16), jnp.int32)
    )
    assert out.shape == (2, 24)
