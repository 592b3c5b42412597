"""Numerical parity: Encoder with imported weights ≡ torch BertModel.

Uses a randomly-initialized BertModel (no network / no pretrained weights
needed) — if the weight mapping is right, mean-pooled outputs must match.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from cloudvectordb_tpu.models.encoder import Encoder  # noqa: E402
from cloudvectordb_tpu.models.hf_import import (  # noqa: E402
    config_from_hf,
    params_from_state_dict,
)


def test_bert_parity():
    hf_cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=24, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
    )
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg).eval()

    cfg = config_from_hf(hf_cfg)
    cfg.dtype = "float32"
    cfg.normalize = False
    cfg.pooling = "mean"
    params = params_from_state_dict(dict(hf.state_dict()), cfg)
    model = Encoder(cfg)

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, size=(3, 24)).astype(np.int64)
    mask = np.ones((3, 24), np.int64)
    mask[1, 12:] = 0  # one padded row

    with torch.no_grad():
        hs = hf(
            input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)
        ).last_hidden_state.numpy()
    w = mask[:, :, None].astype(np.float32)
    hf_pooled = (hs * w).sum(1) / w.sum(1)

    ours = np.asarray(
        model.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                    jnp.asarray(mask, jnp.int32))
    )
    np.testing.assert_allclose(ours, hf_pooled, rtol=2e-3, atol=2e-4)
