"""Import HuggingFace BERT-family weights into the Encoder.

MiniLM-L6 / BERT checkpoints map 1:1 onto models/encoder.py (same post-LN
transformer). Gated: the build environment is offline (no HF cache), so this
is exercised when a checkpoint directory is provided on disk. Accepts either
a ``transformers`` BertModel/AutoModel directory or a raw state-dict mapping.
"""

from __future__ import annotations

import numpy as np

from cloudvectordb_tpu.utils.config import EncoderConfig


def config_from_hf(hf_cfg) -> EncoderConfig:
    return EncoderConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_dim=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        mlp_dim=hf_cfg.intermediate_size,
        max_len=hf_cfg.max_position_embeddings,
        dropout=hf_cfg.hidden_dropout_prob,
    )


def _split_heads(w: np.ndarray, num_heads: int) -> np.ndarray:
    """(hidden, hidden) HF projection → (hidden, heads, head_dim) DenseGeneral."""
    h = w.shape[0]
    return w.T.reshape(h, num_heads, h // num_heads)


def params_from_state_dict(sd: dict, cfg: EncoderConfig) -> dict:
    """HF BertModel state dict (torch tensors or numpy) → encoder params tree."""
    g = lambda k: np.asarray(sd[k].numpy() if hasattr(sd[k], "numpy") else sd[k])  # noqa: E731
    nh = cfg.num_heads
    hd = cfg.hidden_dim // nh
    # single-segment encoding: HF adds token_type_embeddings[0] to every
    # position — fold it into the position embeddings (exact equivalence).
    pos = g("embeddings.position_embeddings.weight")
    if "embeddings.token_type_embeddings.weight" in sd:
        pos = pos + g("embeddings.token_type_embeddings.weight")[0][None, :]
    params: dict = {
        "tok_emb": {"embedding": g("embeddings.word_embeddings.weight")},
        "pos_emb": {"embedding": pos},
        "emb_ln": {
            "scale": g("embeddings.LayerNorm.weight"),
            "bias": g("embeddings.LayerNorm.bias"),
        },
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        params[f"layer_{i}"] = {
            "attention": {
                "query": {
                    "kernel": _split_heads(g(p + "attention.self.query.weight"), nh),
                    "bias": g(p + "attention.self.query.bias").reshape(nh, hd),
                },
                "key": {
                    "kernel": _split_heads(g(p + "attention.self.key.weight"), nh),
                    "bias": g(p + "attention.self.key.bias").reshape(nh, hd),
                },
                "value": {
                    "kernel": _split_heads(g(p + "attention.self.value.weight"), nh),
                    "bias": g(p + "attention.self.value.bias").reshape(nh, hd),
                },
                "out": {
                    "kernel": g(p + "attention.output.dense.weight").T.reshape(
                        nh, hd, cfg.hidden_dim
                    ),
                    "bias": g(p + "attention.output.dense.bias"),
                },
            },
            "attention_ln": {
                "scale": g(p + "attention.output.LayerNorm.weight"),
                "bias": g(p + "attention.output.LayerNorm.bias"),
            },
            "mlp_in": {
                "kernel": g(p + "intermediate.dense.weight").T,
                "bias": g(p + "intermediate.dense.bias"),
            },
            "mlp_out": {
                "kernel": g(p + "output.dense.weight").T,
                "bias": g(p + "output.dense.bias"),
            },
            "mlp_ln": {
                "scale": g(p + "output.LayerNorm.weight"),
                "bias": g(p + "output.LayerNorm.bias"),
            },
        }
    return params


def load_hf_encoder(model_dir: str):
    """Local checkpoint dir → (Encoder, params). Needs torch+transformers."""
    import transformers

    hf = transformers.AutoModel.from_pretrained(model_dir, local_files_only=True)
    cfg = config_from_hf(hf.config)
    sd = {
        k.removeprefix("bert."): v for k, v in hf.state_dict().items()
    }
    params = params_from_state_dict(sd, cfg)
    from cloudvectordb_tpu.models.encoder import Encoder

    return Encoder(cfg), params
