"""Large-batch embedding generation — stage 3 [REF README.md:2: "building the
embeddings with the encoder"] (SURVEY.md §3.3).

``encode_corpus`` runs the jitted encoder forward with the batch axis sharded
over the mesh; the streaming variant feeds embeddings straight into
``index.add`` without a host round-trip per megabatch beyond the tokenized
inputs (BASELINE.json:11 "streaming encode→insert").
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import jax
import jax.numpy as jnp

from cloudvectordb_tpu.parallel.mesh import data_sharding, replicated
from cloudvectordb_tpu.utils.metrics import get_logger

log = get_logger("cvdb.embed")


def make_encode_fn(model, params, mesh=None, donate: bool = False):
    """Returns encode(ids, mask) -> embeddings; jitted, DP-sharded if mesh."""
    if mesh is not None:
        shard = data_sharding(mesh)
        repl = replicated(mesh)
        fn = jax.jit(
            lambda p, ids, mask: model.apply({"params": p}, ids, mask, True),
            in_shardings=(repl, shard, shard),
            out_shardings=shard,
        )
        params = jax.device_put(params, repl)
    else:
        fn = jax.jit(
            lambda p, ids, mask: model.apply({"params": p}, ids, mask, True)
        )
        # pin params on device ONCE: a numpy pytree here would re-ship all
        # parameter bytes over the host link on EVERY call
        params = jax.device_put(params)

    def encode(ids: np.ndarray, mask: np.ndarray) -> jax.Array:
        return fn(params, jnp.asarray(ids), jnp.asarray(mask))

    return encode


def _pad_batch(ids, mask, to: int):
    n = ids.shape[0]
    if n == to:
        return ids, mask, n
    pad = to - n
    ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), ids.dtype)])
    mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]), mask.dtype)])
    mask[n:, 0] = 1  # avoid fully-masked rows (mean-pool div guard is belt+braces)
    return ids, mask, n


def text_encoder(model, params, tokenizer, mesh=None, batch_size: int = 256,
                 max_len: int | None = None) -> Callable[[list[str]], np.ndarray]:
    """texts → embeddings closure (used by mining, query-time encoding, eval)."""
    encode = make_encode_fn(model, params, mesh)

    def run(texts: list[str]) -> np.ndarray:
        outs = []
        for s in range(0, len(texts), batch_size):
            ids, mask = tokenizer.encode_batch(texts[s : s + batch_size], max_len)
            # pad the tail to the full batch: one static shape → one compile
            ids, mask, n = _pad_batch(ids, mask, batch_size)
            outs.append(np.asarray(encode(ids, mask))[:n])
        return np.concatenate(outs) if outs else np.zeros((0, model.embed_dim))

    return run


def encode_corpus(
    model, params, tokenizer, passages: list[str], mesh=None,
    batch_size: int = 256, max_len: int | None = None,
) -> np.ndarray:
    """All-at-once embedding matrix (host-resident). For the streaming
    build path use encode_corpus_streaming."""
    run = text_encoder(model, params, tokenizer, mesh, batch_size, max_len)
    return run(passages)


def encode_corpus_streaming(
    model, params, tokenizer, passages: Iterator[list[str]] | list[str],
    consume: Callable[[jax.Array], None], mesh=None,
    batch_size: int = 256, max_len: int | None = None,
) -> int:
    """Encode megabatches and hand each device-resident embedding block to
    ``consume`` (e.g. index.add) — embeddings never aggregate on the host.

    Double-buffered by JAX's async dispatch: tokenization of batch t+1 runs
    on the host while the device still computes batch t.
    """
    encode = make_encode_fn(model, params, mesh)
    if isinstance(passages, list):
        _items = passages
        passages = (
            _items[s : s + batch_size] for s in range(0, len(_items), batch_size)
        )
    total = 0
    pending = None  # (device_array, n_valid)
    for chunk in passages:
        ids, mask = tokenizer.encode_batch(chunk, max_len)
        ids, mask, n = _pad_batch(ids, mask, batch_size if len(chunk) <= batch_size else len(chunk))
        emb = encode(ids, mask)  # async dispatch
        if pending is not None:
            consume(pending[0][: pending[1]])
        pending = (emb, n)
        total += n
    if pending is not None:
        consume(pending[0][: pending[1]])
    return total
