"""Streaming encode→insert (BASELINE config #5 path at test scale): embeddings
flow from the encoder into index.add per megabatch, never aggregating on the
host; results must match the all-at-once build."""

import numpy as np

from cloudvectordb_tpu.data.synthetic import synthetic_corpus
from cloudvectordb_tpu.data.tokenize import TextTokenizer
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index import FlatIndex, IVFPQIndex
from cloudvectordb_tpu.models.embed import encode_corpus, encode_corpus_streaming
from cloudvectordb_tpu.models.encoder import init_encoder
from cloudvectordb_tpu.utils.config import EncoderConfig


def _setup():
    corpus = synthetic_corpus(300, seed=80)
    tok = TextTokenizer.train(corpus, vocab_size=512, max_len=16)
    cfg = EncoderConfig(
        vocab_size=max(tok.vocab_size, 8), hidden_dim=32, num_layers=1,
        num_heads=4, mlp_dim=64, max_len=16, dropout=0.0, dtype="float32",
    )
    model, params = init_encoder(cfg, seed=0)
    return corpus, tok, model, params


def test_streaming_flat_matches_bulk():
    corpus, tok, model, params = _setup()
    emb = encode_corpus(model, params, tok, corpus, batch_size=64)
    idx = FlatIndex(dim=32, metric="ip")
    total = encode_corpus_streaming(
        model, params, tok, corpus, consume=idx.add, batch_size=64
    )
    assert total == len(corpus) == idx.ntotal
    q = emb[:8]
    _, gt = brute_force_topk(emb, q, 5, metric="ip")
    _, found = idx.search(q, 5)
    assert recall_at_k(found, gt) == 1.0


def test_streaming_into_ivfpq_incremental():
    corpus, tok, model, params = _setup()
    emb = encode_corpus(model, params, tok, corpus, batch_size=64)
    idx = IVFPQIndex(dim=32, nlist=8, m=8, nbits=6, metric="ip",
                     kmeans_iters=5, pq_train_iters=5, refine="int8")
    idx.train(emb[:200])  # quantizers from the first megabatch's sample
    encode_corpus_streaming(
        model, params, tok, corpus, consume=lambda e: idx.add(np.asarray(e)),
        batch_size=64,
    )
    idx.merge_pending()
    assert idx.ntotal == len(corpus)
    q = emb[:8]
    _, gt = brute_force_topk(emb, q, 5, metric="ip")
    _, found = idx.search(q, 5, nprobe=8)
    assert recall_at_k(found, gt) >= 0.5  # PQ-limited, but wired correctly
