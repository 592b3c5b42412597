"""Tiny end-to-end pipeline (SURVEY.md §4.2): corpus → mine → train → encode →
build → eval; loss decreases, recall beats chance, resume-after-crash works."""

import json

import numpy as np
import pytest

from cloudvectordb_tpu.pipeline.run import FailInjection, Pipeline
from cloudvectordb_tpu.utils.config import (
    DataConfig,
    EncoderConfig,
    IndexConfig,
    MiningConfig,
    PipelineConfig,
    TrainConfig,
)


def _tiny_cfg(tmp_path, kind="ivf_flat") -> PipelineConfig:
    return PipelineConfig(
        workdir=str(tmp_path / "run"),
        data=DataConfig(corpus="synthetic", num_docs=300, max_len=32),
        mining=MiningConfig(strategy="inbatch", num_triplets=512),
        train=TrainConfig(
            encoder=EncoderConfig(
                vocab_size=2048, hidden_dim=32, num_layers=2, num_heads=4,
                mlp_dim=64, max_len=32, dropout=0.0, dtype="float32",
            ),
            loss="infonce", temperature=0.1, batch_size=32, lr=2e-3,
            warmup_steps=5, total_steps=40, ckpt_every=20, log_every=10,
            ckpt_dir=str(tmp_path / "run" / "ckpt"),
        ),
        index=IndexConfig(
            kind=kind, metric="ip", nlist=16, nprobe=16, m=8, nbits=6,
            kmeans_iters=8, pq_train_iters=6, train_sample=4096,
        ),
        encode_batch=64, eval_k=10, eval_queries=64,
    )


def test_pipeline_end_to_end(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    pipe = Pipeline(cfg)
    result = pipe.run()
    # full-probe IVF-Flat over trained embeddings: exact retrieval of the
    # embedding space → recall must be 1.0 regardless of embedding quality
    assert result["recall_at_k"] == 1.0
    # training must have actually learned: loss at end < loss at start
    metrics = [
        json.loads(l)
        for l in (pipe.workdir / "metrics.jsonl").read_text().splitlines()
    ]
    losses = [m["loss"] for m in metrics if m["event"] == "train_step"]
    assert len(losses) >= 3
    assert losses[-1] < losses[0]
    # all artifacts exist
    for f in ("triplets.jsonl", "embeddings.npy", "index", "eval.json", "tokenizer.json"):
        assert (pipe.workdir / f).exists(), f


def test_pipeline_tune_stage(tmp_path):
    """r3: the tune stage picks an op point, persists it in the artifact,
    and a reloaded index serves with it by default (CLI `tune`)."""
    from cloudvectordb_tpu.index import load_index

    cfg = _tiny_cfg(tmp_path)
    pipe = Pipeline(cfg)
    pipe.run()
    out = pipe.stage_tune(target_recall=0.9)
    assert out["met"] and out["recall"] >= 0.9
    assert "nprobe" in out["op"]
    loaded = load_index(pipe.workdir / "index")
    assert loaded._op_point == out["op"]
    emb = np.load(pipe.workdir / "embeddings.npy")
    q, gt = pipe._eval_queries(emb)
    from cloudvectordb_tpu.eval.recall import recall_at_k

    _, found = loaded.search(q, cfg.eval_k)  # op point fills nprobe
    assert recall_at_k(found, gt) >= 0.9


def test_pipeline_tune_in_stages_tuple(tmp_path):
    """`tune` is a first-class entry of the stages
    dispatch — a config with stages (..., 'build', 'tune', 'eval') runs
    end-to-end instead of KeyError-ing."""
    cfg = _tiny_cfg(tmp_path)
    cfg.stages = ("mine", "train", "encode", "build", "tune", "eval")
    result = Pipeline(cfg).run()
    assert result["recall_at_k"] == 1.0
    from cloudvectordb_tpu.index import load_index

    loaded = load_index(Pipeline(cfg).workdir / "index")
    assert loaded._op_point  # the tuned op point persisted in the artifact


def test_pipeline_resume_after_injected_failure(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    with pytest.raises(FailInjection):
        Pipeline(cfg, fail_after="train").run()
    workdir = Pipeline(cfg).workdir
    assert (workdir / ".done_train").exists()
    assert not (workdir / ".done_encode").exists()
    # resume completes the remaining stages without retraining
    mtime = (workdir / ".done_train").stat().st_mtime
    result = Pipeline(cfg).run()
    assert result["recall_at_k"] == 1.0
    assert (workdir / ".done_train").stat().st_mtime == mtime  # not re-run


def test_pipeline_runs_without_flax_and_tokenizers(tmp_path):
    """The main path (mine → train → encode → build → eval, then the CLI
    search) imports neither flax nor tokenizers: both are poisoned in
    sys.modules of a fresh interpreter before anything is imported."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[2]
    sets = {"workdir": str(tmp_path / "run"), "data.num_docs": 200,
            "mining.num_triplets": 128, "train.encoder_preset": "tiny-test",
            "train.encoder.max_len": 32, "train.batch_size": 16,
            "train.total_steps": 4, "train.warmup_steps": 1,
            "train.log_every": 2, "train.ckpt_dir": str(tmp_path / "ckpt"),
            "index.kind": "band_ivf", "index.nlist": 8,
            "index.train_sample": 4096, "encode_batch": 64,
            "eval_queries": 32}
    argv = []
    for k, v in sets.items():
        argv += ["--set", f"{k}={json.dumps(v)}"]
    code = (
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['tokenizers'] = None\n"
        "from cloudvectordb_tpu.cli import main\n"
        "main(sys.argv[1:])\n"
        "assert 'flax' not in [m.split('.')[0] for m in sys.modules\n"
        "                      if sys.modules[m] is not None]\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(repo),
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    for cmd in (["pipeline"], ["search", "--query", "the telescope", "-k",
                               "3"]):
        out = subprocess.run([sys.executable, "-c", code, *cmd, *argv],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
    assert "1. [" in out.stdout
