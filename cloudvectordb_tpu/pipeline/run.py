"""Pipeline orchestration [REF README.md:2 — the whole sentence]:

    corpus → triplets → trained encoder(s) → embeddings → vector DB

Each stage writes an artifact + completion marker into the workdir and is
independently resumable/skippable (SURVEY.md §3.1, §5.3). Control stays in one
host process; device work happens inside each stage. A `--fail-after` hook
injects crashes so integration tests exercise resume (SURVEY.md §5.3).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import jax

from cloudvectordb_tpu.data.corpus import load_passages
from cloudvectordb_tpu.data.tokenize import TextTokenizer
from cloudvectordb_tpu.data.triplets import Triplets, mine_triplets, triplet_batches
from cloudvectordb_tpu.eval.recall import brute_force_topk, recall_at_k
from cloudvectordb_tpu.index import build_index, load_index
from cloudvectordb_tpu.models.embed import encode_corpus, text_encoder
from cloudvectordb_tpu.models.encoder import Encoder
from cloudvectordb_tpu.train.trainer import Trainer
from cloudvectordb_tpu.utils.checkpoint import restore_checkpoint
from cloudvectordb_tpu.utils.config import PipelineConfig
from cloudvectordb_tpu.utils.metrics import MetricsWriter, StageTimer, get_logger

log = get_logger("cvdb.pipeline")


class FailInjection(RuntimeError):
    """Raised by the --fail-after test hook (SURVEY.md §5.3)."""


class Pipeline:
    def __init__(self, cfg: PipelineConfig, fail_after: str | None = None):
        self.cfg = cfg
        self.workdir = Path(cfg.workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        from cloudvectordb_tpu.utils.config import TrainConfig

        if cfg.train.ckpt_dir == TrainConfig().ckpt_dir:
            # the class default is CWD-relative and SHARED across runs — a
            # second pipeline with a different encoder shape would resume
            # from the first one's checkpoint (r5, observed shape error).
            # Left at default → scope it under this run's workdir; explicit
            # overrides are honored as-is.
            cfg.train.ckpt_dir = str(self.workdir / "ckpt")
        # first run stamps the config; resumes must not clobber it (it is the
        # source of truth for artifact locations like ckpt_dir)
        if not (self.workdir / "pipeline_config.json").exists():
            cfg.save(self.workdir / "pipeline_config.json")
        self.metrics = MetricsWriter(self.workdir / "metrics.jsonl")
        self.fail_after = fail_after
        self._passages = None
        self._doc_ids = None
        self._tokenizer = None

    # -- stage plumbing ----------------------------------------------------
    def _done_marker(self, stage: str) -> Path:
        return self.workdir / f".done_{stage}"

    def is_done(self, stage: str) -> bool:
        return self._done_marker(stage).exists()

    def _mark_done(self, stage: str) -> None:
        self._done_marker(stage).write_text("ok")
        if self.fail_after == stage:
            raise FailInjection(f"injected failure after stage {stage!r}")

    # -- shared data -------------------------------------------------------
    @property
    def passages(self):
        if self._passages is None:
            cache = self.workdir / "passages.jsonl"
            if cache.exists():
                recs = [json.loads(l) for l in cache.read_text().splitlines()]
                self._passages = [r["text"] for r in recs]
                self._doc_ids = [r["doc_id"] for r in recs]
            else:
                self._passages, self._doc_ids = load_passages(self.cfg.data)
                with cache.open("w") as fh:
                    for t, d in zip(self._passages, self._doc_ids):
                        fh.write(json.dumps({"text": t, "doc_id": d}) + "\n")
        return self._passages

    @property
    def doc_ids(self):
        _ = self.passages
        return self._doc_ids

    @property
    def tokenizer(self) -> TextTokenizer:
        if self._tokenizer is None:
            tok_path = self.workdir / "tokenizer.json"
            max_len = self.cfg.train.encoder.max_len
            if tok_path.exists():
                self._tokenizer = TextTokenizer.load(tok_path, max_len)
            else:
                self._tokenizer = TextTokenizer.train(
                    iter(self.passages),
                    vocab_size=self.cfg.train.encoder.vocab_size,
                    max_len=max_len,
                )
                self._tokenizer.save(tok_path)
        return self._tokenizer

    def _train_cfg(self):
        """cfg.train with the preset resolved and encoder vocab clamped to
        the actual tokenizer — the single definition used by training AND
        checkpoint restore."""
        tcfg = self.cfg.train
        if tcfg.encoder_preset:
            import dataclasses

            from cloudvectordb_tpu.models.presets import get_preset

            # the preset fixes the widths; the sequence length stays the
            # configured one (the tokenizer already padded to it)
            tcfg.encoder = dataclasses.replace(
                get_preset(tcfg.encoder_preset),
                max_len=tcfg.encoder.max_len)
        tcfg.encoder.vocab_size = max(self.tokenizer.vocab_size, 8)
        return tcfg

    def _load_params(self):
        trainer = Trainer(self._train_cfg())
        state = trainer.init_state()
        restored, step, _ = restore_checkpoint(self.cfg.train.ckpt_dir, state)
        if restored is None:
            raise RuntimeError("no trained encoder checkpoint found")
        return Encoder(self.cfg.train.encoder), jax.device_get(restored).params

    # -- stages --------------------------------------------------------------
    def stage_mine(self) -> Triplets:
        out = self.workdir / "triplets.jsonl"
        if self.is_done("mine"):
            return Triplets.load(out)
        with StageTimer(self.metrics, "mine"):
            cfg = self.cfg.mining
            encode_fn = index = None
            if cfg.strategy == "hard":
                # hard mining needs a current encoder + index over the corpus
                model, params = self._load_params()
                encode_fn = text_encoder(
                    model, params, self.tokenizer, batch_size=self.cfg.encode_batch
                )
                emb = encode_corpus(
                    model, params, self.tokenizer, self.passages,
                    batch_size=self.cfg.encode_batch,
                )
                from cloudvectordb_tpu.index import FlatIndex

                index = FlatIndex.build(emb, metric=self.cfg.index.metric)
            trip = mine_triplets(
                self.passages, self.doc_ids, cfg, encode_fn=encode_fn, index=index
            )
            trip.save(out)
            self.metrics.log("mined", count=len(trip))
        self._mark_done("mine")
        return trip

    def stage_train(self):
        if self.is_done("train"):
            return
        with StageTimer(self.metrics, "train"):
            trip = Triplets.load(self.workdir / "triplets.jsonl")
            tcfg = self._train_cfg()
            trainer = Trainer(tcfg, metrics=self.metrics)
            batches = triplet_batches(
                trip, self.tokenizer, tcfg.batch_size, tcfg.encoder.max_len,
                seed=tcfg.seed,
            )
            trainer.fit(batches)
        self._mark_done("train")

    def stage_encode(self) -> np.ndarray:
        out = self.workdir / "embeddings.npy"
        if self.is_done("encode"):
            return np.load(out)
        with StageTimer(self.metrics, "encode"):
            model, params = self._load_params()
            emb = encode_corpus(
                model, params, self.tokenizer, self.passages,
                batch_size=self.cfg.encode_batch,
            )
            np.save(out, emb)
            # degeneracy check: an undertrained/collapsed encoder maps
            # everything to one point; downstream recall then measures
            # tie-ordering, not retrieval. Surface the cause loudly.
            ns = min(512, emb.shape[0])
            sample = emb[np.random.default_rng(0).choice(emb.shape[0], ns, replace=False)]
            sims = sample[: ns // 2] @ sample[ns // 2 :].T
            mean_sim = float(np.mean(sims))
            if mean_sim > 0.98:
                log.warning(
                    "embeddings are near-degenerate (mean pairwise cosine %.4f): "
                    "the encoder is undertrained or collapsed — increase "
                    "train.total_steps / lower train.lr before trusting recall",
                    mean_sim,
                )
            self.metrics.log(
                "encoded", count=emb.shape[0], dim=emb.shape[1], mean_sim=mean_sim
            )
        self._mark_done("encode")
        return emb

    def stage_build(self):
        out = self.workdir / "index"
        if self.is_done("build"):
            return load_index(out)
        with StageTimer(self.metrics, "build"):
            emb = np.load(self.workdir / "embeddings.npy")
            icfg = self.cfg.index
            icfg.dim = emb.shape[1]
            index = build_index(emb, icfg)
            index.save(out, extra_meta={"config_hash": icfg.config_hash()})
            self.metrics.log("built", kind=icfg.kind, ntotal=index.ntotal)
        self._mark_done("build")
        return load_index(out)

    def _eval_queries(self, emb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(queries, exact ground-truth ids) — perturbed corpus embeddings,
        shared by stage_eval and stage_tune so both measure the same task.

        The perturbation scales with the DATA's dispersion, not an absolute
        0.01/dim: real encoder output concentrates on a narrow cone (r5:
        mean-cos 0.98, RMS distance-to-mean ~0.18 at unit norm), where an
        absolute 0.01/dim noise (~0.2 total) throws queries off-manifold
        and recall measures tie-breaking among near-equidistant rows
        instead of retrieval (measured: 0.66 vs 0.94 on the same index).
        On unit-spread data (Gaussians) the factor is ~1 and the task is
        unchanged."""
        nq = min(self.cfg.eval_queries, emb.shape[0])
        rng = np.random.default_rng(0)
        qsel = rng.choice(emb.shape[0], nq, replace=False)
        sample = emb[rng.choice(emb.shape[0], min(65_536, emb.shape[0]),
                                replace=False)]
        mu = sample.mean(axis=0)
        spread = float(np.sqrt(((sample - mu) ** 2).sum(axis=1).mean()))
        sigma = 0.01 * max(min(spread, 1.0), 1e-6)
        q = emb[qsel] + sigma * rng.normal(
            size=(nq, emb.shape[1])).astype(np.float32)
        if self.cfg.index.metric == "ip":
            q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        _, gt = brute_force_topk(emb, q, self.cfg.eval_k, metric=self.cfg.index.metric)
        return q, gt

    def stage_tune(self, target_recall: float = 0.95) -> dict:
        """Auto-pick the index's serving op point (eval/tune.py) against the
        eval query distribution and re-save the artifact so the tuned knobs
        become search()'s defaults on every future load. Re-runnable (no
        done-marker): tune again after adds or with a new target."""
        with StageTimer(self.metrics, "tune"):
            emb = np.load(self.workdir / "embeddings.npy")
            index = load_index(self.workdir / "index")
            q, gt = self._eval_queries(emb)
            try:
                report = index.tune(q, self.cfg.eval_k, target_recall, gt=gt)
            except NotImplementedError:
                # flat = exact search, nothing to tune — a supported kind
                # must not traceback out of the CLI
                out = {"op": {}, "met": True, "recall": 1.0, "qps": None,
                       "target_recall": target_recall,
                       "note": f"kind {index.kind!r} is exact — no tunable "
                               "serving knobs"}
                log.info("tune: %s", out["note"])
                return out
            index.save(self.workdir / "index",
                       extra_meta={"config_hash": self.cfg.index.config_hash()})
            out = {"op": report["op"], "met": report["met"],
                   "recall": report["recall"], "qps": report.get("qps"),
                   "target_recall": target_recall}
            self.metrics.log("tuned", **out)
            log.info("tune: op=%s recall=%.4f (target %.2f, met=%s)",
                     report["op"], report["recall"], target_recall, report["met"])
        return out

    def stage_eval(self) -> dict:
        if self.is_done("eval") and (self.workdir / "eval.json").exists():
            return json.loads((self.workdir / "eval.json").read_text())
        with StageTimer(self.metrics, "eval"):
            emb = np.load(self.workdir / "embeddings.npy")
            index = load_index(self.workdir / "index")
            k = self.cfg.eval_k
            q, gt = self._eval_queries(emb)
            kw = {} if self.cfg.index.kind == "flat" else {"nprobe": self.cfg.index.nprobe}
            _, found = index.search(q, k, **kw)
            r = recall_at_k(found, gt)
            # steady-state QPS (eval/qps.py); index.search's numpy outputs
            # fence every call
            from cloudvectordb_tpu.eval.qps import qps_bench

            bench = qps_bench(
                lambda qb: index.search(np.asarray(qb), k, **kw), q,
                warmup=1, iters=3,
            )
            result = {"recall_at_k": r, "k": k, "nq": q.shape[0],
                      "qps": bench["qps"], "device": bench["device"],
                      "kind": self.cfg.index.kind}
            self.metrics.log("eval", **result)
            (self.workdir / "eval.json").write_text(json.dumps(result, indent=2))
            log.info("eval: recall@%d = %.4f", k, r)
        self._mark_done("eval")
        return result

    def run(self) -> dict:
        stages = {
            "mine": self.stage_mine, "train": self.stage_train,
            "encode": self.stage_encode, "build": self.stage_build,
            "tune": self.stage_tune, "eval": self.stage_eval,
        }
        result = {}
        for name in self.cfg.stages:
            log.info("stage: %s%s", name, " (done, skipping)" if self.is_done(name) else "")
            out = stages[name]()
            if name == "eval":
                result = out
        return result


def run_pipeline(cfg: PipelineConfig, fail_after: str | None = None) -> dict:
    return Pipeline(cfg, fail_after=fail_after).run()
