"""CLI — the single-entry-point ergonomics of the reference's "script"
[REF README.md:2], with each stage independently invocable (SURVEY.md §2.5).

    python -m cloudvectordb_tpu pipeline --config cfg.json [--set a.b=v ...]
    python -m cloudvectordb_tpu {mine,train,encode,build,eval,tune} ...
    python -m cloudvectordb_tpu search --workdir W --query "text" -k 10
"""

from __future__ import annotations

import argparse
import json
import sys

from cloudvectordb_tpu.utils.config import PipelineConfig
from cloudvectordb_tpu.utils.metrics import get_logger

log = get_logger("cvdb.cli")


def _parse_value(v: str):
    try:
        return json.loads(v)
    except json.JSONDecodeError:
        return v


def _load_cfg(args) -> PipelineConfig:
    if args.config:
        cfg = PipelineConfig.load(args.config)
    else:
        # an existing run's saved config is the source of truth on resume —
        # otherwise `search`/`eval` would look for artifacts under defaults
        from pathlib import Path

        saved = Path(args.workdir or PipelineConfig().workdir) / "pipeline_config.json"
        cfg = PipelineConfig.load(saved) if saved.exists() else PipelineConfig()
    if args.workdir:
        cfg.workdir = args.workdir
    overrides = {}
    for kv in args.set or []:
        k, _, v = kv.partition("=")
        overrides[k] = _parse_value(v)
    if overrides:
        cfg = cfg.with_overrides(overrides)
    return cfg


def _add_common(p):
    p.add_argument("--config", default=None, help="pipeline config JSON")
    p.add_argument("--workdir", default=None)
    p.add_argument("--set", action="append", metavar="a.b.c=value",
                   help="dotted-path config override (repeatable)")
    p.add_argument("--profile", action="store_true",
                   help="wrap the stage's hot loop in jax.profiler.trace")
    p.add_argument("--debug", action="store_true",
                   help="enable jax_debug_nans (SURVEY.md §5.2)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("cloudvectordb_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("pipeline", "mine", "train", "encode", "build", "eval"):
        _add_common(sub.add_parser(name))
    tp = sub.add_parser("tune")
    _add_common(tp)
    tp.add_argument("--target-recall", type=float, default=0.95,
                    help="recall@k the tuner must reach (eval/tune.py)")
    sp = sub.add_parser("search")
    _add_common(sp)
    sp.add_argument("--query", required=True)
    sp.add_argument("-k", type=int, default=10)
    sp.add_argument("--nprobe", type=int, default=None)
    args = ap.parse_args(argv)

    from cloudvectordb_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    if args.debug:
        import jax

        jax.config.update("jax_debug_nans", True)

    cfg = _load_cfg(args)
    from cloudvectordb_tpu.pipeline.run import Pipeline

    pipe = Pipeline(cfg)

    def run_cmd():
        if args.cmd == "pipeline":
            result = pipe.run()
            print(json.dumps(result))
        elif args.cmd == "mine":
            pipe.stage_mine()
        elif args.cmd == "train":
            pipe.stage_train()
        elif args.cmd == "encode":
            pipe.stage_encode()
        elif args.cmd == "build":
            pipe.stage_build()
        elif args.cmd == "eval":
            print(json.dumps(pipe.stage_eval()))
        elif args.cmd == "tune":
            print(json.dumps(pipe.stage_tune(args.target_recall)))
        elif args.cmd == "search":
            from cloudvectordb_tpu.index import load_index
            from cloudvectordb_tpu.models.embed import text_encoder

            model, params = pipe._load_params()
            enc = text_encoder(model, params, pipe.tokenizer,
                               batch_size=min(32, cfg.encode_batch))
            index = load_index(pipe.workdir / "index")
            q = enc([args.query])
            kw = {}
            if index.kind != "flat":
                kw["nprobe"] = args.nprobe or cfg.index.nprobe
            scores, ids = index.search(q, args.k, **kw)
            passages = pipe.passages
            for rank, (s, i) in enumerate(zip(scores[0], ids[0])):
                print(f"{rank + 1:3d}. [{s:.4f}] {passages[int(i)][:120]}")

    if args.profile:
        import jax

        with jax.profiler.trace(str(pipe.workdir / "profile")):
            run_cmd()
    else:
        run_cmd()
    return 0


if __name__ == "__main__":
    sys.exit(main())
