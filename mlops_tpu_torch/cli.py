"""Command-line entry point: ``python -m mlops_tpu_torch <command> [key=value ...]``.

- ``serve``: serve a quant-tier bundle over HTTP;
- ``predict-file``: score a record-history CSV with a ``doc`` bundle and
  print one JSON line (``data.train_path=<csv>
  serve.model_directory=<bundle> [serve.max_batch=N]``);
- ``train``: train the long-context doc model and print one JSON line
  (``--config configs/long_context_job.toml model.seq_parallel=false
  registry.root=<dir> registry.run_root=<dir>``).

Every command takes ``--config <toml>`` and positional
``section.field=value`` overrides, as the JAX package's CLI does
(``serve.model_directory=<bundle> serve.port=5001 serve.device=cpu``).
Every command runs on the card unless ``serve.device=cpu`` (serve,
predict-file) or ``train.device=cpu`` (train). For ``serve``, ``MODEL_DIRECTORY`` and
``SERVICE_NAME`` in the environment take precedence over the config, as
in the reference.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mlops-tpu-torch",
        description="PyTorch/CUDA port of the credit-default serving path",
    )
    sub = parser.add_subparsers(dest="command")
    commands = {
        "serve": ("serve a quant-tier bundle over HTTP", "serve.port=5001"),
        "predict-file": (
            "score a record-history CSV with a doc bundle",
            "data.train_path=<csv> serve.model_directory=<bundle>",
        ),
        "train": (
            "train the long-context doc model into a doc bundle",
            "train.steps=200 registry.root=<dir>",
        ),
    }
    for name, (help_text, example) in commands.items():
        cmd = sub.add_parser(name, help=help_text)
        cmd.add_argument(
            "--config", default=None, help="path to a TOML config file"
        )
        cmd.add_argument(
            "overrides", nargs="*", help=f"config overrides, e.g. {example}"
        )
    return parser


def _serve(config) -> int:
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine
    from mlops_tpu_torch.serve.server import serve_forever

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = config.serve
    cfg.service_name = os.environ.get("SERVICE_NAME", cfg.service_name)
    model_dir = os.environ.get("MODEL_DIRECTORY", cfg.model_directory)
    engine = InferenceEngine(
        load_bundle(model_dir),
        buckets=tuple(cfg.warmup_batch_sizes),
        serve_tier=cfg.serve_tier,
        device=cfg.device,
    )
    serve_forever(engine, cfg)
    return 0


def _predict_file(config) -> int:
    from mlops_tpu_torch.commands import predict_file

    print(json.dumps(predict_file(config)), flush=True)
    return 0


def _train(config) -> int:
    from mlops_tpu_torch.commands import train

    print(json.dumps(train(config)), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    from mlops_tpu_torch.config import load_config

    args = build_parser().parse_args(argv)
    handlers = {"serve": _serve, "predict-file": _predict_file, "train": _train}
    if args.command not in handlers:
        build_parser().print_help()
        return 1
    return handlers[args.command](load_config(args.overrides, args.config))


if __name__ == "__main__":
    sys.exit(main())
