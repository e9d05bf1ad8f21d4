"""Command-line entry point: ``python -m mlops_tpu_torch <command> [key=value ...]``.

- ``serve``: serve a quant-tier bundle over HTTP;
- ``predict-file``: score a record-history CSV with a ``doc`` bundle and
  print one JSON line (``data.train_path=<csv>
  serve.model_directory=<bundle> [serve.max_batch=N]``).

Overrides are positional ``section.field=value`` pairs, as in the JAX
package's CLI (``serve.model_directory=<bundle> serve.port=5001
serve.device=cpu``). Both commands run on the card unless
``serve.device=cpu``. For ``serve``, ``MODEL_DIRECTORY`` and
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
    serve = sub.add_parser("serve", help="serve a quant-tier bundle over HTTP")
    serve.add_argument(
        "overrides", nargs="*", help="config overrides, e.g. serve.port=5001"
    )
    predict = sub.add_parser(
        "predict-file", help="score a record-history CSV with a doc bundle"
    )
    predict.add_argument(
        "overrides", nargs="*",
        help="config overrides, e.g. data.train_path=<csv> "
        "serve.model_directory=<bundle>",
    )
    return parser


def _serve(overrides: list[str]) -> int:
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.config import load_config
    from mlops_tpu_torch.serve.engine import InferenceEngine
    from mlops_tpu_torch.serve.server import serve_forever

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    config = load_config(overrides)
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


def _predict_file(overrides: list[str]) -> int:
    from mlops_tpu_torch.commands import predict_file
    from mlops_tpu_torch.config import load_config

    print(json.dumps(predict_file(load_config(overrides))), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "serve":
        return _serve(args.overrides)
    if args.command == "predict-file":
        return _predict_file(args.overrides)
    build_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
