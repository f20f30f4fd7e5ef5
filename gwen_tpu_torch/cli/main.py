"""Command-line interface of the port::

    python -m gwen_tpu_torch train-mesh [--config cfg.json] [--members M]
        [--steps T] [--device cuda] [section.key=value ...]
    python -m gwen_tpu_torch predict --artifact DIR --input x0.npy \
        [--steps N] [--out predictions.npy] [--device cuda]

``train-mesh`` partitioned over several devices is one process per device::

    python -m torch.distributed.run --nproc-per-node 2 -m gwen_tpu_torch \
        train-mesh --device cpu mesh.graph_axis=2

The port trains and serves; the other ``gwen-tpu`` subcommands come with
later slices (ROADMAP queue A).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(prog="gwen_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    trn = sub.add_parser("train-mesh")
    trn.add_argument("--config", default=None,
                     help="config JSON (nested or reference-flat)")
    trn.add_argument("overrides", nargs="*", help="section.key=value overrides")
    trn.add_argument("--members", type=int, default=4)
    trn.add_argument("--steps", type=int, default=16)
    trn.add_argument("--data", default="",
                     help="mesh-ensemble store (not ported yet; synthetic "
                          "data when empty)")
    trn.add_argument("--device", default="cuda",
                     help="torch device (default cuda; fails without CUDA)")
    prd = sub.add_parser("predict")
    prd.add_argument("--artifact", required=True, help="exported artifact dir")
    prd.add_argument("--input", required=True,
                     help=".npy initial state (nodes, channels)")
    prd.add_argument("--steps", type=int, default=1)
    prd.add_argument("--out", default="predictions.npy")
    prd.add_argument("--device", default="cuda",
                     help="torch device (default cuda; fails without CUDA)")
    # Overrides may also follow an option (``--device cpu mesh.graph_axis=2``),
    # where argparse no longer collects the positional.
    args, extra = parser.parse_known_args(argv)
    stray = [a for a in extra if a.startswith("-") or "=" not in a]
    if stray or (extra and args.cmd != "train-mesh"):
        parser.error(f"unrecognized arguments: {' '.join(stray or extra)}")

    if args.cmd == "train-mesh":
        from gwen_tpu_torch.cli.train_mesh import main as run
        from gwen_tpu_torch.config import load_config
        from gwen_tpu_torch.logging_utils import setup_logger
        from gwen_tpu_torch.train.mesh import is_main_process

        setup_logger()
        cfg = load_config(args.config).apply_overrides([*args.overrides, *extra])
        out = run(cfg, members=args.members, steps=args.steps, data=args.data,
                  device=args.device)
        if is_main_process():  # rank 0 of a partitioned run speaks for it
            print(json.dumps(out))
    elif args.cmd == "predict":
        from gwen_tpu_torch.cli.export_cli import predict_main

        out = predict_main(args.artifact, args.input, args.steps, args.out,
                           device=args.device)
        print(json.dumps(out))
    return 0


def cli_entry() -> int:
    """Console entry: expected failures print one line, not a traceback."""
    try:
        return main()
    except (FileNotFoundError, KeyError, ValueError, RuntimeError) as e:
        print(f"gwen_tpu_torch: error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(cli_entry())
