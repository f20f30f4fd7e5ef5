"""Command-line interface of the port::

    python -m gwen_tpu_torch predict --artifact DIR --input x0.npy \
        [--steps N] [--out predictions.npy] [--device cuda]

Slice 1 of the port serves; the other ``gwen-tpu`` subcommands come with
later slices (ROADMAP queue A).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(prog="gwen_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    prd = sub.add_parser("predict")
    prd.add_argument("--artifact", required=True, help="exported artifact dir")
    prd.add_argument("--input", required=True,
                     help=".npy initial state (nodes, channels)")
    prd.add_argument("--steps", type=int, default=1)
    prd.add_argument("--out", default="predictions.npy")
    prd.add_argument("--device", default="cuda",
                     help="torch device (default cuda; fails without CUDA)")
    args = parser.parse_args(argv)

    if args.cmd == "predict":
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
