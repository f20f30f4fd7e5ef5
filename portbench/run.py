"""Run one cell of ``BENCHMARK.json`` once, on the card:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line on standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, then ``checks``); the last lines on
standard error are each number compared beside its limit. Exits non-zero
and prints no result where there is no card (or fewer than the cell asks
for), where the run fails, or where ``jax``, ``jaxlib``, ``flax`` or
``gwen_tpu`` is loaded once the window has closed.

The program's build and kernel caches stay in the checkout, at fixed
paths: nvcc's libraries and Triton's cache in ``gwen_tpu_torch/_build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "gwen_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN``."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "gwen_tpu_torch" / "_build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")

    import torch

    from portbench.harness import run_cell
    from portbench.spec import Spec

    chips = Spec.load(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    try:
        out, notes = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0))
    except Exception:  # the run's boundary: report and print no result
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in notes:
        print(f"# {line}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
