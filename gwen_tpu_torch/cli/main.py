r"""Command-line interface of the port. Every pipeline stage is a subcommand
with ``section.key=value`` config overrides, each printing one JSON line::

    python -m gwen_tpu_torch ingest      [--config cfg.json] [overrides...]
    python -m gwen_tpu_torch preprocess  [--config cfg.json] [overrides...]
    python -m gwen_tpu_torch train-gnn   [--config cfg.json] [--no-animate]
        [--out-dir output] [--device cuda] [overrides...]
    python -m gwen_tpu_torch train-cnn   [--config cfg.json] [--no-animate]
        [--out-dir output] [--device cuda] [overrides...]
    python -m gwen_tpu_torch make-mesh-data --out store.zarr [--members M]
        [--steps T] [--config cfg.json] [overrides...]
    python -m gwen_tpu_torch train-mesh [--config cfg.json] [--members M]
        [--steps T] [--data store.zarr] [--device cuda] [overrides...]
    python -m gwen_tpu_torch export --out DIR [--data store.zarr]
        [--experiment NAME] [--rollout-steps 4] [--device cuda]
        [--config cfg.json] [overrides...]
    python -m gwen_tpu_torch predict --artifact DIR --input x0.npy \
        [--steps N] [--out predictions.npy] [--device cuda]
    python -m gwen_tpu_torch runs [--experiment NAME] [--root runs]
    python -m gwen_tpu_torch gif --input data.zarr [--var theta_v]
        [--out output] [--member M]
    python -m gwen_tpu_torch bench [--device cuda] [--extra-out PATH]

``train-mesh`` partitioned over several devices, and ``train-gnn`` and
``train-cnn`` data-parallel (each batch cut over the processes), run one
process per device; rank 0 alone writes the registry and prints the JSON
line::

    python -m torch.distributed.run --nproc-per-node 2 -m gwen_tpu_torch \
        train-mesh --device cpu mesh.graph_axis=2
    python -m torch.distributed.run --nproc_per_node N -m gwen_tpu_torch \
        train-gnn --config cfg.json --no-animate [overrides...]
    python -m torch.distributed.run --nproc_per_node N -m gwen_tpu_torch \
        train-cnn --config cfg.json --no-animate [overrides...]

``ingest`` needs ``h5py`` and ``gif`` (and ``train-gnn`` or ``train-cnn``
without ``--no-animate``) matplotlib and Pillow, each imported where it is
used; everything else runs on numpy and torch. ``bench`` measures the
aggregation, the EPD train step and the attention aggregation on the
card (:mod:`gwen_tpu_torch.bench`; the reference's ``GWEN_BENCH_*``
environment knobs): one JSON line on stdout, the rest on stderr, and the
extras written only to ``--extra-out``.
"""

from __future__ import annotations

import argparse
import json
import sys

_CONFIGURED = ("ingest", "preprocess", "train-gnn", "train-cnn", "train-mesh",
               "make-mesh-data", "export")
_DEVICE_HELP = "torch device (default cuda; fails without CUDA)"


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="gwen_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in _CONFIGURED:
        p = sub.add_parser(name)
        p.add_argument("--config", default=None,
                       help="config JSON (nested or reference-flat)")
        p.add_argument("overrides", nargs="*", help="section.key=value overrides")
        if name in ("train-gnn", "train-cnn"):
            p.add_argument("--no-animate", action="store_true")
            p.add_argument("--out-dir", default="output")
        if name == "make-mesh-data":
            p.add_argument("--out", required=True)
        if name in ("make-mesh-data", "train-mesh"):
            p.add_argument("--members", type=int, default=4)
            p.add_argument("--steps", type=int, default=16)
        if name == "train-mesh":
            p.add_argument("--data", default="",
                           help="mesh-ensemble zarr store (default: synthetic)")
        if name == "export":
            p.add_argument("--out", required=True, help="artifact directory")
            p.add_argument("--data", default="",
                           help="mesh store whose graph sidecar rebuilds the "
                                "mesh (default: icosphere from the run's levels)")
            p.add_argument("--experiment", default="",
                           help="registry experiment (default: "
                                "<run.experiment>_MESH)")
            p.add_argument("--rollout-steps", type=int, default=4,
                           help="steps per dispatch the artifact records "
                                "(the port's rollout loops step by step)")
        if name in ("train-gnn", "train-cnn", "train-mesh", "export"):
            p.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    prd = sub.add_parser("predict")
    prd.add_argument("--artifact", required=True, help="exported artifact dir")
    prd.add_argument("--input", required=True,
                     help=".npy initial state (nodes, channels)")
    prd.add_argument("--steps", type=int, default=1)
    prd.add_argument("--out", default="predictions.npy")
    prd.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    rns = sub.add_parser("runs")
    rns.add_argument("--experiment", default=None, help="default: all experiments")
    rns.add_argument("--root", default="runs")
    bch = sub.add_parser("bench")
    bch.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    bch.add_argument("--extra-out", default=None,
                     help="also write the extras (train step, attention) "
                          "as JSON to this file")
    g = sub.add_parser("gif")
    g.add_argument("--input", default=None,
                   help="zarr store with (time, member, height, ncells); "
                        "prompted interactively when omitted")
    g.add_argument("--var", default="theta_v")
    g.add_argument("--out", default="output")
    g.add_argument("--member", default=None,
                   help="member index or id (default: all)")
    # Overrides may also follow an option (``--device cpu mesh.graph_axis=2``),
    # where argparse no longer collects the positional.
    args, extra = parser.parse_known_args(argv)
    stray = [a for a in extra if a.startswith("-") or "=" not in a]
    if stray or (extra and args.cmd not in _CONFIGURED):
        parser.error(f"unrecognized arguments: {' '.join(stray or extra)}")

    cfg = None
    if args.cmd in _CONFIGURED:
        from gwen_tpu_torch.config import load_config
        from gwen_tpu_torch.logging_utils import setup_logger

        setup_logger()
        cfg = load_config(args.config).apply_overrides([*args.overrides, *extra])

    if args.cmd == "ingest":
        from gwen_tpu_torch.data.ingest import ingest

        arch = ingest(cfg.data)
        print(json.dumps({"zarr": str(arch.path), "shape": list(arch.shape)}))
    elif args.cmd == "preprocess":
        from gwen_tpu_torch.data.preprocess import preprocess

        train, test = preprocess(cfg.data)
        print(json.dumps({"train": str(train), "test": str(test)}))
    elif args.cmd in ("train-gnn", "train-cnn", "train-mesh"):
        from gwen_tpu_torch.train.mesh import is_main_process

        if args.cmd == "train-mesh":
            from gwen_tpu_torch.cli.train_mesh import main as run

            out = run(cfg, members=args.members, steps=args.steps,
                      data=args.data, device=args.device)
        else:
            if args.cmd == "train-gnn":
                from gwen_tpu_torch.cli.train_gnn import main as run
            else:
                from gwen_tpu_torch.cli.train_cnn import main as run
            out = run(cfg, animate=not args.no_animate, out_dir=args.out_dir,
                      device=args.device)
        if is_main_process():  # rank 0 of a run of several processes speaks
            print(json.dumps(out))
    elif args.cmd == "make-mesh-data":
        from gwen_tpu_torch.data.meshstore import save_mesh_dataset
        from gwen_tpu_torch.data.synthetic import mesh_ensemble_dataset

        fields, verts, s, r = mesh_ensemble_dataset(
            levels=cfg.graph.refine, members=args.members, steps=args.steps,
            seed=cfg.train.seed,
        )
        path = save_mesh_dataset(args.out, fields, s, r, verts)
        print(json.dumps({"path": str(path), "fields": list(fields.shape)}))
    elif args.cmd == "export":
        from gwen_tpu_torch.cli.export_cli import export_main

        out = export_main(cfg, out=args.out, data=args.data,
                          experiment=args.experiment,
                          rollout_steps=args.rollout_steps, device=args.device)
        print(json.dumps(out))
    elif args.cmd == "predict":
        from gwen_tpu_torch.cli.export_cli import predict_main

        out = predict_main(args.artifact, args.input, args.steps, args.out,
                           device=args.device)
        print(json.dumps(out))
    elif args.cmd == "bench":
        from gwen_tpu_torch.bench import main as bench

        bench(device=args.device, extra_out=args.extra_out)
    elif args.cmd == "runs":
        from pathlib import Path

        from gwen_tpu_torch.registry import Registry

        root = Path(args.root)
        reg = Registry(root)
        exps = ([args.experiment] if args.experiment
                else sorted(p.name for p in root.iterdir() if p.is_dir())
                if root.exists() else [])
        rows = []
        for exp in exps:
            if exp == "checkpoints":
                continue
            for r in reg.get_runs(exp, with_artifacts_only=False):
                meta = r.meta
                rows.append({"experiment": exp, "run_id": r.run_id,
                             "status": meta.get("status"),
                             "best_metric": meta.get("best_metric")})
        print(json.dumps(rows, indent=2))
    elif args.cmd == "gif":
        import numpy as np

        from gwen_tpu_torch import viz
        from gwen_tpu_torch.data import zarrstore

        if args.input is None:
            # Interactive fallback of a bare invocation: prompts for the
            # store, the variable and the output directory.
            args.input = input("Enter the path to the input zarr store: ").strip()
            var = input(f"Enter the variable name [{args.var}]: ").strip()
            out = input(f"Enter the output directory [{args.out}]: ").strip()
            args.var = var or args.var
            args.out = out or args.out
        arr = zarrstore.open_array(args.input)
        data = arr.read()
        members = arr.meta.get("members") or [str(i) for i in range(data.shape[1])]
        idxs = range(data.shape[1])
        if args.member is not None:
            idxs = [int(args.member)] if args.member.isdigit() else [
                members.index(args.member)
            ]
        paths = []
        for m in idxs:
            paths.append(str(viz.create_animation(
                np.asarray(data[:, m]), members[m], args.out, var_name=args.var
            )))
        print(json.dumps({"gifs": paths}))
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
