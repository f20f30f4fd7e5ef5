"""The port's ensemble skill against the reference's, on the CPU: the
skill configuration of ``benchmarks/skill_campaign.py`` (BASELINE.md:
latent 128, 2 process steps, 3 epochs, 4 members of which the last is held
out, 16 time steps, closed-form inflation calibration) run through both
packages in float32 from the same start.

    python tools/skill_parity.py [--processor gcn] [--levels 6]
        [--epochs 3] [--members 4] [--steps 16] [--latent 128]
        [--process-steps 2] [--seed 42]

Both packages get the same synthetic ensemble (the reference's
``mesh_ensemble_dataset``, checked equal to the port's), the same node
order (the reference's RCM for GCN, its KD-patch order for attention), the
same initial parameters (the reference's ``init`` converted with
``gwen_tpu_torch.nn.params_from_jax``), the same shuffled batches, and the
same white noise for the skill verification: the port's ``verify_skill``
draws what the reference draws from ``jax.random.key(7)`` and ``key(13)``.
Each trains as its ``train-mesh`` does on the CPU without partitions: GCN
on the COO graph (``mesh.kernel=segment``), attention on the diag-window
layout with its transpose tables (the reference's Pallas kernels in
interpret mode, the port's plain versions). Prints one JSON line: each
package's best train loss, fair CRPS, ensemble-mean RMSE, spread and
spread/error ratio, its wall seconds, and the relative difference of each
score, ``|port − reference| / |reference|`` (the reference's numbers also
on stderr as soon as its run ends).

Imports both packages, as the tests do; nothing in ``gwen_tpu_torch``
imports this file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SCORES = ("crps", "rmse_ensemble_mean", "spread", "spread_error_ratio")


def configure(args) -> dict:
    """Both packages' configs at the skill campaign's settings."""
    from gwen_tpu.config import GwenConfig as JConfig
    from gwen_tpu_torch.config import GwenConfig

    out = {}
    for name, cfg in (("reference", JConfig()), ("port", GwenConfig())):
        cfg.graph.refine = args.levels
        cfg.model.architecture = "encode-process-decode"
        cfg.model.latent_size = args.latent
        cfg.model.process_steps = args.process_steps
        cfg.model.processor = args.processor
        cfg.model.compute_dtype = "float32"
        cfg.mesh.kernel = "segment" if args.processor == "gcn" else "auto"
        cfg.train.epochs = args.epochs
        cfg.train.seed = args.seed
        cfg.train.calibrate_inflation = True
        out[name] = cfg
    return out


def reference_run(cfg, fields, s2, r2, n, members, params) -> dict:
    """The reference's ``train-mesh`` on the CPU, from ``params``: train,
    then its skill section."""
    import jax
    import jax.numpy as jnp

    from gwen_tpu import ensemble
    from gwen_tpu.data.dataset import MeshEnsembleDataset
    from gwen_tpu.graph import build_graph, to_diag_window
    from gwen_tpu.nn import EncodeProcessDecode
    from gwen_tpu.train import Trainer, TrainState
    from gwen_tpu.train.optim import make_optimizer
    from gwen_tpu.train.tasks import mesh_graph_loss_fn

    t0 = time.perf_counter()
    tcfg, mc = cfg.train, cfg.model
    ch = fields.shape[-1]
    g = build_graph(s2, r2, n)
    graph = (to_diag_window(g, window_size=cfg.mesh.diag_window,
                            dtype=jnp.float32, transpose_tables=True)
             if mc.processor == "attention" else g)
    kw = dict(channels_in=ch, channels_out=ch, latent_size=mc.latent_size,
              process_steps=mc.process_steps, mlp_layers=mc.mlp_layers,
              residual=mc.residual, processor=mc.processor,
              attn_heads=mc.attn_heads)
    model = EncodeProcessDecode(compute_dtype=jnp.float32, **kw)
    opt = make_optimizer(tcfg.lr * tcfg.lr_multiplier,
                         weight_decay=tcfg.weight_decay,
                         scheduler=tcfg.scheduler,
                         warmup_steps=tcfg.warmup_steps,
                         cycle_steps=tcfg.cycle_steps, grad_clip=tcfg.grad_clip)
    trainer = Trainer(loss_fn=mesh_graph_loss_fn(model, loss="mse"),
                      optimizer=opt, context=graph)
    ds = MeshEnsembleDataset(fields=fields[:, :-1])
    state, best = trainer.fit(
        TrainState.create(params, opt),
        lambda ep: ds.batches(tcfg.batch_size, shuffle=True, seed=ep),
        tcfg.epochs)

    horizon = min(4, fields.shape[0] - 1)
    skill_model = EncodeProcessDecode(
        backend="segment" if mc.processor != "attention" else "auto", **kw)
    sgraph = graph if mc.processor == "attention" else g
    gen = ensemble.generate_ensemble(
        skill_model, state.params, sgraph, jnp.asarray(fields[0, -1]),
        jax.random.key(7), num_members=members, num_steps=horizon,
        sigma=tcfg.sigma)
    vgen = ensemble.generate_ensemble(
        skill_model, state.params, sgraph, jnp.asarray(fields[0, 0]),
        jax.random.key(13), num_members=members, num_steps=horizon,
        sigma=tcfg.sigma)
    inflation = ensemble.calibrate_inflation(
        vgen, jnp.asarray(fields[1:1 + horizon, 0]), ensemble_axis=0)
    gen = ensemble.inflate_ensemble(gen, inflation, ensemble_axis=0)
    skill = ensemble.ensemble_skill(gen, jnp.asarray(fields[1:1 + horizon, -1]),
                                    ensemble_axis=0)
    return {"best_train_loss": float(best), "steps": int(state.step),
            "inflation": float(inflation),
            **{k: float(v) for k, v in skill.items()},
            "wall_s": time.perf_counter() - t0}


def port_run(cfg, fields, s2, r2, n, members, params) -> dict:
    """The port's ``train-mesh`` path on the CPU, from the same
    ``params``, ending in its own ``verify_skill`` with the reference's
    noise."""
    import jax
    import jax.numpy as jnp
    import torch

    from gwen_tpu_torch.cli.train_mesh import verify_skill
    from gwen_tpu_torch.data import MeshEnsembleDataset
    from gwen_tpu_torch.graph import build_graph, to_diag_window
    from gwen_tpu_torch.nn import EncodeProcessDecode, params_from_jax
    from gwen_tpu_torch.train import (Trainer, TrainState, make_optimizer,
                                      mesh_graph_loss_fn)

    t0 = time.perf_counter()
    tcfg, mc = cfg.train, cfg.model
    dev = torch.device("cpu")
    ch = fields.shape[-1]
    g = build_graph(s2, r2, n)
    graph = (to_diag_window(g, window_size=cfg.mesh.diag_window,
                            dtype=torch.float32, transpose_tables=True)
             if mc.processor == "attention" else g)
    model = EncodeProcessDecode(
        ch, ch, device=dev, latent_size=mc.latent_size,
        process_steps=mc.process_steps, mlp_layers=mc.mlp_layers,
        residual=mc.residual, compute_dtype=torch.float32,
        processor=mc.processor, attn_heads=mc.attn_heads)
    model.load_state_dict(params_from_jax(params))
    opt = make_optimizer(model.parameters(), tcfg.lr * tcfg.lr_multiplier,
                         weight_decay=tcfg.weight_decay,
                         scheduler=tcfg.scheduler,
                         warmup_steps=tcfg.warmup_steps,
                         cycle_steps=tcfg.cycle_steps, grad_clip=tcfg.grad_clip)
    trainer = Trainer(mesh_graph_loss_fn(model, loss="mse"), dev, context=graph)
    ds = MeshEnsembleDataset(fields=fields[:, :-1])
    state, best = trainer.fit(
        TrainState(model=model, optimizer=opt),
        lambda ep: ds.batches(tcfg.batch_size, shuffle=True, seed=ep),
        tcfg.epochs)

    def draw(seed, shape):
        """The reference's white noise: one draw from ``jax.random.key``."""
        return torch.from_numpy(
            jax.device_get(jax.random.normal(jax.random.key(seed), shape,
                                             jnp.float32)).copy())

    skill = verify_skill(cfg, model, fields, g, graph, members, dev, draw=draw)
    return {"best_train_loss": float(best), "steps": int(state.step),
            **{k: float(v) for k, v in skill.items()},
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--processor", default="gcn", choices=("gcn", "attention"))
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--members", type=int, default=4)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--latent", type=int, default=128)
    p.add_argument("--process-steps", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    import logging

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    # Both trainers log each epoch: the run's progress, on stderr.
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="# %(asctime)s %(name)s %(message)s")

    from gwen_tpu.data.synthetic import mesh_ensemble_dataset as j_dataset
    from gwen_tpu.graph import apply_order, kd_patch_order, rcm_order
    from gwen_tpu.nn import EncodeProcessDecode
    from gwen_tpu_torch.data import mesh_ensemble_dataset

    cfgs = configure(args)
    fields, verts, s, r = j_dataset(levels=args.levels, members=args.members,
                                    steps=args.steps, seed=args.seed)
    p_fields = mesh_ensemble_dataset(levels=args.levels, members=args.members,
                                     steps=args.steps, seed=args.seed)[0]
    np.testing.assert_allclose(p_fields, fields, rtol=1e-6, atol=1e-6)
    n = fields.shape[2]
    perm = (kd_patch_order(np.asarray(verts), s, r, n)
            if args.processor == "attention" else rcm_order(s, r, n))
    s2, r2, _ = apply_order(perm, s, r)
    fields = np.take(fields, perm, axis=2)
    mc = cfgs["reference"].model
    ch = fields.shape[-1]
    params = EncodeProcessDecode(
        channels_in=ch, channels_out=ch, latent_size=mc.latent_size,
        process_steps=mc.process_steps, mlp_layers=mc.mlp_layers,
        residual=mc.residual, processor=mc.processor,
        attn_heads=mc.attn_heads).init(jax.random.key(args.seed))
    params = jax.tree_util.tree_map(np.asarray, params)

    ref = reference_run(cfgs["reference"], fields, s2, r2, n, args.members, params)
    print(f"# reference: {json.dumps(ref)}", file=sys.stderr, flush=True)
    port = port_run(cfgs["port"], fields, s2, r2, n, args.members, params)
    rel = {k: abs(port[k] - ref[k]) / abs(ref[k])
           for k in ("best_train_loss", *SCORES)}
    print(json.dumps({"processor": args.processor, "levels": args.levels,
                      "nodes": n, "latent": args.latent,
                      "process_steps": args.process_steps,
                      "epochs": args.epochs,
                      "train_members": args.members - 1,
                      "time_steps": args.steps,
                      "batch_size": cfgs["port"].train.batch_size,
                      "reference": ref, "port": port, "rel_diff": rel}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
