"""``python -m gwen_tpu_torch train-mesh``: mesh-scale training of the
encode-process-decode model (GCN, attention or interaction processor) on
one device, followed by the skill verification of a generated ensemble.

Counterpart of ``gwen_tpu.cli.train_mesh.main``, with the reference's
choice of path and ``cuda`` in place of ``tpu``. GCN: on a CUDA device,
with ``mesh.kernel`` ``auto``, ``diag`` or ``diag_packed``, the nodes take
the KD-patch order and the graph the diag-window layout (aggregations
through kernels B1/B4, or their packed form on ``diag_packed``, with the
esc2 contraction on B3/B10; residual LayerNorms through B2/B2b). Other
kernels on CUDA take RCM and a banded layout: ``packed`` (and any kernel
but ``sliding`` whose weighted S would reach 7 GiB) the bit-packed one
(kernel B13), else the weighted one (B3/B10); ``segment`` keeps the COO
graph. On the CPU GCN takes RCM and the segment path. Attention
(``model.processor=attention``): KD-patch order and the diag-window layout
with transpose tables on every device, packed on ``diag_packed``, as the
reference (kernels B5, B6, B7 on CUDA, their plain versions on the CPU); a
``mesh.kernel`` other than ``auto``/``diag``/``diag_packed`` is refused.
The interaction processor (``model.processor=interaction``) keeps RCM and
the COO graph on every device. The device is explicit: asking for ``cuda``
where there is none raises.

The task follows the reference: ``train.rollout_horizon > 1`` trains on
trajectories (``rollout_loss_fn``), ``train.loss=crps-ensemble`` on the
fair ensemble CRPS of ``train.crps_members`` perturbed forecasts per
sample, anything else on next-step MSE or L1. The last member is held out.
After ``save_model`` the run generates an ensemble from the held-out
member's first state (``members`` members, up to 4 steps; ``train.sigma``,
or the amplitude ``train.calibrate_sigma`` picks on the training members),
inflates it (``train.inflation``, or ``train.calibrate_inflation`` on
member 0) and logs and returns its ``skill_*`` scores. The skill model
computes in float32: on the COO graph, except attention, which keeps the
trained diag-window graph (its noise smoothing then runs the aggregation
kernels on a float32 field over the bf16 layout).

Not ported yet, each refused with a ``ValueError``: the partitioned path
and ``--data`` input.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gwen_tpu_torch.config import GwenConfig
from gwen_tpu_torch.logging_utils import get_logger
from gwen_tpu_torch.registry import Registry, default_experiment

log = get_logger()


def _refuse_later_slices(config: GwenConfig, data: str) -> None:
    mesh = config.mesh
    waits = [
        (mesh.graph_axis > 1 or mesh.force_partition, "the partitioned "
         "path (mesh.graph_axis > 1, mesh.force_partition) comes with "
         "slice 6 of the port"),
        (bool(data), "--data (mesh-ensemble stores) is not ported yet; "
         "train on the synthetic ensemble"),
    ]
    for cond, msg in waits:
        if cond:
            raise ValueError(msg)


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train-mesh: CUDA is not available; pass --device cpu to train "
            "on the CPU segment path")
    return dev


def diag_path(dev: torch.device, kernel: str, processor: str) -> bool:
    """Whether the run takes KD-patch order and the diag-window layout:
    attention on every device, GCN on CUDA."""
    if kernel == "diag_packed" and processor == "interaction":
        raise ValueError(
            "mesh.kernel='diag_packed' supports model.processor='gcn' and "
            "'attention' (the interaction net rides the segment path)")
    if processor == "attention":
        if kernel not in ("auto", "diag", "diag_packed"):
            raise ValueError(
                "model.processor='attention' requires mesh.kernel in "
                f"('auto', 'diag', 'diag_packed'); got {kernel!r}")
        return True
    return (dev.type == "cuda" and kernel in ("auto", "diag", "diag_packed")
            and processor == "gcn")


def banded_layout(g, s2: np.ndarray, r2: np.ndarray, kernel: str,
                  dtype: torch.dtype):
    """The banded layout of the GCN path on CUDA off the diag layout, as the
    reference picks it on the TPU: the bit-packed one for
    ``mesh.kernel="packed"`` or where the weighted S (bf16, band rounded up
    plus one block) would reach 7 GiB, unless ``"sliding"`` asks for the
    weighted one."""
    from gwen_tpu_torch.graph import bandwidth, to_sliding_dense, to_sliding_packed

    n = g.num_nodes
    bw = bandwidth(s2, r2)
    s_bytes = (-(-n // 128) * 128) * (-(-bw // 128) * 128 + 128) * 2
    if kernel == "packed" or (kernel != "sliding" and s_bytes >= int(7 * 2**30)):
        return to_sliding_packed(g)
    return to_sliding_dense(g, dtype=dtype)


def main(config: GwenConfig, members: int = 4, steps: int = 16,
         data: str = "", device: str = "cuda") -> dict:
    from gwen_tpu_torch.data import MeshEnsembleDataset, mesh_ensemble_dataset
    from gwen_tpu_torch.graph import (
        apply_order,
        build_graph,
        kd_patch_order,
        rcm_order,
        to_diag_window,
    )
    from gwen_tpu_torch.nn import EncodeProcessDecode
    from gwen_tpu_torch.train import (
        Checkpointer,
        Trainer,
        TrainState,
        ensemble_crps_loss_fn,
        make_optimizer,
        mesh_graph_loss_fn,
        rollout_loss_fn,
    )

    _refuse_later_slices(config, data)
    dev = resolve_device(device)
    tcfg = config.train
    levels = config.graph.refine
    processor = config.model.processor

    fields, verts, s, r = mesh_ensemble_dataset(
        levels=levels, members=members, steps=steps, seed=tcfg.seed)
    n = fields.shape[2]
    kernel = config.mesh.kernel
    use_diag = diag_path(dev, kernel, processor)
    perm = kd_patch_order(np.asarray(verts), s, r, n) if use_diag else rcm_order(s, r, n)
    s2, r2, _ = apply_order(perm, s, r)
    fields = np.take(fields, perm, axis=2)
    ch = fields.shape[-1]

    compute_dtype = (torch.bfloat16 if config.model.compute_dtype == "bfloat16"
                     else torch.float32)
    model = EncodeProcessDecode(
        ch, ch, device=dev,
        latent_size=config.model.latent_size,
        process_steps=config.model.process_steps,
        mlp_layers=config.model.mlp_layers,
        residual=config.model.residual,
        remat=tcfg.remat,
        compute_dtype=compute_dtype,
        processor=processor,
        attn_heads=config.model.attn_heads,
        attn_pack=config.model.attn_pack,
        generator=torch.Generator().manual_seed(tcfg.seed),
    )

    g = build_graph(s2, r2, n)
    if use_diag:
        graph = to_diag_window(g, window_size=config.mesh.diag_window,
                               dtype=compute_dtype,
                               transpose_tables=processor == "attention",
                               packed=kernel == "diag_packed")
    elif dev.type == "cuda" and kernel != "segment" and processor == "gcn":
        graph = banded_layout(g, s2, r2, kernel, compute_dtype)
    else:
        graph = g
    if tcfg.rollout_horizon > 1:
        loss_fn = rollout_loss_fn(model, tcfg.rollout_horizon)
    elif tcfg.loss == "crps-ensemble":
        loss_fn = ensemble_crps_loss_fn(
            model, num_members=tcfg.crps_members, sigma=tcfg.sigma)
    else:
        loss_fn = mesh_graph_loss_fn(
            model, loss=tcfg.loss if tcfg.loss in ("mse", "l1") else "mse")

    # Train on all members except the last (held out for skill verification).
    ds = MeshEnsembleDataset(fields=fields[:, :-1])
    opt = make_optimizer(
        model.parameters(),
        tcfg.lr * tcfg.lr_multiplier,
        weight_decay=tcfg.weight_decay,
        scheduler=tcfg.scheduler,
        warmup_steps=tcfg.warmup_steps,
        cycle_steps=tcfg.cycle_steps,
        grad_clip=tcfg.grad_clip,
    )
    state = TrainState(model=model, optimizer=opt)

    registry = Registry(config.run.registry_root)
    experiment = (config.run.experiment or default_experiment()) + "_MESH"
    run = registry.create_run(experiment, config.to_dict(), config.run.run_name)
    ckpt = Checkpointer(
        Path(config.run.registry_root) / "checkpoints" / run.run_id,
        max_to_keep=tcfg.max_checkpoints,
    )
    trainer = Trainer(loss_fn, dev, run=run, checkpointer=ckpt,
                      log_every=tcfg.log_every, context=graph)
    if tcfg.rollout_horizon > 1:
        def batches(ep):
            return ds.trajectory_batches(tcfg.batch_size, tcfg.rollout_horizon,
                                         shuffle=True, seed=ep)
    elif tcfg.loss == "crps-ensemble":
        def batches(ep):  # a seed per step for the perturbations
            for i, (x, y) in enumerate(ds.batches(tcfg.batch_size, shuffle=True,
                                                  seed=ep)):
                yield x, y, ep * 100003 + i
    else:
        def batches(ep):
            return ds.batches(tcfg.batch_size, shuffle=True, seed=ep)
    state, best = trainer.fit(state, batches, tcfg.epochs,
                              checkpoint_every=tcfg.checkpoint_every)
    run.save_model(
        model.state_dict(),
        {"latent_size": config.model.latent_size,
         "process_steps": config.model.process_steps,
         "channels": ch, "levels": levels,
         "processor": processor,
         "attn_heads": config.model.attn_heads,
         "attn_pack": config.model.attn_pack,
         "residual": config.model.residual,
         "mlp_layers": config.model.mlp_layers,
         "diag_window": config.mesh.diag_window,
         "compute_dtype": config.model.compute_dtype,
         "nodes": n, "data": data or ""},
        best_metric=best,
    )
    skill = verify_skill(config, model, fields, g, trainer.context, members,
                         dev, run)
    run.finish()
    log.info("mesh training done: best=%.5f steps=%d skill=%s", best,
             state.step, skill)
    return {"best_train_loss": best, "run_id": run.run_id,
            "run_dir": str(run.path), "steps": state.step, "nodes": n,
            "edges": len(s), "device": str(dev),
            "layout": type(graph).__name__,
            "packed": getattr(graph, "s_pack", None) is not None,
            **{f"skill_{k}": v for k, v in skill.items()}}


def verify_skill(config: GwenConfig, model, fields: np.ndarray, coo_graph,
                 trained_graph, members: int, dev: torch.device, run=None,
                 draw=None) -> dict:
    """Skill of a generated ensemble against the held-out (last) member, as
    the reference's ``train_mesh`` computes it after training.

    A float32 skill model with the trained weights (the segment path on
    ``coo_graph``; attention keeps ``trained_graph``, the diag-window graph
    on ``dev``) generates ``members`` members over up to 4 steps from the
    held-out member's first state. ``train.calibrate_sigma`` picks the
    amplitude on the training members first, ``train.calibrate_inflation``
    the inflation on member 0. ``fields`` is ``(time, member, nodes,
    channels)`` in the model's node order. ``draw(seed, shape)`` gives the
    white noise of one draw; the default draws standard normals from a
    ``torch.Generator`` on ``dev`` seeded with ``seed``. The scores are
    logged on ``run`` as ``skill_*`` and returned."""
    from gwen_tpu_torch import ensemble
    from gwen_tpu_torch.nn import EncodeProcessDecode

    tcfg, processor = config.train, config.model.processor
    ch = fields.shape[-1]
    horizon = min(4, fields.shape[0] - 1)
    base = torch.from_numpy(np.ascontiguousarray(fields[0, -1])).to(dev)
    truth = torch.from_numpy(np.ascontiguousarray(fields[1: 1 + horizon, -1])).to(dev)

    skill_model = EncodeProcessDecode(
        ch, ch, device=dev,
        latent_size=config.model.latent_size,
        process_steps=config.model.process_steps,
        mlp_layers=config.model.mlp_layers,
        residual=config.model.residual,
        backend="segment" if processor != "attention" else "auto",
        processor=processor,
        attn_heads=config.model.attn_heads,
        attn_pack=config.model.attn_pack,
    )
    skill_model.load_state_dict(model.state_dict())
    skill_model.eval()
    graph = trained_graph if processor == "attention" else coo_graph.to(dev)

    def log_metric(name, value):
        if run is not None:
            run.log_metric(name, value)

    if draw is None:
        def draw(seed, shape):
            return torch.randn(shape, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(seed))

    member_shape = (members, *base.shape)
    sigma = tcfg.sigma
    if tcfg.calibrate_sigma and fields.shape[1] > 1:
        cal = ensemble.calibrate_sigma(
            skill_model, graph, fields[:, :-1], None, num_members=members,
            horizon=horizon,
            noise=draw(11, (len(ensemble.SIGMAS), fields.shape[1] - 1,
                            *member_shape)))
        sigma = cal["best_sigma"]
        log_metric("calibrated_sigma", sigma)
    gen = ensemble.generate_ensemble(
        skill_model, graph, base, None, num_members=members,
        num_steps=horizon, sigma=sigma, noise=draw(7, member_shape))
    inflation = tcfg.inflation
    if tcfg.calibrate_inflation and fields.shape[1] > 1:
        # Calibrate on a validation member (not the held-out one), then
        # apply to the held-out generation.
        vbase = torch.from_numpy(np.ascontiguousarray(fields[0, 0])).to(dev)
        vtruth = torch.from_numpy(
            np.ascontiguousarray(fields[1: 1 + horizon, 0])).to(dev)
        vgen = ensemble.generate_ensemble(
            skill_model, graph, vbase, None, num_members=members,
            num_steps=horizon, sigma=sigma, noise=draw(13, member_shape))
        inflation = ensemble.calibrate_inflation(vgen, vtruth, ensemble_axis=0)
        log_metric("calibrated_inflation", inflation)
    if inflation != 1.0:
        gen = ensemble.inflate_ensemble(gen, inflation, ensemble_axis=0)
    skill = ensemble.ensemble_skill(gen, truth, ensemble_axis=0)
    for k, v in skill.items():
        log_metric(f"skill_{k}", v)
    return skill
