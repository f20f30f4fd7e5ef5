"""``python -m gwen_tpu_torch train-mesh``: mesh-scale training of the
encode-process-decode model (GCN, attention or interaction processor) on
one device or, partitioned, on one process per device, followed by the
skill verification of a generated ensemble.

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

The partitioned path (``mesh.graph_axis > 1`` over that many ranks, or
``mesh.force_partition=true``): one process per rank, started with
``python -m torch.distributed.run`` (NCCL on CUDA, gloo on the CPU); the
ranks form a ``(data, graph)`` mesh with ``graph_parts = min(mesh.graph_axis,
world)``. Nodes take the KD-patch order for ``mesh.partition_layout=diag``
(kernels B1/B4, escapes through an ``all_gather`` and B3/B10), else RCM
(``sliding``: B3/B10; ``dense``: B11; ``ell``: B12); attention needs
``diag``. Every rank builds the same data, model and partition tables from
the seed, keeps its slice, and computes its share of each global batch;
gradients and the reported loss are summed over the ranks. The registry,
the checkpoints, the skill verification (on the global graph; attention: the
global diag layout rebuilt at the partition's padded size) and the JSON
line belong to rank 0.

``--data store.zarr`` trains on a mesh-ensemble store
(:mod:`gwen_tpu_torch.data.meshstore`, as ``make-mesh-data`` writes one)
instead of the synthetic ensemble, on the global and the partitioned path:
the fields and the graph come from the store, ``members`` is the store's
member count, and the store's path is recorded in the run's metadata
(``data``), from which a serving artifact rebuilds its graph. With
``data.lazy=true`` the fields stay on disk: the node reorder (and the
partition's padding) composes onto each time step as it is read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gwen_tpu_torch.config import GwenConfig
from gwen_tpu_torch.logging_utils import get_logger
from gwen_tpu_torch.registry import Registry, default_experiment

log = get_logger()


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
    from gwen_tpu_torch.train import mesh as pmesh

    started_group = not torch.distributed.is_initialized()
    dev = pmesh.initialize_distributed(resolve_device(device))
    world = pmesh.world_size()
    main_rank = pmesh.is_main_process()
    tcfg = config.train
    levels = config.graph.refine
    processor = config.model.processor
    layout = config.mesh.partition_layout
    graph_parts = min(config.mesh.graph_axis, world)
    use_partition = ((graph_parts > 1 or config.mesh.force_partition)
                     and world % graph_parts == 0)
    if world > 1 and not use_partition:
        raise ValueError(
            f"{world} processes but no partitioned run: set mesh.graph_axis "
            "(or mesh.force_partition=true for data parallelism alone) to a "
            "divisor of the process count")
    if processor == "attention" and use_partition and layout != "diag":
        raise ValueError(
            "model.processor='attention' on the partitioned path requires "
            f"mesh.partition_layout='diag'; got {layout!r}")

    lazy = bool(data) and config.data.lazy
    if data:
        from gwen_tpu_torch.data.meshstore import load_mesh_dataset

        fields, s, r, verts, _ = load_mesh_dataset(data, lazy=lazy)
        members = fields.shape[1]
    else:
        fields, verts, s, r = mesh_ensemble_dataset(
            levels=levels, members=members, steps=steps, seed=tcfg.seed)
    n = fields.shape[2]
    kernel = config.mesh.kernel
    use_diag = diag_path(dev, kernel, processor) and not use_partition
    kd = use_diag or (use_partition and layout == "diag")
    perm = kd_patch_order(np.asarray(verts), s, r, n) if kd else rcm_order(s, r, n)
    s2, r2, _ = apply_order(perm, s, r)
    if lazy:
        # Streaming: the node reorder composes onto each step read; the
        # archive never lies in host memory whole.
        fields = fields.map(lambda step: np.take(step, perm, axis=1))
    else:
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
    mean_loss = tcfg.loss if tcfg.loss in ("mse", "l1") else "mse"
    mesh = None
    if use_partition:
        graph, loss_fn, mesh, pg = _partitioned_task(
            config, model, s2, r2, n, graph_parts, world, dev, compute_dtype,
            mean_loss)
        fields = (fields.map(lambda step: pg.pad_nodes(step, node_axis=-2))
                  if lazy else pg.pad_nodes(fields))
        # The apply holds the rank's graph; the CRPS task's context is the
        # replicated noise graph over the padded node space.
        context = (build_graph(s2, r2, fields.shape[2])
                   if tcfg.loss == "crps-ensemble" and tcfg.rollout_horizon <= 1
                   else None)
    else:
        if use_diag:
            graph = to_diag_window(g, window_size=config.mesh.diag_window,
                                   dtype=compute_dtype,
                                   transpose_tables=processor == "attention",
                                   packed=kernel == "diag_packed")
        elif dev.type == "cuda" and kernel != "segment" and processor == "gcn":
            graph = banded_layout(g, s2, r2, kernel, compute_dtype)
        else:
            graph = g
        context = graph
        if tcfg.rollout_horizon > 1:
            loss_fn = rollout_loss_fn(model, tcfg.rollout_horizon)
        elif tcfg.loss == "crps-ensemble":
            loss_fn = ensemble_crps_loss_fn(
                model, num_members=tcfg.crps_members, sigma=tcfg.sigma)
        else:
            loss_fn = mesh_graph_loss_fn(model, loss=mean_loss)

    # Train on all members except the last (held out for skill verification).
    ds = MeshEnsembleDataset(
        fields=fields.map(lambda step: step[:-1]) if lazy else fields[:, :-1])
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

    # The registry, the checkpoints and the JSON line belong to rank 0.
    run = ckpt = None
    if main_rank:
        registry = Registry(config.run.registry_root)
        experiment = (config.run.experiment or default_experiment()) + "_MESH"
        run = registry.create_run(experiment, config.to_dict(),
                                  config.run.run_name)
        ckpt = Checkpointer(
            Path(config.run.registry_root) / "checkpoints" / run.run_id,
            max_to_keep=tcfg.max_checkpoints,
        )
    trainer = Trainer(loss_fn, dev, run=run, checkpointer=ckpt,
                      log_every=tcfg.log_every, context=context, mesh=mesh)
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
    out = {"best_train_loss": best, "steps": state.step, "nodes": n,
           "edges": len(s), "device": str(dev),
           "layout": type(graph).__name__,
           "packed": getattr(graph, "s_pack", None) is not None}
    if use_partition:
        out.update(partition_layout=layout, graph_parts=graph_parts,
                   world=world)
    if main_rank:
        real = (fields.map(lambda step: step[:, :n]) if lazy
                else fields[:, :, :n])
        out.update(_finish_run(config, run, model, real, g,
                               trainer.context, members, dev, best,
                               state.step, data,
                               pg.padded_nodes if use_partition else None))
    pmesh.finish_distributed(started_group)
    return out


def _partitioned_task(config: GwenConfig, model, s2, r2, n: int,
                      graph_parts: int, world: int, dev, compute_dtype,
                      mean_loss: str):
    """The partitioned branch: the process mesh, the partition tables, this
    rank's apply and the task's loss over it. Returns ``(rank's graph,
    loss_fn, mesh, partitioned graph)``."""
    from gwen_tpu_torch.parallel import make_partitioned_apply, partition_graph
    from gwen_tpu_torch.train import (
        make_mesh,
        partitioned_ensemble_crps_loss_fn,
        partitioned_mesh_loss_fn,
        partitioned_rollout_loss_fn,
    )

    tcfg = config.train
    mesh = make_mesh(data=world // graph_parts, graph=graph_parts)
    if tcfg.batch_size % mesh.data:
        raise ValueError(
            f"train.batch_size = {tcfg.batch_size} must divide over the data "
            f"mesh axis ({mesh.data}) on the partitioned path (for "
            "CRPS-ensemble training too: a sample's members stay on one rank)")
    pg = partition_graph(
        s2, r2, n, num_parts=graph_parts, reorder=False,
        layout=config.mesh.partition_layout, s_dtype=compute_dtype,
        diag_window=config.mesh.diag_window)
    apply_fn = make_partitioned_apply(
        model, pg, mesh, dev,
        transpose_tables=config.model.processor == "attention")
    if tcfg.rollout_horizon > 1:
        loss_fn = partitioned_rollout_loss_fn(apply_fn, tcfg.rollout_horizon,
                                              loss=mean_loss)
    elif tcfg.loss == "crps-ensemble":
        loss_fn = partitioned_ensemble_crps_loss_fn(
            apply_fn, num_members=tcfg.crps_members, sigma=tcfg.sigma)
    else:
        loss_fn = partitioned_mesh_loss_fn(apply_fn, loss=mean_loss)
    return apply_fn.graph, loss_fn, mesh, pg


def _finish_run(config: GwenConfig, run, model, fields: np.ndarray, g,
                trained_graph, members: int, dev, best: float, steps: int,
                data: str, padded_nodes: "int | None") -> dict:
    """Rank 0's end of a run: save the model, verify the skill, close the
    run. ``fields`` holds the real nodes only; ``trained_graph`` is the
    trainer's graph on ``dev`` (read for attention only). ``padded_nodes``
    is set on the partitioned path, whose attention skill model needs the
    global diag layout at the partition's padded size (the same window
    mask) instead."""
    from gwen_tpu_torch.graph import to_diag_window

    processor = config.model.processor
    n, ch = fields.shape[2], fields.shape[-1]
    compute_dtype = (torch.bfloat16 if config.model.compute_dtype == "bfloat16"
                     else torch.float32)
    run.save_model(
        model.state_dict(),
        {"latent_size": config.model.latent_size,
         "process_steps": config.model.process_steps,
         "channels": ch, "levels": config.graph.refine,
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
    if processor == "attention" and padded_nodes is not None:
        trained_graph = to_diag_window(
            g, window_size=config.mesh.diag_window, dtype=compute_dtype,
            n_pad=padded_nodes, transpose_tables=True).to(dev)
    skill = verify_skill(config, model, fields, g, trained_graph, members, dev,
                         run)
    run.finish()
    log.info("mesh training done: best=%.5f steps=%d skill=%s", best, steps,
             skill)
    return {"run_id": run.run_id, "run_dir": str(run.path),
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
