"""``python -m gwen_tpu_torch train-mesh``: mesh-scale next-step training of
the encode-process-decode model (GCN or attention processor) on one
device.

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
The device is explicit: asking for ``cuda`` where there is none raises.

Not ported yet, each refused with a ``ValueError``: the skill verification
of generated ensembles after training (it needs the ensemble code of
slice 4; the run ends after ``save_model``), ``train.rollout_horizon > 1``,
``train.loss="crps-ensemble"``, the partitioned path and ``--data`` input.
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
    tcfg, mesh = config.train, config.mesh
    waits = [
        (tcfg.rollout_horizon > 1, "train.rollout_horizon > 1 (rollout "
         "training) comes with a later slice of the port"),
        (tcfg.loss == "crps-ensemble", "train.loss='crps-ensemble' comes "
         "with slice 4 of the port"),
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
        make_optimizer,
        mesh_graph_loss_fn,
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
    state, best = trainer.fit(
        state, lambda ep: ds.batches(tcfg.batch_size, shuffle=True, seed=ep),
        tcfg.epochs, checkpoint_every=tcfg.checkpoint_every)
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
    log.info("skill verification is not computed: it needs the ensemble "
             "code of slice 4 of the port")
    run.finish()
    log.info("mesh training done: best=%.5f steps=%d", best, state.step)
    return {"best_train_loss": best, "run_id": run.run_id,
            "run_dir": str(run.path), "steps": state.step, "nodes": n,
            "edges": len(s), "device": str(dev),
            "layout": type(graph).__name__,
            "packed": getattr(graph, "s_pack", None) is not None}
