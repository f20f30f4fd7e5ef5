"""``python -m gwen_tpu_torch train-cnn``: the UNet CNN orchestrator.
Counterpart of ``gwen_tpu.cli.train_cnn.main``, same flow: load config and
data → two :class:`ConvEnsembleDataset` views (train, test), the channels
from the member split → the spatial variance mask (cells whose time
variance, averaged over members, exceeds ``train.mask_threshold``) →
:class:`UNet` from ``unet.hidden`` and ``unet.depth`` (fresh, or the
registry's best ``<experiment>_CNN`` model when ``train.retrain=false``) →
Adam at ``train.lr × 100`` → ``Trainer.fit`` → evaluation on the test split
→ optional per-target-member GIF animations.

The device is explicit: ``cuda`` by default, and asking for it where there
is none raises; ``--device cpu`` runs the same path on the CPU.

Precision: the model is float32, and its convs and matmuls run in float32
on the card too, as on the CPU (the reference's float32 convs, and what
the tests hold the port to). For the run, ``main`` clears
``torch.backends.cudnn.allow_tf32`` (torch's default lets cuDNN run
float32 convs in TF32, 10 bits of mantissa) and
``torch.backends.cuda.matmul.allow_tf32``, and restores both on return or
on an error, so an in-process caller keeps its own settings.
``cudnn.benchmark`` is left as the caller set it (off by default).

Data-parallel over processes, as the reference spreads each batch over the
data axis of its device mesh: under ``python -m torch.distributed.run
--nproc_per_node N -m gwen_tpu_torch train-cnn ...`` each process joins
the group (NCCL on CUDA, one card a process; gloo on the CPU), every rank
builds the same global batches (the same shuffle) and trains on its share
(``train.mesh.shard_batch``: ``x`` and ``y`` cut over the batch axis when
it divides by N, else kept whole), and the trainer sums the gradients and
the loss over the ranks, so every rank takes the same Adam step as one
process on the whole batch. Evaluation runs on batches of 1, which every
rank holds whole. The registry run, the checkpoints, the saved model, the
test-loss metric, the GIFs and the JSON line belong to rank 0. One process
starts no group and runs no collective.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch

from gwen_tpu_torch.config import GwenConfig
from gwen_tpu_torch.logging_utils import get_logger, setup_logger
from gwen_tpu_torch.registry import Registry, default_experiment

log = get_logger()


@contextlib.contextmanager
def float32_math():
    """Convs and matmuls in float32 (no TF32) inside the block; the caller's
    flags restored after it."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def main(config: GwenConfig, animate: bool = True, out_dir: str = "output",
         device: str = "cuda") -> dict:
    with float32_math():
        return _train(config, animate, out_dir, device)


def _train(config: GwenConfig, animate: bool, out_dir: str, device: str) -> dict:
    from gwen_tpu_torch.data.dataset import ConvEnsembleDataset, load_data
    from gwen_tpu_torch.nn.unet import UNet
    from gwen_tpu_torch.train import (
        Checkpointer,
        Trainer,
        TrainState,
        cnn_loss_fn,
        make_optimizer,
    )
    from gwen_tpu_torch.train import mesh as pmesh

    setup_logger()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train-cnn: CUDA is not available; pass --device cpu to train on "
            "the CPU")
    started_group = not torch.distributed.is_initialized()
    dev = pmesh.initialize_distributed(dev)
    mesh = pmesh.make_mesh(data=pmesh.world_size(), graph=1)
    main_rank = pmesh.is_main_process()
    train_np, test_np, meta = load_data(config.data)
    tcfg = config.train

    ds = ConvEnsembleDataset(data=train_np, member_split=tcfg.member_split,
                             seed=tcfg.seed, simplify=tcfg.simplify)
    ds_test = ConvEnsembleDataset(data=test_np, member_split=tcfg.member_split,
                                  seed=tcfg.seed, simplify=tcfg.simplify)
    ch_in, ch_out = len(ds.input_indices), len(ds.target_indices)

    spatial_mask = None
    if tcfg.mask_threshold > 0:
        # (height, ncells); ``[:]`` reads a lazy field whole.
        var = train_np[:].var(axis=0).mean(axis=0)
        spatial_mask = (var > tcfg.mask_threshold).astype(np.float32)

    model = UNet(ch_in, ch_out, device=dev, hidden=config.unet.hidden,
                 depth=config.unet.depth,
                 generator=torch.Generator().manual_seed(tcfg.seed))
    registry = Registry(config.run.registry_root)
    experiment = (config.run.experiment or default_experiment()) + "_CNN"

    if not tcfg.retrain:
        params, _ = registry.load_best_model(
            experiment, params_template=model.state_dict())
        model.load_state_dict(params)
        log.info("loaded best model from registry (retrain=false)")

    opt = make_optimizer(
        model.parameters(),
        tcfg.lr * 100.0,
        weight_decay=tcfg.weight_decay,
        scheduler=tcfg.scheduler,
        warmup_steps=tcfg.warmup_steps,
        cycle_steps=tcfg.cycle_steps,
        grad_clip=tcfg.grad_clip,
    )
    state = TrainState(model=model, optimizer=opt)

    run = ckpt = None
    if main_rank:
        run = registry.create_run(experiment, config.to_dict(), config.run.run_name)
        ckpt = Checkpointer(
            Path(config.run.registry_root) / "checkpoints" / run.run_id,
            max_to_keep=tcfg.max_checkpoints)
    trainer = Trainer(cnn_loss_fn(model, spatial_mask=spatial_mask, mesh=mesh),
                      dev, run=run, checkpointer=ckpt, log_every=tcfg.log_every,
                      mesh=mesh)

    def share(batches):
        return (pmesh.shard_batch(mesh, b) for b in batches)

    best = float("inf")
    if tcfg.retrain:
        def batches(ep):
            return share(ds.batches(tcfg.batch_size, shuffle=True, seed=ep))
        state, best = trainer.fit(
            state, batches, tcfg.epochs, checkpoint_every=tcfg.checkpoint_every
        )
        if main_rank:
            run.save_model(model.state_dict(),
                           {"hidden": config.unet.hidden,
                            "depth": config.unet.depth,
                            "channels_in": ch_in, "channels_out": ch_out},
                           best_metric=best)

    test_loss, preds = trainer.evaluate(model, share(ds_test.batches(1)))
    log.info("test loss: %.6f", test_loss)
    result = {"test_loss": test_loss, "best_train_loss": best,
              "run_id": run.run_id if main_rank else None, "device": str(dev),
              "world": mesh.world}
    if main_rank:
        run.log_metric("test_loss", test_loss)
        run.finish()
    if main_rank and animate and preds is not None:
        from gwen_tpu_torch import viz

        members = meta.get("members") or [str(i) for i in range(train_np.shape[1])]
        targets = [members[i] for i in ds_test.target_indices]
        paths = viz.animate_predictions(preds, targets, out_dir, label="CNN")
        result["animations"] = [str(p) for p in paths]
    pmesh.finish_distributed(started_group)
    return result
