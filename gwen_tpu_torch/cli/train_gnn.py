"""``python -m gwen_tpu_torch train-gnn``: the member-graph GNN
orchestrator. Counterpart of ``gwen_tpu.cli.train_gnn.main``, same flow:
load config and data → two :class:`MemberGraphDataset` views (train, test)
→ the member graph (``erdos_renyi_edges`` at ``graph.edge_prob``, fully
connected at 1, GCN-normalized and densified: ``adj @ x``) → the streaming
spatial variance mask → :class:`GCNStack` (fresh, or the registry's best
model when ``train.retrain=false``) → ``Trainer.fit`` → evaluation on the
test split → optional per-target-member GIF animations.

The device is explicit: ``cuda`` by default, and asking for it where there
is none raises; ``--device cpu`` runs the same path on the CPU.

Data-parallel over processes, as the reference spreads each batch over the
data axis of its device mesh: under ``python -m torch.distributed.run
--nproc_per_node N -m gwen_tpu_torch train-gnn ...`` each process joins
the group (NCCL on CUDA, one card a process; gloo on the CPU), every rank
builds the same global batches (the same shuffle) and trains on its share
(``train.mesh.shard_batch``: ``x`` cut over the batch axis when it divides
by N, else kept whole; the member mask never cut), and the
trainer sums the gradients and the loss over the ranks, so every rank takes
the same Adam step as one process on the whole batch. Evaluation runs on
batches of 1, which every rank holds whole. The registry run, the
checkpoints, the saved model, the test-loss metric, the GIFs and the JSON
line belong to rank 0. One process starts no group and runs no collective.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gwen_tpu_torch.config import GwenConfig
from gwen_tpu_torch.logging_utils import get_logger, setup_logger
from gwen_tpu_torch.registry import Registry, default_experiment

log = get_logger()


def main(config: GwenConfig, animate: bool = True, out_dir: str = "output",
         device: str = "cuda") -> dict:
    from gwen_tpu_torch.data.dataset import MemberGraphDataset, load_data
    from gwen_tpu_torch.graph import build_graph, erdos_renyi_edges, to_dense
    from gwen_tpu_torch.nn import GCNStack
    from gwen_tpu_torch.train import (
        Checkpointer,
        Trainer,
        TrainState,
        gnn_loss_fn,
        make_optimizer,
    )
    from gwen_tpu_torch.train import mesh as pmesh

    setup_logger()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train-gnn: CUDA is not available; pass --device cpu to train on "
            "the CPU")
    started_group = not torch.distributed.is_initialized()
    dev = pmesh.initialize_distributed(dev)
    mesh = pmesh.make_mesh(data=pmesh.world_size(), graph=1)
    main_rank = pmesh.is_main_process()
    train_np, test_np, meta = load_data(config.data)
    tcfg = config.train

    ds = MemberGraphDataset(
        data=train_np, member_split=tcfg.member_split,
        seed=tcfg.seed, simplify=tcfg.simplify,
    )
    ds_test = MemberGraphDataset(
        data=test_np, member_split=tcfg.member_split,
        seed=tcfg.seed, simplify=tcfg.simplify,
    )

    # Member graph: fully connected by default, densified.
    s, r = erdos_renyi_edges(ds.num_nodes, config.graph.edge_prob, seed=tcfg.seed)
    graph = to_dense(build_graph(s, r, ds.num_nodes,
                                 self_loops=config.graph.self_loops)).to(dev)

    # Spatial variance mask, as a streaming per-cell time variance so it
    # works for lazy (chunked) fields too.
    feat_mask = None
    if tcfg.mask_threshold > 0:
        t_len = train_np.shape[0]
        s1 = np.zeros(train_np.shape[1:], np.float64)
        s2 = np.zeros_like(s1)
        for t in range(t_len):
            step = np.asarray(train_np[t], np.float64)  # (member, h, c)
            s1 += step
            s2 += step * step
        var = s2 / t_len - (s1 / t_len) ** 2
        fm = (var > tcfg.mask_threshold).reshape(ds.num_nodes, -1)
        feat_mask = fm.max(axis=0).astype(np.float32)  # over members → per-feature

    model = GCNStack(
        ds.num_features, ds.num_features, device=dev,
        hidden_feats=config.model.hidden_feats,
        generator=torch.Generator().manual_seed(tcfg.seed),
    )
    registry = Registry(config.run.registry_root)
    experiment = config.run.experiment or default_experiment()

    if not tcfg.retrain:
        params, _ = registry.load_best_model(experiment)
        model.load_state_dict(params)
        log.info("loaded best model from registry (retrain=false)")

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

    run = ckpt = None
    if main_rank:
        run = registry.create_run(experiment, config.to_dict(), config.run.run_name)
        ckpt = Checkpointer(
            Path(config.run.registry_root) / "checkpoints" / run.run_id,
            max_to_keep=tcfg.max_checkpoints)
    trainer = Trainer(
        gnn_loss_fn(model, graph, loss=tcfg.loss, mask_threshold_mask=feat_mask,
                    var_reg_alpha=tcfg.var_reg_alpha, mesh=mesh),
        dev, run=run, checkpointer=ckpt, log_every=tcfg.log_every, mesh=mesh,
    )

    def share(batches):
        """This rank's share of each global batch (the member mask whole)."""
        return (pmesh.shard_batch(mesh, {"x": x, "mask": m}, replicated=("mask",))
                for x, m in batches)

    best = float("inf")
    if tcfg.retrain:
        def batches(ep):
            return share(ds.batches(tcfg.batch_size, shuffle=True, seed=ep,
                                    node_batch_size=tcfg.node_batch_size))
        state, best = trainer.fit(
            state, batches, tcfg.epochs, checkpoint_every=tcfg.checkpoint_every
        )
        if main_rank:
            run.save_model(model.state_dict(),
                           {"hidden_feats": config.model.hidden_feats,
                            "channels": ds.num_features},
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

        _, m_, h, c = test_np.shape
        preds4 = preds.reshape(preds.shape[0], m_, h, c)
        members = meta.get("members") or [str(i) for i in range(m_)]
        targets = [members[i] for i in ds_test.target_indices]
        paths = viz.animate_predictions(
            preds4[:, ds_test.target_indices], targets, out_dir, label="GNN"
        )
        paths += viz.animate_predictions(
            np.asarray(test_np[:, ds_test.target_indices]), targets, out_dir,
            label="ICON"
        )
        result["animations"] = [str(p) for p in paths]
    pmesh.finish_distributed(started_group)
    return result
