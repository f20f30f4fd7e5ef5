"""Replay described partitioned steps on the ranks of a process group and
keep what each rank computed: the harness of ``test_torch_parallel.py``
(this file holds no test of its own).

A *case* is a plain dict (saved with ``torch.save``): an ordered edge list,
``partition_graph`` options, model options and a state dict, a mesh shape, a
task and one global batch. :func:`run_case` runs it on the calling rank:
the rank's predictions, the global loss, the summed gradients and the
parameters after one Adam step; with ``crop`` also the loss and gradients
of the mean over the real nodes only (what an unpartitioned model
computes, which has no pad rows). A case with ``cli`` runs the CLI with
those arguments instead (``train-mesh``, ``train-gnn``, ``train-cnn``) and
keeps rank 0's JSON line and the handlers of the rank's package logger;
with ``init`` (``(module, class name, state dict)``) every model that class
builds during the run starts from that state (the reference's initial
parameters, converted).
:func:`replay_rank` is the target for
:func:`gwen_tpu_torch.dryrun.spawn_ranks` (importable by the spawned
processes: they inherit ``sys.path`` with this directory on it): it joins a
gloo group through a file store, runs every case of a file in the output
directory (where the logger's file lands) and writes ``rank_<k>.pt``.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os

import torch

from gwen_tpu_torch.nn import EncodeProcessDecode
from gwen_tpu_torch.parallel.apply import make_partitioned_apply
from gwen_tpu_torch.parallel.partition import partition_graph
from gwen_tpu_torch.train import (
    make_mesh,
    make_optimizer,
    partitioned_ensemble_crps_loss_fn,
    partitioned_mesh_loss_fn,
    partitioned_rollout_loss_fn,
)


def _grads(model) -> dict:
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


@contextlib.contextmanager
def initial_state(module: str, name: str, state: dict):
    """While inside, every instance of ``module.name`` built starts from
    ``state``."""
    mod = importlib.import_module(module)
    cls = getattr(mod, name)

    def build(*args, **kwargs):
        model = cls(*args, **kwargs)
        model.load_state_dict(state)
        return model

    setattr(mod, name, build)
    try:
        yield
    finally:
        setattr(mod, name, cls)


def _run_cli(argv: list, init=None) -> dict:
    from gwen_tpu_torch.cli.main import main as cli
    from gwen_tpu_torch.logging_utils import get_logger
    from gwen_tpu_torch.train.mesh import is_main_process

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), (
            initial_state(*init) if init else contextlib.nullcontext()):
        rc = cli(argv)
    lines = buf.getvalue().strip().splitlines()
    return {"rc": rc, "main": is_main_process(),
            "json": json.loads(lines[-1]) if lines else None,
            "handlers": [type(h).__name__ for h in get_logger().handlers]}


def run_case(case: dict, device="cpu") -> dict:
    """Run one case on this rank of the default process group (see the
    module docstring); every rank of the group must call it."""
    if "cli" in case:
        return _run_cli(case["cli"], case.get("init"))
    mesh = make_mesh(data=case["data"], graph=case["graph"])
    pg = partition_graph(case["s"], case["r"], case["n"], num_parts=mesh.graph,
                         reorder=False, **case["partition"])
    model = EncodeProcessDecode(device=device, **case["model"])
    model.load_state_dict(case["state"])
    apply_fn = make_partitioned_apply(
        model, pg, mesh, device,
        transpose_tables=case["model"].get("processor") == "attention")
    batch = tuple(t.to(device) for t in case["batch"])
    task = case["task"]
    context = None
    if task == "rollout":
        loss_fn = partitioned_rollout_loss_fn(apply_fn, case["horizon"])
    elif task == "crps":
        from gwen_tpu_torch.graph import build_graph

        loss_fn = partitioned_ensemble_crps_loss_fn(
            apply_fn, num_members=case["members"], sigma=case["sigma"])
        context = build_graph(case["s"], case["r"], pg.padded_nodes).to(device)
    else:
        loss_fn = partitioned_mesh_loss_fn(apply_fn, task)
    out = {"coords": (mesh.data_index, mesh.graph_index), "n_local": pg.n_local}

    if case.get("crop"):
        # The mean over the real nodes only: each rank sums its real rows
        # and divides by the global count.
        x, y = apply_fn.shard(batch[:2])
        preds = apply_fn(x)
        row = mesh.graph_index * pg.n_local + torch.arange(pg.n_local, device=device)
        real = (row < case["n"]).to(preds.dtype)[:, None]
        count = batch[0].shape[0] * case["n"] * preds.shape[-1]
        loss = (((preds - y) ** 2) * real).sum() / count
        loss.backward()
        mesh.all_reduce_gradients(model.parameters())
        out["crop_loss"] = float(mesh.all_reduce_sum(loss.detach()))
        out["crop_grads"] = _grads(model)
        model.zero_grad(set_to_none=True)

    loss, preds = loss_fn(batch) if context is None else loss_fn(batch, context)
    loss.backward()
    mesh.all_reduce_gradients(model.parameters())
    out["loss"] = float(mesh.all_reduce_sum(loss.detach()))
    out["preds"] = preds.detach().clone()
    out["grads"] = _grads(model)
    make_optimizer(model.parameters(), case.get("lr", 1e-3)).step(model.parameters())
    out["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
    return out


def gather_preds(results: list, name: str) -> torch.Tensor:
    """The global predictions of case ``name`` from every rank's results:
    node chunks joined along the node axis, data shards along the batch."""
    by = {res[name]["coords"]: res[name]["preds"] for res in results}
    data = 1 + max(d for d, _ in by)
    graph = 1 + max(g for _, g in by)
    return torch.cat([torch.cat([by[d, g] for g in range(graph)], dim=-2)
                      for d in range(data)], dim=0)


def replay_rank(rank: int, n: int, store: str, case_path: str, out_dir: str) -> None:
    """Rank ``rank`` of ``n`` gloo ranks on the CPU: run every case of the
    file ``case_path`` (a dict name → case) and write ``rank_<rank>.pt``."""
    from gwen_tpu_torch.train.mesh import initialize_distributed

    torch.set_num_threads(1)
    os.chdir(out_dir)
    initialize_distributed("cpu", f"file://{store}", n, rank, timeout_s=180)
    try:
        cases = torch.load(case_path, weights_only=False)
        results = {name: run_case(case) for name, case in cases.items()}
        torch.save(results, os.path.join(out_dir, f"rank_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
