"""Entry points that prove the port starts: counterparts of the
reference's ``entry()`` and ``dryrun_multichip(n)``.

:func:`entry` returns the flagship forward (the encode-process-decode GCN on
the diag-window layout of an L5 mesh in KD-patch order) with example
arguments. :func:`dryrun_multichip` runs ONE full training step (loss,
gradients summed over the ranks, Adam update) of a tiny model over a
``(data, graph)`` mesh of ``n`` ranks on the partitioned diag layout. Both
run on CUDA unless the caller asks for the CPU: ``n`` ranks then take ``n``
cards (NCCL), and on the CPU ``n`` gloo processes. Called inside ranks that
a launcher started (``RANK``/``WORLD_SIZE`` set), it uses those.

    python -m gwen_tpu_torch.dryrun [n] [--device cpu]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch


def entry(device="cuda"):
    """``(fn, example_args)``: the flagship forward on one device."""
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      kd_patch_order, to_diag_window)
    from gwen_tpu_torch.nn import EncodeProcessDecode

    verts, s, r = icosphere_edges(5)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n, leaf_size=512)
    s, r, _ = apply_order(perm, s, r)
    graph = to_diag_window(build_graph(s, r, n), window_size=384).to(device)
    model = EncodeProcessDecode(8, 8, device=device, latent_size=256,
                                process_steps=4)
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)).to(device)

    def fn(x):
        return model(graph, x)

    return fn, (x,)


def train_step_rank(device="cuda") -> float:
    """One partitioned training step on this rank of the default process
    group (one process: a 1 × 1 mesh), on ``device``: the card unless the
    caller asks for the CPU. Every rank builds the same tiny model, data and
    partition tables from fixed seeds. Returns the global loss; raises
    unless it is finite."""
    from gwen_tpu_torch.graph import apply_order, icosphere_edges, kd_patch_order
    from gwen_tpu_torch.nn import EncodeProcessDecode
    from gwen_tpu_torch.parallel import make_partitioned_apply, partition_graph
    from gwen_tpu_torch.train import (Trainer, TrainState, make_mesh,
                                      make_optimizer, partitioned_mesh_loss_fn)
    from gwen_tpu_torch.train.mesh import world_size

    n_ranks = world_size()
    graph_parts = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    mesh = make_mesh(data=n_ranks // graph_parts, graph=graph_parts)

    verts, s, r = icosphere_edges(3)  # 642 nodes, 768 padded on 1 or 2 parts
    n = verts.shape[0]
    # The production partitioned layout: KD-patch order, per-partition
    # diag-window tables (128-row blocks, as the kernels take them), the
    # boundary-skeleton escape all_gather.
    perm = kd_patch_order(verts, s, r, n, leaf_size=128)
    s, r, _ = apply_order(perm, s, r)
    pg = partition_graph(s, r, n, num_parts=graph_parts, block_size=128,
                         reorder=False, layout="diag", diag_window=128,
                         diag_superblock=1)
    channels = 4
    model = EncodeProcessDecode(channels, channels, device=device,
                                latent_size=32, process_steps=2,
                                generator=torch.Generator().manual_seed(0))
    apply_fn = make_partitioned_apply(model, pg, mesh, device)
    batch = max(mesh.data, 2)
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(pg.pad_nodes(
        rng.normal(size=(batch, n, channels)).astype(np.float32))).to(device)
        for _ in range(2))
    trainer = Trainer(partitioned_mesh_loss_fn(apply_fn, "l1"), device, mesh=mesh)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3))
    loss = float(trainer.train_step(state, (x, y)))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return loss


def _spawned(rank: int, n: int, device: str, store: str, out_dir: str) -> None:
    """Target of :func:`dryrun_multichip`'s spawn: rank ``rank`` of ``n``."""
    from gwen_tpu_torch.train.mesh import initialize_distributed

    torch.set_num_threads(1)
    dev = initialize_distributed(device, f"file://{store}", n, rank,
                                 timeout_s=120)
    try:
        loss = train_step_rank(dev)
        with open(os.path.join(out_dir, f"loss_{rank}"), "w") as f:
            f.write(repr(loss))
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(target, n: int, args: tuple = (), timeout_s: float = 300.0) -> None:
    """Run ``target(rank, n, *args)`` in ``n`` processes and wait for them,
    at most ``timeout_s`` seconds: on a failure or at the limit every child
    is killed and an error raised. ``target`` must be importable (it is
    pickled)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(target, args=(n, *args), nprocs=n, join=False,
                             start_method="spawn")
    import time
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks did not finish in {timeout_s:g} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()


def dryrun_multichip(n_ranks: int, device="cuda", timeout_s: float = 300.0) -> float:
    """One partitioned training step over a ``(data, graph)`` mesh of
    ``n_ranks`` ranks on ``device``: one CUDA card per rank (NCCL), or with
    ``device="cpu"`` gloo processes on the CPU. Raises without CUDA, or
    with fewer cards than ranks, unless the CPU was asked for. Inside
    launched ranks (``WORLD_SIZE`` set) it joins them; otherwise it spawns
    the ranks (a file store for the rendezvous) and waits with a time
    limit. Returns the loss, which every rank must report alike."""
    from gwen_tpu_torch.train.mesh import initialize_distributed

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: CUDA is not available; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        return train_step_rank(initialize_distributed(dev))
    if dev.type == "cuda" and n_ranks > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip: {n_ranks} ranks need {n_ranks} "
                           f"cards; this host has {torch.cuda.device_count()}")
    if n_ranks <= 1:
        return train_step_rank(dev)
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_spawned, n_ranks,
                    (dev.type, os.path.join(tmp, "store"), tmp), timeout_s)
        losses = [float(open(os.path.join(tmp, f"loss_{k}")).read())
                  for k in range(n_ranks)]
    if max(losses) - min(losses) > 1e-6 * max(abs(losses[0]), 1.0):
        raise AssertionError(f"ranks disagree on the loss: {losses}")
    return losses[0]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m gwen_tpu_torch.dryrun")
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="ranks of the partitioned step: by default every "
                         "card of the host, or 2 on the CPU")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.n is None:
        args.n = 2 if args.device == "cpu" else torch.cuda.device_count()
    fn, example = entry(args.device)
    print("entry OK:", tuple(fn(*example).shape))
    loss = dryrun_multichip(args.n, args.device)
    print(f"dryrun_multichip({args.n}) OK: loss {loss:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
