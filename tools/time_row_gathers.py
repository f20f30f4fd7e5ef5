"""Times the row-gather SpMM kernels of ``gwen_tpu_torch`` on one NVIDIA GPU
at the L7 shapes ``chip_smoke.py`` gives them, and holds each against its
plain PyTorch version first.

    python3 tools/time_row_gathers.py [--root DIR] [--tag NAME] [--iters N]

With one item: B1 and packed B1 (bf16, F 256, with and without their escape
fix rows), B1 on a float32 one-channel field (F 4) over the bf16 S,
``diag_matvec``'s B1 on a runtime S with the window mask's pattern (the
attention probabilities) at f 128 and 256, B13 and B11 (RCM order, F 256),
B3 on the esc2 contraction, and the int8 rank-1 composite
(``spmm_sliding_rank1`` on the RCM band, unbatched and at batch 4, held to
its own checkout's plain version on the same bf16 path). Then, for
comparison, the batch-4 forms that share the kernels' source (B4, packed
B4, B10, B13, B11), and the two row gathers launched directly with one
item on B1's and packed B1's operands
(``_launch_streamed``, ``_launch_packed_rows``: the same call as B1 where B1
takes the gathers). ``--root`` imports ``gwen_tpu_torch`` from another
checkout (say the parent commit unpacked with ``git archive``), so that
two versions can be timed in turns, in separate processes, in one session
on one card. Prints the card
(``nvidia-smi`` name and power limit), the compiler's register lines, and
one JSON line of times in ms (CUDA events, the mean of ``--iters`` calls
after 3 warm-up calls; B3 on the esc2 graph also by its device kernels
under ``torch.profiler``). Needs numpy and torch; imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

LEVELS, WINDOW, F, BATCH = 7, 384, 256, 4


def cuda_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """The device kernels' time of one ``fn()`` under ``torch.profiler``
    (the mean of ``iters`` calls after 3 warm-up calls): for a kernel
    shorter than the host's enqueue of a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA) / iters / 1e3


def held(torch, name: str, got, want) -> float:
    """max|got − want| ≤ 1e-2·max|want| (bf16) or 1e-5·max|want| (float32)."""
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    tol = (1e-2 if got.dtype == torch.bfloat16 else 1e-5) * ref
    print(f"  {name}: max|err| {err:.4g} of max|plain| {ref:.4g} "
          f"{'ok' if err <= tol else 'FAIL'}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: the kernel disagrees with its plain version")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout to import gwen_tpu_torch from")
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_row_gathers: CUDA is not available", file=sys.stderr)
        return 1
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      kd_patch_order, rcm_order, to_diag_window,
                                      to_sliding_packed, to_sliding_rank1,
                                      to_windowed_dense, window_mask)
    from gwen_tpu_torch.ops import spmm_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"{args.tag}: {spmm_cuda.__file__} on {smi}", flush=True)
    _, ptxas = spmm_cuda.build()
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    s2, r2, _ = apply_order(kd_patch_order(verts, s, r, n), s, r)
    g = build_graph(s2, r2, n)
    dg = to_diag_window(g, window_size=WINDOW, dtype=torch.bfloat16).to(dev)
    pg = to_diag_window(g, window_size=WINDOW, dtype=torch.bfloat16,
                        packed=True).to(dev)
    s3, r3, _ = apply_order(rcm_order(s, r, n), s, r)
    g3 = build_graph(s3, r3, n)
    sp = to_sliding_packed(g3).to(dev)
    wd = to_windowed_dense(g3).to(dev)
    wd16 = dataclasses.replace(wd, s_mat=wd.s_mat.bfloat16())
    r1 = to_sliding_rank1(g3).to(dev)
    g2 = dg.esc2_graph

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    d32 = dataclasses.replace(dg, s_mat=dg.s_mat.float())
    p32 = dataclasses.replace(pg, r1_col=pg.r1_col.bfloat16().float(),
                              r1_row=pg.r1_row.bfloat16().float())
    s32 = dataclasses.replace(sp, col_scale=sp.col_scale.bfloat16().float(),
                              row_scale=sp.row_scale.bfloat16().float())
    u, n_pad = dg.escape.rows.shape[0], dg.num_padded_nodes
    x, fix = randn(n_pad, F), randn(u, F)
    x1 = randn(n_pad, 4, dtype=torch.float32)
    fix1 = randn(u, 4, dtype=torch.float32)
    xb, fixb = randn(BATCH, n_pad, F), randn(BATCH, u, F)
    xr, xrb = randn(n, F), randn(BATCH, n, F)
    x2, x2b = randn(g2.num_nodes, F), randn(BATCH, g2.num_nodes, F)
    mask = window_mask(dg)
    p_mat = {f: (torch.rand(n_pad, WINDOW, generator=gen, device=dev) * mask
                 ).bfloat16() for f in (128, 256)}
    xm = {f: randn(n, f) for f in (128, 256)}

    # name: (kernel, plain version on float32 copies, or None: a control
    # already held by chip_smoke.py)
    calls = {
        "B1": (lambda: spmm_cuda.diag_window_spmm(dg, x, fix),
               lambda: spmm_cuda.diag_window_spmm_plain(d32, x.float(), fix.float())),
        "B1 no fix rows": (lambda: spmm_cuda.diag_window_spmm(dg, x),
                           lambda: spmm_cuda.diag_window_spmm_plain(d32, x.float(), None)),
        "B1 float32 F 4 on the bf16 S": (
            lambda: spmm_cuda.diag_window_spmm(dg, x1, fix1),
            lambda: spmm_cuda.diag_window_spmm_plain(d32, x1, fix1)),
        "B1p": (lambda: spmm_cuda.diag_window_spmm_packed(pg, x, fix),
                lambda: spmm_cuda.diag_window_spmm_packed_plain(p32, x.float(), fix.float())),
        "B1p no fix rows": (
            lambda: spmm_cuda.diag_window_spmm_packed(pg, x),
            lambda: spmm_cuda.diag_window_spmm_packed_plain(p32, x.float(), None)),
        **{f"diag_matvec B1 f {f}": (
            lambda f=f: spmm_cuda.window_matvec(p_mat[f], dg, xm[f]),
            lambda f=f: spmm_cuda.window_spmm_plain(
                p_mat[f].float(), dg.window_start, xm[f].float(), dg.num_src_rows))
           for f in (128, 256)},
        "B13 unbatched": (lambda: spmm_cuda.sliding_packed_spmm(sp, xr),
                          lambda: spmm_cuda.sliding_packed_spmm_plain(s32, xr.float())),
        "B11 unbatched, bf16 S": (
            lambda: spmm_cuda.windowed_dense_spmm(wd16, xr),
            lambda: spmm_cuda.windowed_dense_spmm_plain(wd, xr.float())),
        "B11 unbatched, float32 S": (
            lambda: spmm_cuda.windowed_dense_spmm(wd, xr),
            lambda: spmm_cuda.windowed_dense_spmm_plain(wd, xr.float())),
        "dense gather, B1's operands": (
            lambda: spmm_cuda._launch_streamed(dg.s_mat, dg.window_start,
                                               dg.block_size, x, dg.esc_ptr,
                                               dg.escape.rows, fix),
            lambda: spmm_cuda.diag_window_spmm_plain(d32, x.float(), fix.float())),
        "bit gather, packed B1's operands": (
            lambda: spmm_cuda._launch_packed_rows(
                pg.s_pack, pg.r1_col, pg.r1_row, pg.window_start, pg.block_size,
                pg.num_src_rows, x, pg.esc_ptr, pg.escape.rows, fix),
            lambda: spmm_cuda.diag_window_spmm_packed_plain(p32, x.float(),
                                                            fix.float())),
        "B3 esc2": (lambda: spmm_cuda.sliding_spmm(g2, x2),
                    lambda: spmm_cuda.sliding_spmm_plain(
                        dataclasses.replace(g2, s_mat=g2.s_mat.float()), x2.float())),
        "int8 rank-1 composite, B3 form": (
            lambda: spmm_cuda.spmm_sliding_rank1(r1, xr),
            lambda: spmm_cuda.spmm_sliding_rank1(r1, xr, plain=True)),
        "int8 rank-1 composite, B10 form batch 4": (
            lambda: spmm_cuda.spmm_sliding_rank1(r1, xrb),
            lambda: spmm_cuda.spmm_sliding_rank1(r1, xrb, plain=True)),
        "B4 batch 4": (lambda: spmm_cuda.diag_window_spmm_b(dg, xb, fixb), None),
        "B4p batch 4": (lambda: spmm_cuda.diag_window_spmm_packed_b(pg, xb, fixb), None),
        "B10 esc2 batch 4": (lambda: spmm_cuda.sliding_spmm_b(g2, x2b), None),
        "B13 batch 4": (lambda: spmm_cuda.sliding_packed_spmm(sp, xrb), None),
        "B11 batch 4, bf16 S": (lambda: spmm_cuda.windowed_dense_spmm(wd16, xrb), None),
    }
    times = {}
    for name, (kernel, plain) in calls.items():
        if plain is not None:
            held(torch, name, kernel(), plain())
        times[name] = cuda_ms(torch, kernel, args.iters)
        print(f"  {name}: {times[name]:.4f} ms", flush=True)
    # B3 on the esc2 graph is shorter than the host's enqueue of a call.
    name = "B3 esc2, device kernels (profiler)"
    times[name] = device_ms(torch, lambda: spmm_cuda.sliding_spmm(g2, x2), args.iters)
    print(f"  {name}: {times[name]:.4f} ms", flush=True)
    print(json.dumps({"tag": args.tag, "device": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
