"""Times the row-gather SpMM kernels of ``gwen_tpu_torch`` on one NVIDIA GPU
at the L7 shapes ``chip_smoke.py`` gives them, and holds each against its
plain PyTorch version first.

    python3 tools/time_row_gathers.py [--root DIR] [--tag NAME] [--iters N]
    python3 tools/time_row_gathers.py --controls [--vs DIR]

With one item: B1 and packed B1 (bf16, F 256, with and without their escape
fix rows), B1 on a float32 one-channel field (F 4) over the bf16 S,
``diag_matvec``'s B1 on a runtime S with the window mask's pattern (the
attention probabilities) at f 128 and 256, B13 and B11 (RCM order, F 256),
B3 on the esc2 contraction, and the int8 rank-1 composite
(``spmm_sliding_rank1`` on the RCM band, unbatched and at batch 4, held to
its own checkout's plain version on the same bf16 path). Then, for
comparison, the batch-4 forms that share the kernels' source (B4, packed
B4, B10, B13, B11), B14 (the block-tile SpMM, F 256) in RCM and in
KD-patch order, unbatched and at batch 4, and the two row gathers
launched directly with one item on B1's and packed B1's operands
(``_launch_streamed``, ``_launch_packed_rows``: the same call as B1 where B1
takes the gathers). ``--root`` imports ``gwen_tpu_torch`` from another
checkout (say the parent commit unpacked with ``git archive``; one that
has ``ops/cuda_lib.py``), so that two versions can be timed in turns, in
separate processes, in one session on one card. Prints the card
(``nvidia-smi`` name and power limit), the compiler's register lines, and
one JSON line of times in ms (CUDA events, the mean of ``--iters`` calls
after 3 warm-up calls; B3 on the esc2 graph also by its device kernels
under ``torch.profiler``). Needs numpy and torch; imports no JAX.

``--controls`` times, instead, B14 unbatched and at batch 4 in both
orders built from this checkout's ``csrc/window_spmm.cu`` with one change
each (``CONTROLS``), beside the kernel as it is: every gather from one of
the first 64 rows (so from L1: what the gathers' bytes cost; its outputs
are wrong by construction and not held); one item through the batch's
list kernel instead of the slot walk; the walk at 40 registers a thread
instead of 32; the list kernel with no register cap instead of 40.
``--vs DIR`` adds the B14 kernel of another checkout's source (say the
parent), built and called in the same process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

LEVELS, WINDOW, F, BATCH = 7, 384, 256, 4
# name: [(text of csrc/window_spmm.cu, its replacement)]
CONTROLS = {
    "B14 gathers from 64 rows": [(
        "    return wk != 0.f && src < tl.x_rows;",
        "    src &= 63;\n    return wk != 0.f && src < tl.x_rows;")],
    "B14 one item by the list kernel": [(
        "  if (batch == 1)\n    tile_walk_kernel", "  if (false)\n    tile_walk_kernel")],
    "B14 walk at 40 registers": [(
        "__launch_bounds__(TILE_WARPS * 32, 8)\ntile_walk_kernel",
        "__launch_bounds__(TILE_WARPS * 32, 6)\ntile_walk_kernel")],
    "B14 list kernel, no register cap": [(
        "__launch_bounds__(TILE_WARPS * 32, 6)\ntile_list_kernel",
        "__launch_bounds__(TILE_WARPS * 32)\ntile_list_kernel")],
}


def control_libs(spmm_cuda, vs=None) -> dict:
    """Each control's library, built from a changed copy of the kernels'
    source in the build directory, with B14's entry typed as the wrapper
    types it; with ``vs``, also the library of that checkout's source as it
    is (its name the checkout's path)."""
    import ctypes

    from gwen_tpu_torch.ops.cuda_lib import nvcc_build

    src = spmm_cuda.LIB.source.read_text()
    libs = {}
    controls = dict(CONTROLS)
    if vs is not None:
        controls[f"{vs} as it is"] = (
            Path(vs) / "gwen_tpu_torch" / "csrc" / "window_spmm.cu").read_text()
    for name, edits in controls.items():
        text = edits if isinstance(edits, str) else src
        for old, new in ([] if isinstance(edits, str) else edits):
            if text.count(old) != 1:
                raise AssertionError(f"control {name!r}: {old!r} not found once")
            text = text.replace(old, new)
        path = spmm_cuda.LIB.source.parents[1] / "_build" / f"window_spmm_{len(libs)}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        lib_path, ptxas = nvcc_build(path)
        entry = ""
        for line in ptxas.splitlines():  # B14's register and spill lines
            if "Compiling entry" in line:
                entry = line
            elif "tile_" in entry and ("registers" in line or "spill" in line):
                print(f"  {name}: ptxas: {line.strip()[-90:]}")
        lib = ctypes.CDLL(str(lib_path))
        lib.gwen_tile_spmm.argtypes = spmm_cuda.LIB.entries["gwen_tile_spmm"]
        lib.gwen_tile_spmm.restype = ctypes.c_int
        libs[name] = lib
    return libs


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
    ap.add_argument("--controls", action="store_true",
                    help="time B14's control builds instead")
    ap.add_argument("--vs", help="with --controls: also time the B14 kernel of "
                    "this checkout's source, built as it is")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_row_gathers: CUDA is not available", file=sys.stderr)
        return 1
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      kd_patch_order, rcm_order, to_block_tiles,
                                      to_diag_window, to_sliding_packed,
                                      to_sliding_rank1, to_windowed_dense,
                                      window_mask)
    from gwen_tpu_torch.ops import spmm_cuda
    from gwen_tpu_torch.profiling import cuda_ms, device_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"{args.tag}: {spmm_cuda.__file__} on {smi}", flush=True)
    _, ptxas = spmm_cuda.LIB.build()
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    s2, r2, _ = apply_order(kd_patch_order(verts, s, r, n), s, r)
    g = build_graph(s2, r2, n)
    s3, r3, _ = apply_order(rcm_order(s, r, n), s, r)
    g3 = build_graph(s3, r3, n)
    tiles = {"RCM": to_block_tiles(g3).to(dev), "KD": to_block_tiles(g).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(3)
    if args.controls:
        return run_controls(torch, spmm_cuda, tiles, n, gen, args, smi)
    dg = to_diag_window(g, window_size=WINDOW, dtype=torch.bfloat16).to(dev)
    pg = to_diag_window(g, window_size=WINDOW, dtype=torch.bfloat16,
                        packed=True).to(dev)
    sp = to_sliding_packed(g3).to(dev)
    wd = to_windowed_dense(g3).to(dev)
    wd16 = dataclasses.replace(wd, s_mat=wd.s_mat.bfloat16())
    r1 = to_sliding_rank1(g3).to(dev)
    g2 = dg.esc2_graph

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
        **{f"B14 {o}{'' if x_ is xr else f' batch {BATCH}'}": (
            lambda o=o, x_=x_: spmm_cuda.block_tiles_spmm(tiles[o], x_),
            lambda o=o, x_=x_: spmm_cuda.block_tiles_spmm_plain(tiles[o], x_.float()))
           for o in tiles for x_ in (xr, xrb)},
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
        times[name] = cuda_ms(kernel, args.iters)
        print(f"  {name}: {times[name]:.4f} ms", flush=True)
    # B3 on the esc2 graph is shorter than the host's enqueue of a call.
    name = "B3 esc2, device kernels (profiler)"
    times[name] = device_ms(lambda: spmm_cuda.sliding_spmm(g2, x2), args.iters,
                            warmup=3)
    print(f"  {name}: {times[name]:.4f} ms", flush=True)
    print(json.dumps({"tag": args.tag, "device": smi, "ms": times}))
    return 0


def run_controls(torch, spmm_cuda, tiles: dict, n: int, gen, args, smi) -> int:
    """B14 at batch 4 in both orders, the kernel as it is and each control,
    each control held to the kernel first, timed in turns and then in the
    reverse order."""
    from gwen_tpu_torch.profiling import cuda_ms

    libs = {"as it is": spmm_cuda.LIB(), **control_libs(spmm_cuda, args.vs)}
    x = torch.randn(BATCH, n, F, generator=gen, device="cuda").bfloat16()
    runs: dict = {}

    def call(lib, t, out, nb):
        return lambda: lib.gwen_tile_spmm(
            t.tile_idx.data_ptr(), t.n_active.data_ptr(), t.tnbr.data_ptr(),
            t.tw.data_ptr(), x.data_ptr(), out.data_ptr(), t.num_padded_nodes,
            t.tiles_max, t.tile_degree, t.block_size, F, n, nb, 1,
            torch.cuda.current_stream().cuda_stream)

    for order, t in tiles.items():
        for nb in (1, BATCH):
            want = spmm_cuda.block_tiles_spmm(t, x[:nb])
            held(torch, f"B14 {order} batch {nb}", want,
                 spmm_cuda.block_tiles_spmm_plain(t, x[:nb].float()))
            out = torch.empty_like(want)
            for name, lib in libs.items():
                if call(lib, t, out, nb)() != 0:
                    raise RuntimeError(f"{name}: launch failed")
                if "64 rows" not in name:
                    held(torch, f"B14 {order} batch {nb}, {name}, against the kernel",
                         out, want)
            for rnd in range(2):  # in turns, then reversed
                for name, lib in (libs.items() if rnd == 0 else reversed(libs.items())):
                    runs.setdefault(f"B14 {order} batch {nb}, {name}", []).append(
                        cuda_ms(call(lib, t, out, nb), args.iters))
    times = {key: sum(ms) / len(ms) for key, ms in runs.items()}
    for key, ms in times.items():
        print(f"  {key}: {ms:.4f} ms", flush=True)
    print(json.dumps({"tag": args.tag, "device": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
