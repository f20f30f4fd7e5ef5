"""Times the unfused attention operators of ``gwen_tpu_torch`` (B8, the
SDDMM; B9 and B9b, the transpose SpMM) on one NVIDIA GPU at the L7 shapes
``chip_smoke.py`` gives them, holds each against its plain PyTorch version
first, and times the unfused attention forward and backward they run in.

    python3 tools/time_unfused.py [--root DIR] [--tag NAME] [--iters N]
    python3 tools/time_unfused.py --controls

Kernels (bf16, the L7 icosphere in KD-patch order, window 384, with its
transpose tables; f 128, the attention head width, and 256): B8 and B9 at
nb 1 (2-D calls), B8 and B9b at nb 2 (2 heads: the served shape) and at nb
8 (2 heads x batch 4), each by CUDA events around ``--iters`` back-to-back
calls and by its device kernels under ``torch.profiler``, beside its bound
(the bytes it must move over 3.35 TB/s: a, b and the float32 scores for
B8; s, g and the output for B9). Then ``windowed_attention(backend=
"unfused")`` forward and backward at nb 2, dh 128 (B8, B1 and B9 twice an
item), beside ``backend="auto"``. The bf16 forms' shared memory and CTAs an
SM are printed where the library reports them. ``--root`` imports
``gwen_tpu_torch`` from another checkout (say the parent commit unpacked
with ``git archive``; one that has ``ops/cuda_lib.py``), so that two
versions can be timed in turns, in separate processes, on one card.

``--controls`` times, instead of the attention step, B8 (nb 1 and 8, f
128; nb 1, f 256), B9 (nb 1, f 128 and 256) and B9b (nb 8, f 128) built
from this checkout's ``csrc/window_unfused.cu`` with one change each (text
edits, ``CONTROLS``), beside the kernels as they are and beside torch's own
fill and copy of a tensor of one item's scores (the write rate, and the
read and write rate, the card reaches). B8: every score tile stored to the
first block's first tile (the output stream's cost, though with a hot
spot in L2), each CTA's tiles stored onto its
own first tile (the scores' bytes kept in L2 without a hot spot), no
stores, b read from the CTA's first window tile, no products, and the ring
as four stages of 64 features. B9: every s tile read from the first block
(the cost of s's bytes, again with a hot spot), each cover's s tile
read from the source block's first cover (a third of s's bytes, spread),
no products, the window starts read in the stage that uses them, and the
ring at two and four stages. Controls whose outputs are wrong by
construction are not held; the others are held against the kernels.
``--vs SOURCE`` (with ``--controls``, repeatable) also times the kernels
of another ``window_unfused.cu``, say an earlier design. Prints the card
(``nvidia-smi`` name and power limit) and one JSON line of times in ms.
Needs numpy and torch; imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

LEVELS, WINDOW, HEADS, BATCH = 7, 384, 2, 4
HBM_BYTES_PER_S = 3.35e12
# name: (text of csrc/window_unfused.cu, its replacement), and whether the
# control's outputs are right (held against the kernel's).
CONTROLS = {
    "B8 no stores": ([(
        """*reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(Os + r * LDO + c4);""",
        "(void)dst;")], False),
    "B8 stores to one tile": ([(
        "float* dst = out + (int64_t)r * p.window + t * T8 + c4;",
        "float* dst = p.out + (int64_t)r * p.window + c4;")], False),
    "B8 stores onto the CTA's first tile": ([(
        "float* dst = out + (int64_t)r * p.window + t * T8 + c4;",
        "float* dst = out + (int64_t)r * p.window + c4;")], False),
    "B8 b from the CTA's first tile": ([(
        "copy_rows(st + L::A_STAGE, LDK, b, ws + t * T8, p.b_rows, T8, kc * KC,",
        "copy_rows(st + L::A_STAGE, LDK, b, ws, p.b_rows, T8, kc * KC,")], False),
    "B8 no products": ([(
        "          mma_bf16(acc[mi][nj], af[mi], bq[nj >> 1][(nj & 1) * 2],",
        "          if (kk < 0) mma_bf16(acc[mi][nj], af[mi], bq[nj >> 1][(nj & 1) * 2],")],
        False),
    "B8 stages of 64 features, four": ([
        ("constexpr int KC = 128;", "constexpr int KC = 64;"),
        ("static constexpr int STAGES = RES ? 2 : 3;",
         "static constexpr int STAGES = RES ? 4 : 3;")], True),
    "B9 s from one block": ([
        ("tma_load_3d(st, &tm_s, bar, col0, r0, item);",
         "tma_load_3d(st, &tm_s, bar, 0, (q % (BM / KI)) * KI, 0);"),
        ("tma_load_3d(st + BOX * 2, &tm_s, bar, col0 + 64, r0, item);",
         "tma_load_3d(st + BOX * 2, &tm_s, bar, 64, (q % (BM / KI)) * KI, 0);")],
        False),
    "B9 s from its first cover": ([
        ("tma_load_3d(st, &tm_s, bar, col0, r0, item);",
         "tma_load_3d(st, &tm_s, bar, col0, lo * BM + (q % (BM / KI)) * KI, item);"),
        ("tma_load_3d(st + BOX * 2, &tm_s, bar, col0 + 64, r0, item);",
         "tma_load_3d(st + BOX * 2, &tm_s, bar, col0 + 64, lo * BM + (q % (BM / KI)) * KI, "
         "item);")], False),
    "B9 no products": ([(
        "          mma_bf16(acc[mi][2 * nj], af[mi], bq[0], bq[1]);",
        "          if (kk < 0) mma_bf16(acc[mi][2 * nj], af[mi], bq[0], bq[1]);"), (
        "          mma_bf16(acc[mi][2 * nj + 1], af[mi], bq[2], bq[3]);",
        "          if (kk < 0) mma_bf16(acc[mi][2 * nj + 1], af[mi], bq[2], bq[3]);")],
        False),
    "B9 window starts read in the stage": ([(
        "const int col0 = c * BM - ws_cur;",
        "const int col0 = c * BM - p.window_start[lo + cov];")], True),
    "B9 two stages": ([("constexpr int S9 = 3;", "constexpr int S9 = 2;")], True),
    "B9 four stages": ([("constexpr int S9 = 3;", "constexpr int S9 = 4;")], True),
}


def bind(lib, declared):
    """Types a library's C entries as ``declared`` (the wrapper's library
    object) types them."""
    for name, argtypes in declared.entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def ptxas_lines(log: str, tag: str) -> None:
    """The compiler's registers, spills and shared memory per kernel."""
    entry = ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            print(f"  {tag} ptxas {entry[:60]}: {line.strip()}", flush=True)


def control_libs(uc, nvcc_build) -> dict:
    """Each control's library, built from a changed copy of the kernels'
    source in the build directory, all at once."""
    src = uc.LIB.source.read_text()
    paths = {}
    for k, (name, (edits, _)) in enumerate(CONTROLS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"control {name!r}: {old!r} not found once")
            text = text.replace(old, new)
        path = uc.LIB.source.parents[1] / "_build" / f"window_unfused_{k}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        paths[name] = path
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(nvcc_build, paths.values())))
    libs = {}
    for name, (lib_path, log) in built.items():
        ptxas_lines(log, name)
        libs[name] = bind(ctypes.CDLL(str(lib_path)), uc.LIB)
    return libs


def held(name: str, got, want) -> None:
    """max|got − want| ≤ 1e-2·max|want| (bf16 against float32 plain)."""
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    print(f"  {name}: max|err| {err:.4g} of max|plain| {ref:.4g} "
          f"{'ok' if err <= 1e-2 * ref else 'FAIL'}", flush=True)
    if not err <= 1e-2 * ref:
        raise AssertionError(f"{name}: the kernel disagrees with its plain version")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout to import gwen_tpu_torch from")
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--controls", action="store_true",
                    help="time the control builds instead of the attention step")
    ap.add_argument("--vs", action="append", default=[], metavar="SOURCE",
                    help="with --controls, also time the kernels of this "
                         "window_unfused.cu (say an earlier design)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_unfused: CUDA is not available", file=sys.stderr)
        return 1
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      kd_patch_order, to_diag_window)
    from gwen_tpu_torch.ops import unfused_cuda as uc
    from gwen_tpu_torch.ops.attention import windowed_attention
    from gwen_tpu_torch.profiling import cuda_ms, device_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"{args.tag}: {uc.__file__} on {smi}", flush=True)
    _, log = uc.LIB.build()
    ptxas_lines(log, args.tag)
    dev = torch.device("cuda", 0)
    times: dict = {}
    occupancy = getattr(uc.LIB(), "gwen_unfused_occupancy", None)
    if occupancy is not None:  # (kernel: 0 B8, 1 B9; f; out bytes; out CTAs an SM)
        occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p]
        for k, key in enumerate(("B8", "B9")):
            for f in (128, 256, 264):
                smem, ctas = ctypes.c_int(0), ctypes.c_int(0)
                if occupancy(k, f, ctypes.byref(smem), ctypes.byref(ctas)) != 0:
                    raise RuntimeError(f"{key} occupancy query failed")
                print(f"  {key} bf16 f {f}: {smem.value} bytes of shared memory a "
                      f"CTA, {ctas.value} CTAs an SM", flush=True)
                times[f"{key} f {f} CTAs an SM"] = ctas.value

    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    s2, r2, _ = apply_order(kd_patch_order(verts, s, r, n), s, r)
    graph = to_diag_window(build_graph(s2, r2, n), window_size=WINDOW,
                           dtype=torch.bfloat16, transpose_tables=True).to(dev)
    n_pad, w = graph.num_padded_nodes, graph.window_size
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    def bound_ms(*tensors) -> float:
        return sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S * 1e3

    # The kernels, each held to its plain version first.
    for f in (128, 256):
        for nb in (1, HEADS, HEADS * BATCH):
            lead = () if nb == 1 else (nb,)
            a, b = randn(*lead, n, f), randn(*lead, n, f)
            sm, g = randn(*lead, n_pad, w), randn(*lead, n, f)
            scores = uc.sddmm(graph, a, b)
            held(f"B8 nb {nb} f {f}", scores, uc.sddmm_plain(graph, a.float(), b.float()))
            out = uc.spmm_t(graph, sm, g)
            held(f"B9 nb {nb} f {f}", out, uc.spmm_t_plain(graph, sm.float(), g.float()))
            calls = {
                f"B8 nb {nb} f {f}": (lambda: uc.sddmm(graph, a, b),
                                      bound_ms(a, b, scores)),
                f"B9{'b' if nb > 1 else ''} nb {nb} f {f}": (
                    lambda: uc.spmm_t(graph, sm, g), bound_ms(sm, g, out)),
            }
            for name, (fn, bound) in calls.items():
                times[name] = cuda_ms(fn, args.iters)
                times[f"{name} device"] = device_ms(fn, args.iters, warmup=1)
                times[f"{name} bound"] = bound
                print(f"  {name}: {times[name]:.4f} ms (device kernels "
                      f"{times[f'{name} device']:.4f}); bound {bound:.4f} ms "
                      f"({bound / times[f'{name} device']:.1%})", flush=True)
            del a, b, sm, g, scores, out
            torch.cuda.empty_cache()

    if args.controls:
        from gwen_tpu_torch.ops.cuda_lib import nvcc_build

        libs = {"as they are": uc.LIB(), **control_libs(uc, nvcc_build)}
        for src in args.vs:
            lib_path, log = nvcc_build(Path(src).resolve())
            ptxas_lines(log, src)
            libs[f"vs {src}"] = bind(ctypes.CDLL(str(lib_path)), uc.LIB)
        f, nbs = 128, HEADS * BATCH
        a, b = randn(nbs, n, f), randn(nbs, n, f)
        sm, g = randn(nbs, n_pad, w), randn(nbs, n, f)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws, tlo, tcnt = (t.data_ptr() for t in (graph.window_start, graph.t_lo,
                                                 graph.t_cnt))
        scores = torch.empty(nbs, n_pad, w, device=dev)
        out = torch.empty(nbs, graph.num_src_rows, f, dtype=torch.bfloat16, device=dev)

        def b8(lib, nb):
            return lambda: lib.gwen_sddmm(
                a.data_ptr(), b.data_ptr(), ws, scores.data_ptr(), nb,
                graph.num_blocks, w, f, n, n, 1, stream)

        def b9(lib, nb):
            return lambda: lib.gwen_spmm_t(
                sm.data_ptr(), g.data_ptr(), ws, tlo, tcnt, out.data_ptr(), nb,
                graph.num_blocks, graph.t_lo.shape[0], w, f, n, 1, stream)

        a2, b2, g2 = randn(n, 256), randn(n, 256), randn(n, 256)
        scores2 = torch.empty(n_pad, w, device=dev)
        out2 = torch.empty(graph.num_src_rows, 256, dtype=torch.bfloat16, device=dev)

        def b8_256(lib):
            return lambda: lib.gwen_sddmm(
                a2.data_ptr(), b2.data_ptr(), ws, scores2.data_ptr(), 1,
                graph.num_blocks, w, 256, n, n, 1, stream)

        def b9_256(lib):
            return lambda: lib.gwen_spmm_t(
                sm.data_ptr(), g2.data_ptr(), ws, tlo, tcnt, out2.data_ptr(), 1,
                graph.num_blocks, graph.t_lo.shape[0], w, 256, n, 1, stream)

        want = (uc.sddmm(graph, a, b), uc.spmm_t(graph, sm, g))
        for name, lib in libs.items():
            for fn in (b8(lib, nbs), b9(lib, nbs)):
                if fn() != 0:
                    raise RuntimeError(f"{name}: launch failed")
            if name not in CONTROLS or CONTROLS[name][1]:
                held(f"{name} B8 against the kernel", scores, want[0])
                held(f"{name} B9 against the kernel", out, want[1])
        # Yardsticks: torch's own fill and copy of a tensor of the scores'
        # size (the write rate, and the read and write rate, the card reaches).
        other = torch.empty_like(scores[0])
        for key, fn in (("fill of one item's scores (253 MB)",
                         lambda: scores[0].fill_(1.0)),
                        ("copy of one item's scores (253 MB each way)",
                         lambda: other.copy_(scores[0]))):
            times[f"torch {key}"] = cuda_ms(fn, args.iters)
            print(f"  torch {key}: {times[f'torch {key}']:.4f} ms", flush=True)
        del other
        runs: dict = {}
        for rnd in range(2):  # in turns, then reversed
            for name, lib in (libs.items() if rnd == 0 else reversed(libs.items())):
                for key, fn in (("B8 nb 1", b8(lib, 1)), ("B8 nb 8", b8(lib, nbs)),
                                ("B8 nb 1 f 256", b8_256(lib)),
                                ("B9 nb 1", b9(lib, 1)), ("B9b nb 8", b9(lib, nbs)),
                                ("B9 nb 1 f 256", b9_256(lib))):
                    runs.setdefault(f"{key}, {name}", []).append(
                        cuda_ms(fn, args.iters))
        for key, ms in runs.items():
            times[key] = sum(ms) / len(ms)
            print(f"  {key}: {times[key]:.4f} ms", flush=True)
        print(json.dumps({"tag": args.tag, "device": smi, "ms": times}))
        return 0

    # The unfused attention forward and backward (nb 2, dh 128), beside auto.
    q, k, v = (randn(HEADS, n, 128).requires_grad_() for _ in range(3))
    cot = randn(HEADS, n, 128)
    for backend in ("unfused", "auto"):
        def both():
            out = windowed_attention(graph, q, k, v, backend=backend)
            return torch.autograd.grad(out, (q, k, v), cot)

        with torch.no_grad():
            fwd = cuda_ms(lambda: windowed_attention(graph, q, k, v,
                                                     backend=backend), 5, 1)
        times[f"attention {backend} forward nb 2"] = fwd
        times[f"attention {backend} forward and backward nb 2"] = cuda_ms(
            both, 5, 1)
        times[f"attention {backend} forward and backward nb 2 device"] = device_ms(
            both, 3, warmup=1)
        print(f"  windowed_attention backend={backend!r} nb 2: forward {fwd:.3f} ms, "
              f"forward and backward "
              f"{times[f'attention {backend} forward and backward nb 2']:.3f} ms "
              f"(device kernels "
              f"{times[f'attention {backend} forward and backward nb 2 device']:.3f})",
              flush=True)
    print(json.dumps({"tag": args.tag, "device": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
