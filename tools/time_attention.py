"""Times the windowed-attention kernels of ``gwen_tpu_torch`` (B5, the
forward; B6, dQ and the row stats; B7, dK and dV) on one NVIDIA GPU at the
L7 shapes ``chip_smoke.py`` gives them, holds each against its plain
PyTorch version first, and times the attention train steps they run in.

    python3 tools/time_attention.py [--root DIR] [--tag NAME] [--iters N]
    python3 tools/time_attention.py --controls

Kernels (dh 128, bf16, the L7 icosphere in KD-patch order, window 384,
with its attention lists): B5, B6 and B7 at nb 1 (a 2-D call), B5b, B6b
and B7b at nb 2 (2 heads: the served shape) and at nb 8 (2 heads x batch
4: the train shape), each by CUDA events around ``--iters`` back-to-back
calls and by its device kernels under ``torch.profiler``, beside the plain
version's time. Steps (Adam, latent 256, 4 process steps, 2 heads, bf16
compute, 1 channel): the batch-4 attention train step, the batch-4
fair-CRPS step (4 members, 16 items a step), and the batch-4 step of the
partitioned path on one rank (``diag`` layout, zero halos); each by CUDA
events over 3 steps after a warm-up, then one step under
``torch.profiler`` for B5's, B6's and B7's device time in it. ``--root``
imports ``gwen_tpu_torch`` from another checkout (say the parent commit
unpacked with ``git archive``; one that has ``ops/cuda_lib.py``), so that
two versions can be timed in turns, in separate processes, on one card;
``--controls`` launches through the wrappers' ``_launch`` (the kernels'
strided arguments), so only with a checkout that has it.

``--controls`` times, instead of the steps, B5b (nb 2 and 8), B6b and B7b
built from this checkout's ``csrc/window_attention.cu`` with one change
each, beside the kernels as they are: every gather reads one of the first
64 rows (so from L1: what the bytes of the gathers cost); one more CTA an
SM for each kernel (at most 64 registers a thread for B5 and B6, 80 for
B7: what occupancy buys against spills); one CTA fewer for B5 (at most
128 registers: no spill); and B5's scores completed by the backward's
``pair_sums`` with its g . v half zero, then handed to the upper half of
the group, instead of a plain butterfly. The first control's outputs are
wrong by construction and are not held. Prints the card (``nvidia-smi``
name and power limit) and one JSON line of times in ms. Needs numpy and
torch; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

LEVELS, WINDOW, LATENT, STEPS, HEADS, BATCH = 7, 384, 256, 4, 2, 4
# name: (text of csrc/window_attention.cu, its replacement)
CONTROLS = {
    "gathers from 64 rows": [(
        "out[d].load(base + (in ? j[d] : 0) * rs);",
        "out[d].load(base + ((in ? j[d] : 0) & 63) * rs);")],
    "fewer registers (B5, B6 64, B7 80)": [
        ("__launch_bounds__(NT, 3)\nattn_fwd_kernel",
         "__launch_bounds__(NT, 4)\nattn_fwd_kernel"),
        ("__launch_bounds__(NT, 3)\nattn_dq_kernel",
         "__launch_bounds__(NT, 4)\nattn_dq_kernel"),
        ("__launch_bounds__(NT, 2)\nattn_dkdv_kernel",
         "__launch_bounds__(NT, 3)\nattn_dkdv_kernel")],
    "B5 at 128 registers": [
        ("__launch_bounds__(NT, 3)\nattn_fwd_kernel",
         "__launch_bounds__(NT, 2)\nattn_fwd_kernel")],
    "B5 scores by pair_sums": [(
        "    group_sums<G, CAP>(sc, mask);\n",
        """    {
      float s2[2 * CAP], h[CAP];
      for (int d = 0; d < CAP; ++d) s2[d] = sc[d], s2[CAP + d] = 0.f;
      const int ln = (threadIdx.x & 31) % G;
      pair_sums<G, CAP>(s2, h, ln, mask);
      for (int d = 0; d < CAP; ++d) {
        const float o = __shfl_xor_sync(mask, h[d], G / 2);
        sc[d] = ln & (G / 2) ? o : h[d];
      }
    }
""")],
}


def control_libs(ac, nvcc_build) -> dict:
    """Each control's library, built from a changed copy of the kernels'
    source in the build directory, its entries typed as the wrapper types
    them."""
    import ctypes

    src = ac.LIB.source.read_text()
    libs = {}
    for name, edits in CONTROLS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"control {name!r}: {old!r} not found once")
            text = text.replace(old, new)
        path = ac.LIB.source.parents[1] / "_build" / f"window_attention_{len(libs)}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        lib_path, ptxas = nvcc_build(path)
        entry = ""
        for line in ptxas.splitlines():  # the bf16 dh-128 kernels' lines
            if "Compiling entry" in line:
                entry = line
            elif "bfloat16Li4E" in entry and ("spill" in line or "registers" in line):
                print(f"  {name}: ptxas: {entry.split('attn_')[1][:12]} {line.strip()[-60:]}")
        lib = ctypes.CDLL(str(lib_path))
        for entry_name, argtypes in ac.LIB.entries.items():
            fn = getattr(lib, entry_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


def held(torch, name: str, got, want) -> None:
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
                    help="time the control builds instead of the steps")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_attention: CUDA is not available", file=sys.stderr)
        return 1
    from gwen_tpu_torch.profiling import cuda_ms, kernel_us
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      kd_patch_order, to_diag_window)
    from gwen_tpu_torch.nn import EncodeProcessDecode
    from gwen_tpu_torch.ops import attention_cuda as ac
    from gwen_tpu_torch.parallel import make_partitioned_apply, partition_graph
    from gwen_tpu_torch.train import (ensemble_crps_loss_fn, make_mesh,
                                      mesh_graph_loss_fn, partitioned_mesh_loss_fn)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"{args.tag}: {ac.__file__} on {smi}", flush=True)
    _, ptxas = ac.LIB.build()
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    s2, r2, _ = apply_order(kd_patch_order(verts, s, r, n), s, r)
    graph = to_diag_window(build_graph(s2, r2, n), window_size=WINDOW,
                           dtype=torch.bfloat16, transpose_tables=True).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    times: dict = {}

    # The kernels, each held to its plain version first.
    for lead in ((), (HEADS,), (HEADS * BATCH,)):
        nb = lead[0] if lead else 1
        q, k, v, g = (torch.randn(*lead, n, 128, generator=gen, device=dev).bfloat16()
                      for _ in range(4))
        scale = 128 ** -0.5
        out = ac.attention_fwd(graph, q, k, v, scale)
        held(torch, f"B5 nb {nb} out", out,
             ac.attention_fwd_plain(graph, *(t.float() for t in (q, k, v)), scale))
        del out
        dq, st = ac.attention_dq(graph, q, k, v, g, scale)
        w_dq, w_st = ac.attention_dq_plain(graph, *(t.float() for t in (q, k, v, g)),
                                           scale)
        held(torch, f"B6 nb {nb} dq", dq, w_dq)
        dk, dv = ac.attention_dkdv(graph, q, k, v, g, st, scale)
        w_dk, w_dv = ac.attention_dkdv_plain(
            graph, *(t.float() for t in (q, k, v, g)), w_st, scale)
        held(torch, f"B7 nb {nb} dk", dk, w_dk)
        held(torch, f"B7 nb {nb} dv", dv, w_dv)
        del dq, dk, dv, w_dq, w_st, w_dk, w_dv
        p_st = ac.attention_dq_plain(graph, q, k, v, g, scale)[1]
        calls = {
            "B5": (lambda: ac.attention_fwd(graph, q, k, v, scale),
                   lambda: ac.attention_fwd_plain(graph, q, k, v, scale)),
            "B6": (lambda: ac.attention_dq(graph, q, k, v, g, scale),
                   lambda: ac.attention_dq_plain(graph, q, k, v, g, scale)),
            "B7": (lambda: ac.attention_dkdv(graph, q, k, v, g, st, scale),
                   lambda: ac.attention_dkdv_plain(graph, q, k, v, g, p_st, scale)),
        }
        for key, (kernel, plain) in calls.items():
            name = f"{key}{'b' if nb > 1 else ''} nb {nb}"
            times[name] = cuda_ms(kernel, args.iters)
            times[f"{name} device"] = sum(kernel_us(kernel, args.iters).values()
                                          ) / args.iters / 1e3
            times[f"{name} plain"] = cuda_ms(plain, 3, 1)
            print(f"  {name}: {times[name]:.4f} ms (device kernels "
                  f"{times[f'{name} device']:.4f}), plain {times[f'{name} plain']:.4f}",
                  flush=True)
        del q, k, v, g, st, p_st
        torch.cuda.empty_cache()

    if args.controls:
        from gwen_tpu_torch.ops.cuda_lib import nvcc_build

        libs = {"as they are": ac.LIB(), **control_libs(ac, nvcc_build)}
        q, k, v, g = (torch.randn(HEADS * BATCH, n, 128, generator=gen,
                                  device=dev).bfloat16() for _ in range(4))
        scale = 128 ** -0.5
        st = ac.attention_dq(graph, q, k, v, g, scale)[1]
        out = [torch.empty_like(q) for _ in range(4)]
        st2 = torch.empty_like(st)
        # (nb, N, dh) as the kernels take operands: (n0, n1, N, dh).
        q4, k4 = q.unsqueeze(1), k.unsqueeze(1)

        def b5(lib, nb):
            return lambda: ac._launch(
                lib.gwen_attn_fwd, "B5", graph.attn_nbr, q4[:nb], k4[:nb], scale,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), graph.attn_nbr.data_ptr(),
                 out[3].data_ptr()])

        def b6(lib):
            return lambda: ac._launch(
                lib.gwen_attn_dq, "B6", graph.attn_nbr, q4, k4, scale,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 graph.attn_nbr.data_ptr(), out[0].data_ptr(), st2.data_ptr()])

        def b7(lib):
            return lambda: ac._launch(
                lib.gwen_attn_dkdv, "B7", graph.attn_nbr_t, q4, k4, scale,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 st.data_ptr(), graph.attn_nbr_t.data_ptr(), out[1].data_ptr(),
                 out[2].data_ptr()])

        want = [ac.attention_dq(graph, q, k, v, g, scale)[0],
                *ac.attention_dkdv(graph, q, k, v, g, st, scale),
                ac.attention_fwd(graph, q, k, v, scale)]
        for name, lib in libs.items():
            for fn in (b6(lib), b7(lib), b5(lib, HEADS * BATCH)):
                fn()  # raises on a failed launch
            if name != "gathers from 64 rows":
                for got, w, what in zip(out, want, ("dq", "dk", "dv", "out")):
                    held(torch, f"{name} {what} against the kernel", got, w)
        runs: dict = {}
        for rnd in range(2):  # in turns, then reversed
            for name, lib in (libs.items() if rnd == 0 else reversed(libs.items())):
                for key, fn in (("B5b nb 2", b5(lib, HEADS)),
                                ("B5b nb 8", b5(lib, HEADS * BATCH)),
                                ("B6b nb 8", b6(lib)), ("B7b nb 8", b7(lib))):
                    runs.setdefault(f"{key}, {name}", []).append(
                        cuda_ms(fn, args.iters))
        for key, ms in runs.items():
            times[key] = sum(ms) / len(ms)
            print(f"  {key}: {times[key]:.4f} ms", flush=True)
        print(json.dumps({"tag": args.tag, "device": smi, "ms": times}))
        return 0

    # The attention train steps.
    def model():
        return EncodeProcessDecode(1, 1, device=dev, latent_size=LATENT,
                                   process_steps=STEPS, compute_dtype=torch.bfloat16,
                                   processor="attention", attn_heads=HEADS,
                                   generator=torch.Generator().manual_seed(0))

    def step_of(m, loss_fn, batch, ctx):
        opt = torch.optim.Adam(m.parameters(), lr=1e-4)

        def step():
            loss, _ = loss_fn(batch, ctx)
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
        return step

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(BATCH, n, 1)).astype(np.float32)).to(dev)
    y = 0.9 * x + 0.1
    m = model()
    pg = partition_graph(np.asarray(s2), np.asarray(r2), n, num_parts=1,
                         reorder=False, layout="diag", s_dtype=torch.bfloat16,
                         diag_window=WINDOW)
    mp = model()
    apply_fn = make_partitioned_apply(mp, pg, make_mesh(1, 1), dev,
                                      transpose_tables=True)
    xp = torch.zeros(BATCH, pg.padded_nodes, 1, device=dev)
    xp[:, :n] = x
    part_loss = partitioned_mesh_loss_fn(apply_fn)
    steps = {
        "attention step batch 4": step_of(m, mesh_graph_loss_fn(m), (x, y), graph),
        "attention crps step batch 4": step_of(
            m, ensemble_crps_loss_fn(m, num_members=4), (x, y, 3), graph),
        "attention partitioned diag step batch 4": step_of(
            mp, lambda batch, _: part_loss(batch), (xp, 0.9 * xp + 0.1), None),
    }
    for name, step in steps.items():
        times[name] = cuda_ms(step, 3, 1)
        by_name = kernel_us(step)
        busy = sum(by_name.values())
        for key, kernel in (("B5", "attn_fwd_kernel"), ("B6", "attn_dq_kernel"),
                            ("B7", "attn_dkdv_kernel")):
            us = sum(t for nm, t in by_name.items() if kernel in nm)
            times[f"{name} {key} device"] = us / 1e3
        times[f"{name} device busy"] = busy / 1e3
        print(f"  {name}: {times[name]:.3f} ms; one step profiled: device busy "
              f"{busy / 1e3:.3f} ms, B5 {times[f'{name} B5 device']:.3f}, B6 "
              f"{times[f'{name} B6 device']:.3f}, B7 "
              f"{times[f'{name} B7 device']:.3f}", flush=True)
    print(json.dumps({"tag": args.tag, "device": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
