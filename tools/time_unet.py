"""Times the UNet train step of ``gwen_tpu_torch`` on one NVIDIA GPU at the
shape ``chip_smoke.py`` phase 11 gives it: 124 input members as channels,
1 output, 32 x 512 cells, hidden 64, depth 4 (widths 64 to 512), batch 21,
float32 with TF32 off, Adam, L1 loss.

    python3 tools/time_unet.py [--batch N] [--iters N] [--autotune-first]

The step with cuDNN's heuristic choice of conv algorithms (torch's
default, ``torch.backends.cudnn.benchmark = False``) and with its
autotuning (``benchmark = True``), in turns (off, on, on, off; with
``--autotune-first`` on, off, off, on, since a process may keep the
algorithms its first step chose for a shape), each by
CUDA events around ``--iters`` steps after two warm-up steps, with its peak
memory, and the forward alone; then one step of each under
``torch.profiler``: the device busy share of the step's span and the
kernels by device time. Beside them the step's bound: its floating-point
operations, as ``torch.utils.flop_counter`` counts them for one step (the
convs forward and backward, no input gradient for the first), over the
67 TFLOP/s float32 rate of an H100 SXM at 700 W. Prints the card
(``nvidia-smi`` name and power limit) and one JSON line of the times in
ms. Needs numpy and torch; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PEAK_F32 = 67e12
MEMBERS_IN, MEMBERS_OUT, HEIGHT, NCELLS = 124, 1, 32, 512


def step_fn(model, x, y):
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    def step():
        loss = torch.mean(torch.abs(model(x) - y))
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    return step


def profile(fn, tag: str, top: int = 12) -> dict:
    """One ``fn()`` under ``torch.profiler`` after a warm-up call
    (``profile_step``): logs the busy share of the span from the first
    kernel to the last and the kernels by device time."""
    from gwen_tpu_torch.profiling import profile_step

    fn()
    prof = profile_step(fn)
    by_name = prof["kernels_us"]
    if not by_name:
        print(f"{tag}: the trace holds no device event; not measured")
        return {}
    busy = sum(by_name.values())
    print(f"{tag}: device busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} "
          f"ms span ({prof['busy_share']:.1%}); by kernel:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:8.3f} ms {us / busy:6.1%}  {name[:100]}")
    return {"busy_ms": prof["busy_ms"], "span_ms": prof["span_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=21)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--autotune-first", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_unet: CUDA is not available", file=sys.stderr)
        return 1
    from torch.utils.flop_counter import FlopCounterMode

    from gwen_tpu_torch.nn.unet import UNet
    from gwen_tpu_torch.profiling import cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    model = UNet(MEMBERS_IN, MEMBERS_OUT, device=dev,
                 generator=torch.Generator().manual_seed(0))
    x = torch.randn(args.batch, MEMBERS_IN, HEIGHT, NCELLS, device=dev)
    y = torch.randn(args.batch, MEMBERS_OUT, HEIGHT, NCELLS, device=dev)
    step = step_fn(model, x, y)
    torch.backends.cudnn.benchmark = args.autotune_first
    with FlopCounterMode(display=False) as counter:
        step()
    flops = counter.get_total_flops()
    bound = flops / PEAK_F32 * 1e3
    print(f"batch {args.batch}: {flops / 1e12:.4f} TFLOP a step, bound "
          f"{bound:.3f} ms at 67 TFLOP/s float32")

    out = {"batch": args.batch, "tflop": flops / 1e12, "bound_ms": bound}
    turns = (True, False, False, True) if args.autotune_first else (
        False, True, True, False)
    for bench in turns:
        torch.backends.cudnn.benchmark = bench
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(step, args.iters, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with torch.no_grad():
            fwd = cuda_ms(lambda: model(x), args.iters, warmup=2)
        print(f"cudnn.benchmark={bench}: step {ms:.3f} ms ({bound / ms:.1%} of "
              f"the bound), peak {peak:.2f} GiB; forward {fwd:.3f} ms")
        out.setdefault(f"benchmark_{bench}", []).append(
            {"step_ms": ms, "peak_gib": peak, "forward_ms": fwd})
    for bench in turns[:2]:
        torch.backends.cudnn.benchmark = bench
        out[f"profile_benchmark_{bench}"] = profile(
            step, f"step under torch.profiler, cudnn.benchmark={bench}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
