"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``gwen_tpu_torch`` only (no JAX). Phases, each printed as it runs:

1. the device (``nvidia-smi`` name and power limit, torch's device name);
   exits non-zero when CUDA is absent;
2. builds the kernels from this checkout's sources (nvcc for
   ``csrc/window_spmm.cu``, Triton's first compile of the LayerNorm kernel);
3. builds the L7 serving graph and checks each kernel against its plain
   PyTorch version at the shapes serving gives it (bf16: ``max|err| ≤
   1e-2·max|plain|``, the plain version in float32 from the same values;
   float32: ``≤ 1e-5·max|plain|``), timing both with CUDA events;
4. serves: exports a seeded random-weight model (the default
   ``train-mesh graph.refine=7`` model: 1 channel, latent 256, 4 process
   steps, bf16), answers 3 ``predict`` requests of 4 steps through the CLI
   entry point, checks the launch counts (each kernel 3 × 4 × 4 = 48), the
   trajectories, and one served step against the plain versions (within
   2.5 bf16 ulps at max|plain|), and times the served steps.

The second-to-last lines are a JSON object of the kernels and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": ...}``,
printed only when every phase passed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

LEVELS, LATENT, PROCESS_STEPS, CHANNELS, WINDOW = 7, 256, 4, 1, 384
REQUESTS, ROLLOUT_STEPS = 3, 4
BF16_TOL, F32_TOL, STEP_ULPS = 1e-2, 1e-5, 2.5


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(v: float) -> float:
    """Spacing of bfloat16 numbers at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def compare(name: str, got: torch.Tensor, plain: torch.Tensor, tol: float,
            ulps: float = 0.0) -> float:
    """Fail unless ``max|got − plain| ≤ tol·max|plain|`` or, with ``ulps``,
    ``≤ ulps`` bf16 ulps at ``max|plain|``. Returns the max abs error."""
    diff = (got.float() - plain.float()).abs()
    err = diff.max().item()
    ref = plain.float().abs().max().item()
    bound = ulps * bf16_ulp(ref) if ulps else tol * ref
    ok = bool(np.isfinite(err)) and err <= bound
    log(f"  {name}: max|err| {err:.6g}  max|plain| {ref:.6g}  bound {bound:.6g} "
        f"({f'{ulps:g} bf16 ulps' if ulps else f'{tol:g}·max|plain|'})  "
        f"mean|err| {diff.mean().item():.3g}  differing "
        f"{(diff > 0).float().mean().item():.3%}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def timed_pair(kernel, plain) -> tuple[float, float]:
    """Kernel and plain-version times, in turns (plain, kernel, kernel,
    plain) so drift on the card affects both alike."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def build_serving_graph(device, dtype):
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      kd_patch_order, to_diag_window)

    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n)
    s2, r2, _ = apply_order(perm, s, r)
    graph = to_diag_window(build_graph(s2, r2, n), window_size=WINDOW, dtype=dtype)
    return graph.to(device), perm


def check_kernels(graph, device) -> dict:
    """Phase 3: each kernel against its plain version at serving shapes."""
    from gwen_tpu_torch.ops import fused_ln, spmm_cuda

    gen = torch.Generator(device=device).manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    f = LATENT
    u = graph.escape.rows.shape[0]
    g2 = graph.esc2_graph
    results = {}

    # float32 copies of S: the plain versions run in float32 from the same
    # bf16 values, and the float32 cases run the kernels' float32 path.
    graph32 = dataclasses.replace(graph, s_mat=graph.s_mat.float())
    g2_32 = dataclasses.replace(g2, s_mat=g2.s_mat.float())

    # B1: diag-window SpMM with escape placement.
    x, fix = randn(graph.num_padded_nodes, f), randn(u, f)
    want = spmm_cuda.diag_window_spmm_plain(graph32, x.float(), fix.float())
    err = compare("B1 bf16", spmm_cuda.diag_window_spmm(graph, x, fix), want,
                  BF16_TOL)
    compare("B1 f32", spmm_cuda.diag_window_spmm(graph32, x.float(), fix.float()),
            want, F32_TOL)
    ms, plain_ms = timed_pair(lambda: spmm_cuda.diag_window_spmm(graph, x, fix),
                              lambda: spmm_cuda.diag_window_spmm_plain(graph, x, fix))
    results["B1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # B3: banded SpMM on the esc2 graph (x compacted to the U endpoints).
    x2 = randn(g2.num_nodes, f)
    want = spmm_cuda.sliding_spmm_plain(g2_32, x2.float())
    err = compare("B3 bf16", spmm_cuda.sliding_spmm(g2, x2), want, BF16_TOL)
    compare("B3 f32", spmm_cuda.sliding_spmm(g2_32, x2.float()), want, F32_TOL)
    ms, plain_ms = timed_pair(lambda: spmm_cuda.sliding_spmm(g2, x2),
                              lambda: spmm_cuda.sliding_spmm_plain(g2, x2))
    results["B3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # B2: residual + LayerNorm at the padded state's shape.
    m, h = randn(graph.num_padded_nodes, f), randn(graph.num_padded_nodes, f)
    sc, bi = randn(f, dtype=torch.float32), randn(f, dtype=torch.float32)
    want = fused_ln.residual_layernorm_plain(m.float(), h.float(), sc, bi)
    err = compare("B2 bf16", fused_ln.residual_layernorm(m, h, sc, bi), want,
                  BF16_TOL)
    compare("B2 f32", fused_ln.residual_layernorm(m.float(), h.float(), sc, bi),
            want, F32_TOL)
    ms, plain_ms = timed_pair(lambda: fused_ln.residual_layernorm(m, h, sc, bi),
                              lambda: fused_ln.residual_layernorm_plain(m, h, sc, bi))
    results["B2"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    torch.cuda.synchronize()
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return results


def serve(graph, perm, device, workdir: Path) -> dict:
    """Phase 4: export, serve 3 requests through the CLI, check."""
    from gwen_tpu_torch.cli.main import main as cli
    from gwen_tpu_torch.nn import EncodeProcessDecode
    from gwen_tpu_torch.ops import fused_ln, spmm_cuda
    from gwen_tpu_torch.serve import ServingModel, export_model

    n = graph.num_nodes
    model = EncodeProcessDecode(
        CHANNELS, CHANNELS, device=device, latent_size=LATENT,
        process_steps=PROCESS_STEPS, compute_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0)).eval()
    meta = {"levels": LEVELS, "channels": CHANNELS, "latent_size": LATENT,
            "process_steps": PROCESS_STEPS, "mlp_layers": 2, "residual": True,
            "compute_dtype": "bfloat16", "diag_window": WINDOW,
            "processor": "gcn", "nodes": n, "data": ""}
    art = export_model(model, np.zeros((n, CHANNELS), np.float32),
                       workdir / "artifact", metadata=meta)
    inputs = []
    for k in range(REQUESTS):
        x0 = np.random.default_rng(100 + k).normal(size=(n, CHANNELS)).astype(np.float32)
        np.save(workdir / f"x{k}.npy", x0)
        inputs.append(x0)

    kernels = (spmm_cuda.diag_window_spmm, spmm_cuda.sliding_spmm,
               fused_ln.residual_layernorm)
    for k in kernels:
        k.launches = 0
    walls = []
    for k in range(REQUESTS):
        t0 = time.perf_counter()
        rc = cli(["predict", "--artifact", str(art), "--input", str(workdir / f"x{k}.npy"),
                  "--steps", str(ROLLOUT_STEPS), "--out", str(workdir / f"y{k}.npy"),
                  "--device", str(device)])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if rc != 0:
            raise AssertionError(f"predict request {k} returned {rc}")
    launches = {"B1": spmm_cuda.diag_window_spmm.launches,
                "B3": spmm_cuda.sliding_spmm.launches,
                "B2": fused_ln.residual_layernorm.launches}
    want = REQUESTS * ROLLOUT_STEPS * PROCESS_STEPS
    log(f"  launches during serving: {launches} (want {want} each)")
    if any(v != want for v in launches.values()):
        raise AssertionError(f"kernel launch counts {launches} != {want}")
    log("  predict wall seconds per request (graph rebuild included): "
        + ", ".join(f"{w:.2f}" for w in walls))

    trajs = [np.load(workdir / f"y{k}.npy") for k in range(REQUESTS)]
    for k, t in enumerate(trajs):
        if t.shape != (ROLLOUT_STEPS, n, CHANNELS) or not np.isfinite(t).all():
            raise AssertionError(f"request {k}: trajectory {t.shape}, "
                                 f"finite={np.isfinite(t).all()}")
    log(f"  trajectories: {len(trajs)} x {trajs[0].shape}, finite")

    # One served step against the same step through the plain versions.
    sm = ServingModel(model, graph, perm, json.loads((art / "meta.json").read_text()))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    x = torch.from_numpy(inputs[0][perm]).to(device)
    model.backend = "plain"
    plain = sm.step(x).cpu().numpy()[inv]
    model.backend = "auto"
    # The served output is itself bf16-rounded: a summation-order flip one
    # layer down moves an output near max|plain| by whole ulps, and 1e-2 of
    # max|plain| is under 2 ulps low in a binade. So the step is held to
    # 2.5 bf16 ulps at max|plain| — the bf16 bound above, in its own unit.
    compare("served step vs plain versions", torch.from_numpy(trajs[0][0]),
            torch.from_numpy(plain), BF16_TOL, ulps=STEP_ULPS)

    # Per-step latency of the served model, CUDA events around each step.
    step_ms = []
    for x0 in inputs:
        x = torch.from_numpy(x0[perm]).to(device)
        for _ in range(ROLLOUT_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            x = sm.step(x)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
    log("  serve step ms (3 requests x 4 steps): "
        + ", ".join(f"{v:.3f}" for v in step_ms))
    log(f"  serve step ms: median {np.median(step_ms):.3f}, "
        f"steady median (first step of each request left out) "
        f"{np.median([v for i, v in enumerate(step_ms) if i % ROLLOUT_STEPS]):.3f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from gwen_tpu_torch.ops import fused_ln, spmm_cuda

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log("== phase 1: device")
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
        f"count {torch.cuda.device_count()}")

    log("== phase 2: build kernels")
    t0 = time.perf_counter()
    lib_path, nvcc_log = spmm_cuda.build()
    t_nvcc = time.perf_counter() - t0
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    z = torch.zeros(4, 256, device=device)
    fused_ln.residual_layernorm(z, z, z[0], z[0])
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    log(f"  nvcc {t_nvcc:.1f} s ({lib_path.name}), triton first launch {t_triton:.1f} s")

    log("== phase 3: kernels against their plain versions (L7 shapes)")
    t0 = time.perf_counter()
    graph, perm = build_serving_graph(device, torch.bfloat16)
    log(f"  L{LEVELS} graph built in {time.perf_counter() - t0:.1f} s: "
        f"nodes {graph.num_nodes}, padded {graph.num_padded_nodes}, "
        f"src rows {graph.num_src_rows}, W {graph.window_size}, "
        f"blocks {graph.num_blocks}, escape edges {graph.escape.num_edges}, "
        f"unique receivers {graph.escape.rows.shape[0]}, "
        f"esc2 S {tuple(graph.esc2_graph.s_mat.shape)}")
    results = check_kernels(graph, device)

    log("== phase 4: serve 3 requests x 4 steps through `predict`")
    with tempfile.TemporaryDirectory() as tmp:
        launches = serve(graph, perm, device, Path(tmp))

    sources = {"B1": ("diag-window SpMM with escape placement", "cuda",
                      "gwen_tpu_torch/csrc/window_spmm.cu",
                      "gwen_tpu/ops/spmm_pallas.py:909"),
               "B3": ("banded SpMM (esc2 contraction)", "cuda",
                      "gwen_tpu_torch/csrc/window_spmm.cu",
                      "gwen_tpu/ops/spmm_pallas.py:476"),
               "B2": ("residual + LayerNorm forward", "triton",
                      "gwen_tpu_torch/ops/fused_ln.py",
                      "gwen_tpu/ops/fused_ln.py:42")}
    kernels = [{"name": f"{key} {name}", "route": route, "source": src,
                "replaces": rep, "launches": launches[key], **results[key]}
               for key, (name, route, src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
