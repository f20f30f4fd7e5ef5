"""Smoke run of the PyTorch port's serving and training paths on one
NVIDIA GPU, for the GCN and the attention processor.

    python3 chip_smoke.py

Drives ``gwen_tpu_torch`` only (no JAX). Phases, each printed as it runs:

1. the device (``nvidia-smi`` name and power limit, torch's device name);
   exits non-zero when CUDA is absent;
2. builds the kernels from this checkout's sources (one nvcc for each of
   ``csrc/window_spmm.cu`` and ``csrc/window_attention.cu``, started
   together, while Triton compiles the LayerNorm forward and backward);
3. builds the L7 graph (with the attention tables) and checks each kernel
   against its plain PyTorch version at the shapes serving gives it (B1,
   B3, B2), at the train shapes, batch 4 (B4, B10, B2b on dm, dscale and
   dbias, and the diag composite's x-gradient against autograd through
   the plain versions, batched and unbatched), and for attention (B5, B6
   with its row stats, B7) at nb = 1 (a direct 2-D call), 2 and 8 (dh 128)
   and 4 (dh 64), with the attention Function's gradients against autograd
   through the plain forward: bf16 ``max|err| ≤ 1e-2·max|plain|``, the
   plain version in float32 from the same values; float32
   ``≤ 1e-5·max|plain|``. Kernel and plain are timed with CUDA events;
4. serves the GCN model: exports a seeded random-weight model (the default
   ``train-mesh graph.refine=7`` model: 1 channel, latent 256, 4 process
   steps, bf16), answers 3 ``predict`` requests of 4 steps through the CLI
   entry point, checks the launch counts (each kernel 3 × 4 × 4 = 48) and
   that no plain version ran on the card, the trajectories, and one served
   step against the plain versions (within 2.5 bf16 ulps at max|plain|),
   and times the served steps;
5. the same for the attention model (2 heads): B5 and B2 48 times each;
6. trains the GCN model: ``train-mesh graph.refine=7 train.batch_size=4``
   through the CLI entry point (11 Adam steps at full width, remat off),
   checks the loss is finite, each kernel's launch count is what the remat
   policy implies and no plain version ran on the card; checks one train
   step's loss and gradients against the same step through the plain
   versions (loss within 1e-2 relative, each gradient within
   5e-2·max|plain|: bf16 roundings compound through four process steps and
   their backward); times the batch-4 train step, then each other remat
   policy of ``REMAT_LADDER`` (held to the launch counts it implies), and
   the unbatched EPD train step (256 channels, the reference ``bench.py``
   shape) with CUDA events, with peak memory; runs one step at the default
   batch 21 with the cheapest remat policy that fits; then exports the
   trained run and answers one ``predict`` request from it;
7. the same for ``train-mesh model.processor=attention``: B5, B6, B7, B2
   and B2b 4 times per step with remat off, the step against the plain
   versions (at batch 2 if theirs does not fit at batch 4), times and peak
   memory with remat off and ``save_agg``, export and one request.

The second-to-last lines are a JSON object of the kernels and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": ...}``,
printed only when every phase passed.
"""

from __future__ import annotations

import concurrent.futures
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
TRAIN_BATCH, DEFAULT_BATCH = 4, 21
LOSS_TOL, GRAD_TOL = 1e-2, 5e-2
REMAT_LADDER = (False, "save_agg", "save_agg:2", True, "nested:2")
ATTN_HEADS = 2


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


def timed_pair(kernel, plain, iters: int = 20) -> tuple[float, float]:
    """Kernel and plain-version times, in turns (plain, kernel, kernel,
    plain) so drift on the card affects both alike."""
    p1, k1 = cuda_ms(plain, iters), cuda_ms(kernel, iters)
    k2, p2 = cuda_ms(kernel, iters), cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def build_serving_graph(device, dtype):
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      kd_patch_order, to_diag_window)

    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n)
    s2, r2, _ = apply_order(perm, s, r)
    graph = to_diag_window(build_graph(s2, r2, n), window_size=WINDOW, dtype=dtype,
                           transpose_tables=True)
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


def _serving_model(device, processor: str):
    from gwen_tpu_torch.nn import EncodeProcessDecode

    return EncodeProcessDecode(
        CHANNELS, CHANNELS, device=device, latent_size=LATENT,
        process_steps=PROCESS_STEPS, compute_dtype=torch.bfloat16,
        processor=processor, attn_heads=ATTN_HEADS,
        generator=torch.Generator().manual_seed(0)).eval()


def serve(graph, perm, device, workdir: Path, processor: str = "gcn") -> dict:
    """Phase 4: export a seeded random model, serve 3 requests through the
    CLI, check launches (and that no plain version ran on the card), the
    trajectories and one step against the plain versions; time the steps.
    The GCN step runs B1, B3 and B2, the attention step B5 and B2, each
    once per process step."""
    from gwen_tpu_torch.cli.main import main as cli
    from gwen_tpu_torch.serve import ServingModel, export_model

    n = graph.num_nodes
    model = _serving_model(device, processor)
    meta = {"levels": LEVELS, "channels": CHANNELS, "latent_size": LATENT,
            "process_steps": PROCESS_STEPS, "mlp_layers": 2, "residual": True,
            "compute_dtype": "bfloat16", "diag_window": WINDOW,
            "processor": processor, "attn_heads": ATTN_HEADS,
            "attn_pack": "auto", "nodes": n, "data": ""}
    art = export_model(model, np.zeros((n, CHANNELS), np.float32),
                       workdir / "artifact", metadata=meta)
    inputs = []
    for k in range(REQUESTS):
        x0 = np.random.default_rng(100 + k).normal(size=(n, CHANNELS)).astype(np.float32)
        np.save(workdir / f"x{k}.npy", x0)
        inputs.append(x0)

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    PLAIN_ON_CUDA["calls"] = 0
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
    launches = {key: c.launches for key, c in counters.items()}
    per = REQUESTS * ROLLOUT_STEPS * PROCESS_STEPS
    want = dict.fromkeys(counters, 0)
    want.update(dict.fromkeys(("B5", "B2") if processor == "attention"
                              else ("B1", "B3", "B2"), per))
    log(f"  launches during serving: {launches} (want {want}); plain "
        f"versions called on CUDA tensors: {PLAIN_ON_CUDA['calls']}")
    if launches != want or PLAIN_ON_CUDA["calls"]:
        raise AssertionError(f"kernel launch counts {launches} != {want}, or a "
                             "plain version ran on the card")
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
    compare(f"served {processor} step vs plain versions",
            torch.from_numpy(trajs[0][0]), torch.from_numpy(plain), BF16_TOL,
            ulps=STEP_ULPS)

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
    log(f"  serve {processor} step ms (3 requests x 4 steps): "
        + ", ".join(f"{v:.3f}" for v in step_ms))
    log(f"  serve {processor} step ms: median {np.median(step_ms):.3f}, "
        f"steady median (first step of each request left out) "
        f"{np.median([v for i, v in enumerate(step_ms) if i % ROLLOUT_STEPS]):.3f}")
    return launches


def check_train_kernels(graph, device, batch: int = TRAIN_BATCH) -> dict:
    """Phase 3 at train shapes: B4, B10 and B2b against their plain
    versions, and the diag composite's x-gradient against autograd through
    the plain versions."""
    from gwen_tpu_torch.ops import fused_ln, spmm_cuda

    gen = torch.Generator(device=device).manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    f = LATENT
    u = graph.escape.rows.shape[0]
    g2 = graph.esc2_graph
    graph32 = dataclasses.replace(graph, s_mat=graph.s_mat.float())
    g2_32 = dataclasses.replace(g2, s_mat=g2.s_mat.float())
    results = {}

    # B4: batched diag-window SpMM with escape placement.
    x, fix = randn(batch, graph.num_padded_nodes, f), randn(batch, u, f)
    want = spmm_cuda.diag_window_spmm_plain(graph32, x.float(), fix.float())
    err = compare("B4 bf16", spmm_cuda.diag_window_spmm_b(graph, x, fix), want,
                  BF16_TOL)
    compare("B4 f32", spmm_cuda.diag_window_spmm_b(graph32, x.float(), fix.float()),
            want, F32_TOL)
    ms, plain_ms = timed_pair(lambda: spmm_cuda.diag_window_spmm_b(graph, x, fix),
                              lambda: spmm_cuda.diag_window_spmm_plain(graph, x, fix))
    results["B4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    del want

    # B10: batched banded SpMM on the esc2 graph.
    x2 = randn(batch, g2.num_nodes, f)
    want = spmm_cuda.sliding_spmm_plain(g2_32, x2.float())
    err = compare("B10 bf16", spmm_cuda.sliding_spmm_b(g2, x2), want, BF16_TOL)
    compare("B10 f32", spmm_cuda.sliding_spmm_b(g2_32, x2.float()), want, F32_TOL)
    ms, plain_ms = timed_pair(lambda: spmm_cuda.sliding_spmm_b(g2, x2),
                              lambda: spmm_cuda.sliding_spmm_plain(g2, x2))
    results["B10"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # B2b: LayerNorm backward over the batch's padded rows.
    rows = batch * graph.num_padded_nodes
    m, g = randn(rows, f), randn(rows, f)
    sc = randn(f, dtype=torch.float32)
    w_dm, w_ds, w_db = fused_ln.residual_layernorm_bwd_plain(m.float(), g.float(), sc)
    errs = []
    for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        dm, ds, db = fused_ln.residual_layernorm_bwd(m.to(dt), g.to(dt), sc)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        errs.append(compare(f"B2b {name} dm", dm, w_dm, tol))
        compare(f"B2b {name} dscale", ds, w_ds, tol)
        compare(f"B2b {name} dbias", db, w_db, tol)
    ms, plain_ms = timed_pair(lambda: fused_ln.residual_layernorm_bwd(m, g, sc),
                              lambda: fused_ln.residual_layernorm_bwd_plain(m, g, sc))
    results["B2b"] = dict(max_abs_err=errs[0], ms=ms, plain_ms=plain_ms)
    del m, g, w_dm

    # The composite's x-gradient (B1/B3 unbatched, B4/B10 batched) against
    # autograd through the plain versions, float32 from the same values.
    for shape in ((graph.num_padded_nodes, f), (batch, graph.num_padded_nodes, f)):
        x = randn(*shape).requires_grad_()
        cot = randn(*shape, dtype=torch.float32)
        (gx,) = torch.autograd.grad(
            (spmm_cuda.spmm_diag_window(graph, x).float() * cot).sum(), x)
        x32 = x.detach().float().requires_grad_()
        (want,) = torch.autograd.grad(
            (spmm_cuda.spmm_diag_window(graph32, x32, plain=True) * cot).sum(), x32)
        compare(f"composite x-grad {tuple(shape)}", gx, want, BF16_TOL)
    torch.cuda.synchronize()
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return results


def check_attention_kernels(graph, device) -> dict:
    """Phase 3 for attention: B5 (forward), B6 (dQ and the row stats) and
    B7 (dK, dV) against their plain versions at the L7 shapes: nb = 1
    through a direct 2-D call, nb = 2 (serving: 2 heads) and nb = 8
    (training: 2 heads × batch 4) at dh 128, nb = 4 at dh 64 (4 heads);
    then the autograd Function's gradients against autograd through the
    plain forward. Each kernel is timed beside its plain version at nb = 1,
    2 and 8."""
    from gwen_tpu_torch.ops import attention_cuda as ac
    from gwen_tpu_torch.ops.attention import windowed_attention

    gen = torch.Generator(device=device).manual_seed(3)
    n = graph.num_nodes

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    results, times = {}, {}
    for lead, dh in (((), 128), ((2,), 128), ((8,), 128), ((4,), 64)):
        tag = f"nb={lead[0] if lead else 1}{'' if lead else ' (2-D)'} dh={dh}"
        q, k, v, g = (randn(*lead, n, dh) for _ in range(4))
        scale = dh ** -0.5
        f32 = [t.float() for t in (q, k, v, g)]
        want = ac.attention_fwd_plain(graph, *f32[:3], scale)
        w_dq, w_st = ac.attention_dq_plain(graph, *f32, scale)
        w_dk, w_dv = ac.attention_dkdv_plain(graph, *f32, w_st, scale)
        errs = {}
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            name = "bf16" if dt == torch.bfloat16 else "f32"
            a = [t.to(dt) for t in (q, k, v, g)]
            errs[("B5", name)] = compare(f"B5 {name} {tag}",
                                         ac.attention_fwd(graph, *a[:3], scale),
                                         want, tol)
            dq, st = ac.attention_dq(graph, *a, scale)
            errs[("B6", name)] = compare(f"B6 {name} {tag} dq", dq, w_dq, tol)
            for i, stat in enumerate(("mx", "den", "delta")):
                compare(f"B6 {name} {tag} {stat}", st[..., i], w_st[..., i], tol)
            dk, dv = ac.attention_dkdv(graph, *a, st, scale)
            errs[("B7", name)] = max(
                compare(f"B7 {name} {tag} dk", dk, w_dk, tol),
                compare(f"B7 {name} {tag} dv", dv, w_dv, tol))
        del want, w_dq, w_dk, w_dv, f32
        nb = lead[0] if lead else 1
        if dh == 128:
            iters = 20 if nb < 8 else 5
            st = ac.attention_dq(graph, q, k, v, g, scale)[1]
            p_st = ac.attention_dq_plain(graph, q, k, v, g, scale)[1]
            pairs = {
                "B5": (lambda: ac.attention_fwd(graph, q, k, v, scale),
                       lambda: ac.attention_fwd_plain(graph, q, k, v, scale)),
                "B6": (lambda: ac.attention_dq(graph, q, k, v, g, scale),
                       lambda: ac.attention_dq_plain(graph, q, k, v, g, scale)),
                "B7": (lambda: ac.attention_dkdv(graph, q, k, v, g, st, scale),
                       lambda: ac.attention_dkdv_plain(graph, q, k, v, g, p_st,
                                                       scale)),
            }
            for key, (kern, plain) in pairs.items():
                ms, plain_ms = timed_pair(kern, plain, iters)
                times[(key, nb)] = (ms, plain_ms)
                log(f"  {key} nb={nb}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            # JSON rows: the unbatched form at nb = 1; B5b at the serving
            # shape, B6b and B7b at the batch-4 train shape.
            rows = {1: {"B5": "B5", "B6": "B6", "B7": "B7"}, 2: {"B5": "B5b"},
                    8: {"B6": "B6b", "B7": "B7b"}}[nb]
            for key, row in rows.items():
                ms, plain_ms = times[(key, nb)]
                results[row] = dict(max_abs_err=errs[(key, "bf16")], ms=ms,
                                    plain_ms=plain_ms)
        del q, k, v, g
        torch.cuda.empty_cache()

    # The Function's gradients (B6 then B7 on the cotangent) against autograd
    # through the plain forward, float32 from the same values.
    for lead in ((), (8,)):
        ts = [randn(*lead, n, 128).requires_grad_() for _ in range(3)]
        cot = randn(*lead, n, 128).float()
        got = torch.autograd.grad(
            (windowed_attention(graph, *ts).float() * cot).sum(), ts)
        t32 = [t.detach().float().requires_grad_() for t in ts]
        want = torch.autograd.grad(
            (windowed_attention(graph, *t32, backend="plain") * cot).sum(), t32)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            compare(f"Function {name} nb={lead[0] if lead else 1} vs autograd "
                    "through the plain forward", a, b, BF16_TOL)
        del ts, cot, got, t32, want
    torch.cuda.empty_cache()
    return results


def expected_launches(remat, process_steps: int, processor: str = "gcn") -> dict:
    """Kernel launches per batched train step under a remat policy.

    GCN: each aggregation runs B4 and B10 once forward and once backward,
    plus once per recompute of its step. Attention: each step runs B5 once
    per forward or recompute, B6 and B7 once. Each LayerNorm runs B2 once
    per forward or recompute and B2b once. ``save_agg`` keeps the GCN
    aggregation output (no recompute) but recomputes the attention block
    around its kept output, not the LayerNorm after it. Under ``nested:G`` a
    group's recompute stops once the tensors it needs are rebuilt (torch's
    non-reentrant checkpoint), so the group's last step is recomputed once,
    the others twice."""
    from gwen_tpu_torch.nn.gnn import parse_remat

    kind, k = parse_remat(remat, process_steps)
    s = process_steps
    groups = -(-s // k) if kind == "nested" else 0
    saved = min(k, s) if kind == "save_agg" else 0
    recompute = {"none": 0, "full": s, "save_agg": s,
                 "nested": 2 * s - groups}[kind]
    out = dict.fromkeys(("B1", "B3", "B4", "B10", "B5", "B6", "B7"), 0)
    if processor == "attention":
        out.update(B5=s + recompute, B6=s, B7=s, B2=s + recompute - saved,
                   B2b=s)
    else:
        agg = 2 * s + recompute - saved
        out.update(B4=agg, B10=agg, B2=s + recompute, B2b=s)
    return out


def _counters() -> dict:
    from gwen_tpu_torch.ops import attention_cuda, fused_ln, spmm_cuda

    return {"B1": spmm_cuda.diag_window_spmm, "B3": spmm_cuda.sliding_spmm,
            "B4": spmm_cuda.diag_window_spmm_b, "B10": spmm_cuda.sliding_spmm_b,
            "B2": fused_ln.residual_layernorm,
            "B2b": fused_ln.residual_layernorm_bwd,
            "B5": attention_cuda.attention_fwd, "B6": attention_cuda.attention_dq,
            "B7": attention_cuda.attention_dkdv}


# Calls of a kernel's plain version with a CUDA tensor: the main paths must
# make none (a wrapper takes its plain version only for CPU tensors).
PLAIN_ON_CUDA = {"calls": 0}


def count_plain_calls_on_cuda() -> None:
    """Wrap every kernel's plain version so that each call with a CUDA
    tensor adds one to ``PLAIN_ON_CUDA``."""
    from gwen_tpu_torch.ops import attention_cuda, fused_ln, spmm_cuda

    # window_spmm_plain sits under the plain versions of B1, B3, B4, B10.
    plains = ((spmm_cuda, ("window_spmm_plain",)),
              (fused_ln, ("residual_layernorm_plain",
                          "residual_layernorm_bwd_plain")),
              (attention_cuda, ("attention_fwd_plain", "attention_dq_plain",
                                "attention_dkdv_plain")))
    for mod, names in plains:
        for name in names:
            def counted(*args, _fn=getattr(mod, name), **kwargs):
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in (*args, *kwargs.values())):
                    PLAIN_ON_CUDA["calls"] += 1
                return _fn(*args, **kwargs)
            setattr(mod, name, counted)


def _train_model(device, channels: int, remat=False, processor: str = "gcn"):
    from gwen_tpu_torch.nn import EncodeProcessDecode

    return EncodeProcessDecode(
        channels, channels, device=device, latent_size=LATENT,
        process_steps=PROCESS_STEPS, compute_dtype=torch.bfloat16, remat=remat,
        processor=processor, attn_heads=ATTN_HEADS,
        generator=torch.Generator().manual_seed(0))


def _step_ms(step, iters: int = 5) -> float:
    """Mean ms of ``step()`` (CUDA events around ``iters`` steps, after one
    warm-up step)."""
    step()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _adam_step(model, graph, x, y):
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    def step():
        loss = torch.mean((model(graph, x) - y) ** 2)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    return step


def _against_plain_step(model, graph, x, y) -> None:
    """One train step's loss and gradients through the kernels against the
    same step through the plain versions."""
    def loss_grads(backend):
        model.backend = backend
        model.zero_grad(set_to_none=True)
        loss = torch.mean((model(graph, x) - y) ** 2)
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    lk, gk = loss_grads("auto")
    lp, gp = loss_grads("plain")
    model.backend = "auto"
    log(f"  train step loss (batch {x.shape[0]}): kernels {lk:.6g}, plain "
        f"versions {lp:.6g}")
    if not (math.isfinite(lk) and abs(lk - lp) <= LOSS_TOL * abs(lp)):
        raise AssertionError(f"train step loss {lk} vs plain {lp}")
    # A key bias shifts every score of a row alike and softmax ignores it:
    # its gradient is rounding noise on both sides, held to that only.
    noise = [k for k in gp if k.endswith("attn.wk.b")]
    scale = max(g.float().abs().max().item() for g in gp.values())
    for k in noise:
        worst = max(gk[k].float().abs().max().item(), gp[k].float().abs().max().item())
        log(f"  grad {k}: max|grad| {worst:.3g}, zero but for rounding "
            f"(bound 1e-3 of the largest gradient, {1e-3 * scale:.3g})")
        if worst > 1e-3 * scale:
            raise AssertionError(f"{k}: gradient {worst} is not rounding noise")
    held = [k for k in gp if k not in noise]
    worst = max(((gk[k].float() - gp[k].float()).abs().max().item()
                 / max(gp[k].float().abs().max().item(), 1e-30), k) for k in held)
    log(f"  gradients: worst max|err|/max|plain| {worst[0]:.3g} ({worst[1]}), "
        f"bound {GRAD_TOL:g}")
    for k in held:
        compare(f"grad {k}", gk[k], gp[k], GRAD_TOL)


def train(graph, device, workdir: Path, processor: str = "gcn") -> dict:
    """Phase 5: train through the CLI (launch counts per step as remat off
    implies, no plain version on the card), one step against the plain
    versions, step times and peak memory, export and serve."""
    import contextlib
    import io

    from gwen_tpu_torch.cli.main import main as cli
    from gwen_tpu_torch.registry import Run
    from gwen_tpu_torch.serve import export_model, model_from_metadata

    attention = processor == "attention"
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    PLAIN_ON_CUDA["calls"] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(["train-mesh", f"graph.refine={LEVELS}",
                  f"model.processor={processor}",
                  f"train.batch_size={TRAIN_BATCH}",
                  f"run.registry_root={workdir / 'runs'}", "--device", str(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if rc != 0:
        raise AssertionError(f"train-mesh returned {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    steps = out["steps"]
    log(f"  train-mesh: {json.dumps(out)}")
    log(f"  wall {wall:.1f} s (synthetic L{LEVELS} data, graph build and "
        f"{steps} steps)")
    if steps < 8 or not math.isfinite(out["best_train_loss"]):
        raise AssertionError(f"train-mesh ran {steps} steps, best loss "
                             f"{out['best_train_loss']}")
    if out["layout"] != "DiagWindowGraph":
        raise AssertionError(f"train-mesh took the {out['layout']} path")
    per_step = expected_launches(False, PROCESS_STEPS, processor)
    want = {k: v * steps for k, v in per_step.items()}
    log(f"  launches during training: {launches} (want {want}); plain versions "
        f"called on CUDA tensors: {PLAIN_ON_CUDA['calls']}")
    if launches != want or PLAIN_ON_CUDA["calls"]:
        raise AssertionError(f"kernel launch counts {launches} != {want}, or a "
                             "plain version ran on the card")
    losses = [r["value"] for r in Run(Path(out["run_dir"])).metrics("train_loss")]
    log(f"  logged train losses: {losses}")

    # One train step against the same step through the plain versions, at
    # batch 4, or at batch 2 where the plain versions' step does not fit.
    n = graph.num_nodes
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(TRAIN_BATCH, n, CHANNELS)).astype(np.float32)).to(device)
    y = 0.9 * x + 0.1
    model = _train_model(device, CHANNELS, processor=processor)
    try:
        _against_plain_step(model, graph, x, y)
    except torch.cuda.OutOfMemoryError:
        log(f"  the plain versions' step at batch {TRAIN_BATCH} is out of "
            "memory; comparing at batch 2")
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        _against_plain_step(model, graph, x[:2], y[:2])
    torch.cuda.empty_cache()

    # Train-step time and peak memory: batch 4 (kernels, then plain).
    timing = {}
    for backend in ("auto", "plain"):
        model.backend = backend
        torch.cuda.reset_peak_memory_stats()
        try:
            ms = _step_ms(_adam_step(model, graph, x, y))
        except torch.cuda.OutOfMemoryError:
            log(f"  batch-{TRAIN_BATCH} {processor} train step ({backend}): out "
                "of memory")
            torch.cuda.empty_cache()
            continue
        timing[backend] = (ms, torch.cuda.max_memory_allocated())
    model.backend = "auto"
    for backend, (ms, peak) in timing.items():
        log(f"  batch-{TRAIN_BATCH} {processor} train step ({backend}): "
            f"{ms:.3f} ms, peak memory {peak / 2**30:.2f} GiB")
    del model
    torch.cuda.empty_cache()

    # The other remat policies: launches per step as each implies, time.
    for remat in (False, "save_agg") if attention else REMAT_LADDER[1:]:
        mr = _train_model(device, CHANNELS, remat=remat, processor=processor)
        step = _adam_step(mr, graph, x, y)
        for c in counters.values():
            c.launches = 0
        step()
        got = {k: c.launches for k, c in counters.items()}
        if got != expected_launches(remat, PROCESS_STEPS, processor):
            raise AssertionError(
                f"remat={remat!r}: launches {got} != "
                f"{expected_launches(remat, PROCESS_STEPS, processor)}")
        torch.cuda.reset_peak_memory_stats()
        ms = _step_ms(step)
        log(f"  batch-{TRAIN_BATCH} {processor} train step, remat={remat!r}: "
            f"{ms:.3f} ms, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"per step { {k: v for k, v in got.items() if v} }")
        del mr, step
    torch.cuda.empty_cache()

    if not attention:
        # The unbatched EPD train step at 256 channels (bench.py's shape).
        for c in counters.values():
            c.launches = 0
        x1 = torch.from_numpy(rng.normal(size=(n, LATENT)).astype(np.float32)).to(device)
        m1 = _train_model(device, LATENT)
        torch.cuda.reset_peak_memory_stats()
        ms1 = _step_ms(_adam_step(m1, graph, x1, 0.9 * x1))
        log(f"  unbatched EPD train step ({LATENT} channels): {ms1:.3f} ms, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{ {k: c.launches for k, c in counters.items()} }")
        if counters["B1"].launches == 0 or counters["B3"].launches == 0:
            raise AssertionError("the unbatched train step did not run B1/B3")
        del m1, x1

        # One step at the default batch with the cheapest remat policy that
        # fits.
        xb = torch.from_numpy(rng.normal(size=(DEFAULT_BATCH, n, CHANNELS)).astype(np.float32)).to(device)
        for remat in REMAT_LADDER:
            mb = _train_model(device, CHANNELS, remat=remat)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                step = _adam_step(mb, graph, xb, 0.9 * xb)
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError:
                log(f"  batch {DEFAULT_BATCH}, remat={remat!r}: out of memory")
                del mb
                continue
            log(f"  batch {DEFAULT_BATCH}, remat={remat!r}: fits, first step "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
                f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
            break
        else:
            raise AssertionError(f"no remat policy fits batch {DEFAULT_BATCH}")
        del mb, xb

    # Training feeds serving: export the trained run, answer one request.
    params, cfg = Run(Path(out["run_dir"])).load_model()
    trained = model_from_metadata(cfg, device)
    trained.load_state_dict(params)
    if trained.processor != processor:
        raise AssertionError(f"the saved run reloads as {trained.processor}")
    art = export_model(trained, np.zeros((n, CHANNELS), np.float32),
                       workdir / "trained", metadata=cfg)
    x0 = rng.normal(size=(n, CHANNELS)).astype(np.float32)
    np.save(workdir / "x_trained.npy", x0)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli(["predict", "--artifact", str(art), "--input",
                  str(workdir / "x_trained.npy"), "--steps", "2", "--out",
                  str(workdir / "y_trained.npy"), "--device", str(device)])
    traj = np.load(workdir / "y_trained.npy")
    if rc != 0 or traj.shape != (2, n, CHANNELS) or not np.isfinite(traj).all():
        raise AssertionError(f"predict from the trained run: rc {rc}, "
                             f"{traj.shape}, finite={np.isfinite(traj).all()}")
    log(f"  predict from the trained {processor} run: {traj.shape}, finite")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from gwen_tpu_torch.ops import attention_cuda, fused_ln, spmm_cuda

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
    # One nvcc per CUDA source, started together, while Triton compiles the
    # LayerNorm kernels on their first launches.
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        nvcc_jobs = [pool.submit(spmm_cuda.build), pool.submit(attention_cuda.build)]
        z = torch.zeros(4, 256, device=device)
        fused_ln.residual_layernorm(z, z, z[0], z[0])
        fused_ln.residual_layernorm_bwd(z, z, z[0])
        torch.cuda.synchronize()
        t_triton = time.perf_counter() - t0
        built = [job.result() for job in nvcc_jobs]
    t_build = time.perf_counter() - t0
    for _, nvcc_log in built:
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"  nvcc (x{len(built)}) and triton together {t_build:.1f} s "
        f"({', '.join(path.name for path, _ in built)}), triton first "
        f"launches {t_triton:.1f} s")
    count_plain_calls_on_cuda()

    log("== phase 3: kernels against their plain versions (L7 shapes)")
    t0 = time.perf_counter()
    graph, perm = build_serving_graph(device, torch.bfloat16)
    log(f"  L{LEVELS} graph built in {time.perf_counter() - t0:.1f} s: "
        f"nodes {graph.num_nodes}, padded {graph.num_padded_nodes}, "
        f"src rows {graph.num_src_rows}, W {graph.window_size}, "
        f"blocks {graph.num_blocks}, escape edges {graph.escape.num_edges}, "
        f"unique receivers {graph.escape.rows.shape[0]}, "
        f"esc2 S {tuple(graph.esc2_graph.s_mat.shape)}, attention lists "
        f"{tuple(graph.attn_nbr.shape)} and {tuple(graph.attn_nbr_t.shape)}")
    results = check_kernels(graph, device)
    log(f"  train shapes, batch {TRAIN_BATCH}:")
    results.update(check_train_kernels(graph, device))
    log("  attention (B5, B6, B7):")
    results.update(check_attention_kernels(graph, device))

    log("== phase 4: serve 3 requests x 4 steps through `predict` (GCN)")
    with tempfile.TemporaryDirectory() as tmp:
        launches = serve(graph, perm, device, Path(tmp))

    log("== phase 5: serve 3 requests x 4 steps through `predict` (attention)")
    with tempfile.TemporaryDirectory() as tmp:
        launches["B5"] = serve(graph, perm, device, Path(tmp), "attention")["B5"]

    log(f"== phase 6: train through `train-mesh` (GCN, batch {TRAIN_BATCH}), "
        "time, export, serve")
    with tempfile.TemporaryDirectory() as tmp:
        launches.update({k: v for k, v in train(graph, device, Path(tmp)).items()
                         if k in ("B4", "B10", "B2b")})

    log(f"== phase 7: train through `train-mesh model.processor=attention` "
        f"(batch {TRAIN_BATCH}), time, export, serve")
    with tempfile.TemporaryDirectory() as tmp:
        launches.update({k: v for k, v in train(graph, device, Path(tmp),
                                                "attention").items()
                         if k in ("B6", "B7")})

    spmm, ln = "gwen_tpu/ops/spmm_pallas.py", "gwen_tpu/ops/fused_ln.py"
    att = "gwen_tpu/ops/attention_pallas.py"
    cu, tr = "gwen_tpu_torch/csrc/window_spmm.cu", "gwen_tpu_torch/ops/fused_ln.py"
    acu = "gwen_tpu_torch/csrc/window_attention.cu"
    one = "; one kernel for both forms, one count"
    sources = {"B1": ("diag-window SpMM with escape placement", "cuda", cu,
                      f"{spmm}:909"),
               "B3": ("banded SpMM (esc2 contraction)", "cuda", cu,
                      f"{spmm}:476"),
               "B2": ("residual + LayerNorm forward", "triton", tr, f"{ln}:42"),
               "B4": ("batched diag-window SpMM with escape placement", "cuda",
                      cu, f"{spmm}:1138"),
               "B10": ("batched banded SpMM (esc2 contraction)", "cuda", cu,
                       f"{spmm}:609"),
               "B2b": ("residual + LayerNorm backward", "triton", tr,
                       f"{ln}:59"),
               "B5": (f"windowed attention forward (nb = 1{one})", "cuda",
                      acu, f"{att}:522"),
               "B5b": (f"batched windowed attention forward (nb = 2{one})",
                       "cuda", acu, f"{att}:619"),
               "B6": (f"attention dQ and row stats (nb = 1{one})", "cuda", acu,
                      f"{att}:771"),
               "B6b": (f"batched attention dQ and row stats (nb = 8{one})",
                       "cuda", acu, f"{att}:875"),
               "B7": (f"attention dK and dV (nb = 1{one})", "cuda", acu,
                      f"{att}:1053"),
               "B7b": (f"batched attention dK and dV (nb = 8{one})", "cuda",
                       acu, f"{att}:1216")}
    kernels = [{"name": f"{key} {name}", "route": route, "source": src,
                "replaces": rep,
                "launches": launches[key[:-1] if key in ("B5b", "B6b", "B7b") else key],
                **results[key]}
               for key, (name, route, src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
