"""Smoke run of the PyTorch port's serving, training, ensemble,
partitioned, block-tile and member-graph paths on one NVIDIA GPU, for the
GCN, attention and interaction processors.

    python3 chip_smoke.py

Drives ``gwen_tpu_torch`` only (no JAX); its timers are
``gwen_tpu_torch.profiling``'s. Phases, each printed as it runs:

1. the device (``nvidia-smi`` name and power limit, torch's device name);
   exits non-zero when CUDA is absent;
2. builds the kernels from this checkout's sources (one nvcc for each of
   ``csrc/window_spmm.cu``, ``csrc/window_attention.cu``,
   ``csrc/window_unfused.cu`` and ``csrc/edge_sum.cu``, started together, while Triton compiles the
   LayerNorm forward and backward);
3. builds the L7 graph (with the attention tables) and checks each kernel
   against its plain PyTorch version at the shapes serving gives it (B1,
   also timed with no fix rows, B3, timed by its device kernels under
   ``torch.profiler``, B2), at the train shapes, batch 4 (B4, B10, B2b on dm, dscale and
   dbias, and the diag composite's x-gradient against autograd through
   the plain versions, batched and unbatched), and for attention (B5, B6
   with its row stats, B7) at nb = 1 (a direct 2-D call), 2 and 8 (dh 128)
   and 4 (dh 64), each B6 and B7 call repeated for the same bits (no
   atomics), B5, B6 and B7 also timed by their device kernels, with the
   attention Function's gradients against autograd through the plain
   forward, then B5, B6 and B7 on an L5 graph whose lists are wider than
   their register chunk, with a block of rows with no source (bf16 and
   float32, nb 1, 2, 3, 8, q, k and v short of the nodes), at window 384
   and at window 2048 with a hub row listing its whole window (a list of
   2,048 entries); then builds the bit-packed L7 graphs (the
   diag layout in the same KD order, the RCM banded layout at block 256)
   and checks packed B1 (F 256, also timed with no fix rows), packed B4
   (batch 4) and B13 (F 256 and batch 4), the packed composites'
   x-gradients against autograd through
   the plain versions, and the packed diag composite against the unpacked
   one; then the row gathers on two L5 graphs in RCM order (correctness
   only): B13 and B11 in its six operand modes on a hub graph (a row of
   601 nonzeros) and on a graph with an empty destination block (B11 also
   with the blocks reversed: starts not monotone), on fewer x rows than
   the layout's sources and at batch 5; then B4, packed B4 and B10 (the row
   gathers with the escape epilogue; correctness only) on an L5 graph in
   KD-patch order with a hub row (~280 in-window nonzeros), a block of 100
   escape rows and an empty block, at batch 1, 3, 5 and 16, F 8 and 264 in
   bf16 and F 4 and 132 in float32, a float32 x on the bf16 S at F 4, with
   no fix rows, and B4 on a halo-diag local graph (``n_pad`` rows, the
   halo-extended sources); the same for B1, packed B1 and B1 on a runtime
   S (``window_matvec``, on the graph's mask and on every window column)
   with a 2-d x (the gathers' batch-1 walk); then the unfused operators:
   B8, B9 (nb 1), B9b (nb 2 and 8) and ``diag_matvec`` (B1 on a runtime S,
   timed on the window mask's pattern beside its bound and
   ``torch.sparse.mm`` on that pattern) at f 128 and 256, B8 and B9b on an
   L5 graph (up to 11 covering blocks a source block) at f 264 and nb 3
   with operands 100 rows short, the gradients of
   ``diag_matvec`` and ``diag_sddmm`` against autograd through the plain
   versions, and ``aggregate`` on a float32 ``(4, N, 1)`` field over the
   bf16 and the packed diag graph; then the int8 rank-1 form of B3 and B10
   on the RCM band (the dense row gather with both scales inside; B3r,
   B10r), unbatched and at batch 4: one launch a call, against its plain
   version (one rounding) and ``aggregate_segment`` at the bf16 tolerance,
   its x-gradient against autograd through the plain version, timed beside
   its bound and ``torch.sparse.mm`` on the weighted operator: bf16
   ``max|err| ≤ 1e-2·max|plain|``, the plain version in float32 from the
   same values; float32
   ``≤ 1e-5·max|plain|``. Kernel and plain are timed with CUDA events
   (packed kernels beside unpacked B1/B4 too); beside each kernel its bound
   (the larger of its bytes over 3.35 TB/s and its useful operations over
   the peak rate of its type) and, where one PyTorch call computes the same
   function, that call's time (``torch.sparse.mm`` on the same operator as
   a CSR tensor for the SpMM kernels and, transposed, for B9 and B9b,
   ``torch.sparse.sampled_addmm`` for B8, ``F.layer_norm`` plus the add and
   its autograd backward for B2 and B2b, ``scaled_dot_product_attention``
   on a dense mask and its backward for B5 to B7; the port never calls
   them). A
   fixed sparse operator counts in its kernel's bound as its nonzeros with
   their indices, not as the dense tile the layout stores; the time to
   read the operator as stored (a floor for a kernel that must read it
   whole) is printed beside the bound;
4. serves the GCN model: exports a seeded random-weight model (the default
   ``train-mesh graph.refine=7`` model: 1 channel, latent 256, 4 process
   steps, bf16), answers 3 ``predict`` requests of 4 steps through the CLI
   entry point, checks the launch counts (each kernel 3 × 4 × 4 = 48) and
   that no plain version ran on the card, the trajectories, and one served
   step against the plain versions (within 2.5 bf16 ulps at max|plain|),
   times the served steps and profiles one (``torch.profiler``: the busy
   share and the kernels by device time);
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
   batch 21 with the cheapest remat policy that fits; then ``export``
   (the CLI, on the run's registry root) writes the trained run's artifact
   (``rollout_steps`` 4, ``node_perm.npy`` the permutation
   ``ServingModel.load`` computes), one ``predict`` request of 2 steps is
   answered from it with every count from 0 (B1, B3 and B2 each 2 × 4, no
   other kernel, no plain version on the card), and ``runs`` lists the run
   with its best metric;
7. the same for ``train-mesh model.processor=attention``: B5, B6, B7, B2
   and B2b 4 times per step with remat off, the step against the plain
   versions (at batch 2 if theirs does not fit at batch 4), times and peak
   memory with remat off and ``save_agg``, one step under ``torch.profiler``
   with B6's and B7's share, ``export``, one request (B5 and B2 each
   2 × 4) and ``runs``;
8. trains on the bit-packed layouts: ``train-mesh graph.refine=7
   train.batch_size=4`` with ``mesh.kernel=diag_packed`` (GCN: packed B4
   and B10 8 times per step, B2 and B2b 4; attention: B5, B6, B7, B2, B2b
   4) and ``mesh.kernel=packed`` (GCN: B13 8 times per step), each with no
   plain version on the card, one step against the plain versions, step
   time and peak memory; then the unbatched 256-channel EPD step on
   ``diag_packed`` (packed B1);
9. the unfused operators and the ensemble paths at full width:
   ``windowed_attention(backend="unfused")`` forward and backward at the
   L7 attention shapes (nb 2, dh 128, bf16) against ``backend="auto"``,
   with the launch counts its item loop implies (B8, B9 and B1 twice per
   item) and a batched ``diag_spmm_t`` (B9b); then ``train-mesh
   graph.refine=7 train.batch_size=4`` with ``train.loss=crps-ensemble``
   (16 items a step; B4 and B10 10 times per step, two of them the noise
   smoothing on a float32 field), with ``train.rollout_horizon=2`` and with
   ``model.processor=interaction`` at the largest batch of 1, 2, 4 that
   fits without remat, each to its end with finite skill numbers, no plain
   version on the card, step time and peak memory. Every ``train-mesh``
   run of phases 6 to 10 ends with the skill verification of a generated
   ensemble (``skill_*`` in its JSON line), whose launches are counted
   with the run's;
10. the partitioned path on one rank: B11 (windowed-dense SpMM) and B12
   (blocked-ELL SpMM) on the L7 mesh in RCM order at F 256, unbatched and
   at batch 4, B12 in bf16 and float32, B11 in its six operand modes
   (float32, bf16, each S type under the other x, int8 S01 under either),
   and on one partition's halo-extended, non-square operator, each
   against its plain version, with times, bound and ``torch.sparse.mm`` on
   the same operator, and B12 once more in the serving graph's KD-patch
   order; B10 on the ``sliding`` partition's wide window at batch 4 (B11's
   row gather), checked and timed the same way; then ``train-mesh graph.refine=7 train.batch_size=4
   mesh.force_partition=true`` with ``mesh.partition_layout`` ``sliding``
   (B10 8 times per step), ``diag`` (B4 and B10 8), ``dense`` (B11 8),
   ``ell`` (B12 8) and ``model.processor=attention`` on ``diag`` (B5, B6,
   B7, B2, B2b 4), each with no plain version on the card and finite skill
   numbers; then on that rank's graph, at the shapes the run gave them
   (batch 4, the halo-extended rows), ``aggregate_halo`` (bf16 and
   float32) or ``attend_halo`` with its gradients against the plain
   versions, one train step's loss and gradients against the same step
   through the plain versions, the step time and peak memory, and one
   step under ``torch.profiler``. One rank: the halos are
   zero rows and no collective runs; whether a 1-rank NCCL group on this
   host carries ``all_reduce`` and ``all_gather`` is probed last (a child
   process; logged, not held: after it this process's profiler traces
   lose device events);
11. the last kernel and the stored-data paths: B14 (block-tile SpMM) on the
   L7 mesh in RCM and in KD-patch order at F 256, unbatched, at batch 4 and
   at batch 5 (not timed), bf16 and float32, on an L5 graph with a hub row
   of ~300 live slots (more than the batched walk's list holds), on a
   float32 field of F 1 and 3, on a ``num_src``-extended operator, and the
   x-gradient of
   ``spmm_block_tiles``, each against its plain version, with times, the
   bound (x, the output and the tables as stored) and ``torch.sparse.mm``
   on the same operator, held to the kernel first; ``aggregate`` on the
   int8 rank-1 layout forward and backward, unbatched and at batch 4, with
   every count from 0 (B3r 4, nothing else); then the EPD model on the
   ``BlockTileGraph``:
   3 x 4 served steps (B14 and B2 4 launches per step), 5 Adam steps at
   batch 4 through ``Trainer`` (B14 8 per step, B2 and B2b 4), one served
   step and one train step against the plain versions, no plain version on
   the card, and one forward on the L7 multimesh (finest level through B12)
   against the union as one COO graph; ``make-mesh-data`` → ``train-mesh
   --data`` at ``graph.refine=7`` (launch counts as phase 6, finite skill
   numbers), again with ``data.lazy=true``, then ``export --data`` and
   ``predict`` with the graph rebuilt from the store (checked as phase 6);
   ``preprocess`` → ``train-gnn --no-animate`` on a raw store of 125
   members x 16,384 features written here (hidden 1024, batch 4) and
   ``train-cnn --no-animate`` on its stores (batch 21), launched together,
   each under ``python -m torch.distributed.run --nproc_per_node 1`` as the
   data-parallel runs are launched (one rank: no process group): their
   wall seconds, finite losses and rank 0's runs in the registry; ten
   train steps at its shapes, each timed by CUDA events and by the host
   (``StepTimer``, and the host's enqueue), with Python's garbage
   collector on and then off: the median, the spread, the card's clock
   and power before and after, and one step's profile; then ``train-cnn
   --no-animate`` on the same stores (124 input members as channels, 1
   target, height 32 x ncells 512) with the UNet at its default width
   (hidden 64, depth 4, ~4.8 M parameters), batch 21, first in this
   process from torch's default TF32 flags (cuDNN's on): a finite test
   loss, the flags restored after it, the run reloaded through
   ``load_best_model(..., params_template=...)``, the run's own first test
   forward on the card against the CPU forward of the saved parameters
   (float32, ``CNN_TOL``: the entry point ran its convs in float32) and,
   for the record, that forward's error with TF32 on; the batch-21 step's
   time and peak memory beside the card's name
   and power limit (cuDNN convs, no hand-written kernel). The stores are
   written and read with numpy and the standard library alone;
12. ``bench``: ``gwen_tpu_torch bench`` at its defaults (L7, F 256,
   ``diag_packed``, bf16) through the CLI, with every count from 0 just
   before it: exactly one stdout line with the reference's headline keys
   and metric, ``value`` and ``vs_baseline`` finite and positive, the
   reference's extras keys on its ``# train-step:`` line, the checkout's
   ``BENCH_EXTRA.json`` byte for byte as before, the launch counts its
   chains imply (packed B1 and B3 once an
   aggregation, 8 a train step; B2 and B2b 4 a step; B5 once an attention
   call; nothing else) and no plain version on the card; before it, one
   call each of the bench's aggregation, train step and attention under
   ``torch.profiler``, whose device kernels must include
   ``packed_row1_kernel`` (aggregation and train step), ``ln_fwd`` and
   ``ln_bwd`` (train step) and ``attn_fwd_kernel``; after it, B5 at f 256
   on the packed L7 diag graph, on independent q, k and v, against its
   plain version and ``scaled_dot_product_attention`` on the dense mask,
   then the bench's own call (x as q, k and v) timed beside its plain
   version and held to its bound. All of it in one fresh child process;
13. last, in fresh child processes: one call of ``spmm_sliding_rank1``
   (unbatched and at batch 4) runs exactly one device kernel under
   ``torch.profiler``, the dense row gather, and one call of B5, B6 and B7
   (nb 1 and 8) exactly one, ``attn_fwd_kernel``, ``attn_dq_kernel`` and
   ``attn_dkdv_kernel``; then ``nn.core.linear`` at the benchmark cells'
   row counts (327,684 to 3,440,682) with K = 1, K = N = 256 and N = 1
   (:func:`check_linear`): within one bf16 ulp of the expression it
   replaced, one GEMM with the bias epilogue a call and no pass over the
   output where N > 1, its time beside the old expression's, its route
   counts, and its gradients; then the segment sum of GraphCast's edge
   operators on the 0.25° graphs, each block's receiver and sender side,
   against its plain version, for the same bits, timed beside its bound,
   the plain version and ``index_add_``, and one GraphCast train step
   with its launches counted (:func:`check_segment_sum`);
   then the NCCL probe.

The second-to-last lines are a JSON object of the kernels and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": ...}``,
printed only when every phase passed.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gwen_tpu_torch.profiling import StepTimer, cuda_ms, device_ms, profile_step

LEVELS, LATENT, PROCESS_STEPS, CHANNELS, WINDOW = 7, 256, 4, 1, 384
REQUESTS, ROLLOUT_STEPS = 3, 4
BF16_TOL, F32_TOL, STEP_ULPS = 1e-2, 1e-5, 2.5
TRAIN_BATCH, DEFAULT_BATCH = 4, 21
LOSS_TOL, GRAD_TOL = 1e-2, 5e-2
# The UNet forward on the card against the CPU, float32 with TF32 off:
# cuDNN and the CPU sum each conv in their own order and algorithm, and
# four GroupNorms rescale what that leaves; 1e-4 of max|CPU| allows that
# and nothing more.
CNN_TOL = 1e-4
REMAT_LADDER = (False, "save_agg", "save_agg:2", True, "nested:2")
ATTN_HEADS = 2
# Published peaks of one H100 SXM at 700 W: device memory rate and dense
# rates by operand type (float32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SKILL_HORIZON = 4  # steps the skill verification rolls out
SKILL_KEYS = ("skill_crps", "skill_rmse_ensemble_mean", "skill_spread",
              "skill_spread_error_ratio")


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


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


def same_bits(name: str, got: tuple, again) -> None:
    """Fail unless a second call, ``again()``, returns ``got`` bit for bit
    (no atomics: the gradients repeat from run to run)."""
    if not all(torch.equal(a, b) for a, b in zip(got, again(), strict=True)):
        raise AssertionError(f"{name}: a second call gave other bits")
    log(f"  {name}: a second call gives the same bits")


def timed_pair(kernel, plain, iters: int = 20) -> tuple[float, float]:
    """Kernel and plain-version times, in turns (plain, kernel, kernel,
    plain) so drift on the card affects both alike."""
    p1, k1 = cuda_ms(plain, iters), cuda_ms(kernel, iters)
    k2, p2 = cuda_ms(kernel, iters), cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def roofline(ins, outs, flops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take for one call: the larger of the
    bytes of ``ins`` and ``outs`` (each read or written once) over the
    memory rate and the useful ``flops`` over the peak rate of ``dtype``.
    An int among ``ins`` is a byte count (:func:`nonzero_bytes`,
    :func:`nonzero_slot_bytes`)."""
    nbytes = sum(t if isinstance(t, int) else t.numel() * t.element_size()
                 for t in (*ins, *outs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nonzero_bytes(s_dense: torch.Tensor, name: str) -> int:
    """Bytes a fixed sparse operator needs: each nonzero of the windowed
    tile ``s_dense`` with a 4-byte column index. The zeros of the dense
    layout are the design's cost, not the function's, so the bounds count
    this and the log states the stored bytes beside it."""
    nnz = int((s_dense != 0).sum())
    need = nnz * (s_dense.element_size() + 4)
    stored = s_dense.numel() * s_dense.element_size()
    log(f"    {name}: S holds {nnz} nonzeros, {need / 1e6:.2f} MB with their "
        f"indices (the bound counts these); stored dense {stored / 1e6:.1f} MB, "
        f"{stored / HBM_BYTES_PER_S * 1e3:.4f} ms to stream")
    return need


def nonzero_slot_bytes(index: torch.Tensor, weight: torch.Tensor, name: str) -> int:
    """Bytes a gather layout's fixed operator needs: each slot with a
    nonzero weight, with its index as the layout stores it. The padding
    slots are the design's cost, not the function's, as the zeros of a
    dense tile are (:func:`nonzero_bytes`); the log states the stored bytes
    beside the count."""
    nnz = int((weight != 0).sum())
    need = nnz * (index.element_size() + weight.element_size())
    stored = index.nbytes + weight.nbytes
    log(f"    {name}: {nnz} of {weight.numel()} slots are nonzero, "
        f"{need / 1e6:.2f} MB with their indices (the bound counts these); "
        f"stored {stored / 1e6:.1f} MB, {stored / HBM_BYTES_PER_S * 1e3:.4f} ms "
        "to stream")
    return need


def window_csr(s_dense: torch.Tensor, window_start: torch.Tensor, block: int,
               src_rows: int) -> tuple:
    """The windowed operator ``s_dense`` ``(N_pad, W)`` as CSR parts
    ``(crow, cols, values, size)`` over absolute source columns."""
    rows, rel = torch.nonzero(s_dense, as_tuple=True)
    vals = s_dense[rows, rel]
    cols = window_start.long()[rows // block] + rel
    crow = torch.zeros(s_dense.shape[0] + 1, dtype=torch.int64,
                       device=s_dense.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=s_dense.shape[0]), 0)
    return crow, cols, vals, (s_dense.shape[0], src_rows)


def sparse_mm_ms(csr: tuple, x: torch.Tensor, iters: int = 20,
                 timer=cuda_ms) -> float:
    """Time of ``torch.sparse.mm`` on the CSR operator and ``x`` ``(rows,
    F)`` or ``(B, rows, F)`` (laid out ``(rows, B·F)`` outside the timed
    region), in x's type where cuSPARSE takes it, else in float32, taken
    with ``timer`` (:func:`cuda_ms` or :func:`device_ms`). The library
    yardstick of the SpMM kernels; the port never calls it."""
    from gwen_tpu_torch.ops.spmm_cuda import _fit_rows

    crow, cols, vals, size = csr
    x2 = _fit_rows(x, size[1])
    if x2.dim() == 3:
        x2 = x2.transpose(0, 1).reshape(size[1], -1)
    for dtype in (x.dtype, torch.float32):
        try:
            a = torch.sparse_csr_tensor(crow, cols, vals.to(dtype), size=size)
            b = x2.to(dtype).contiguous()
            ms = timer(lambda: torch.sparse.mm(a, b), iters)
        except RuntimeError as err:
            if dtype == torch.float32:
                raise
            log(f"  torch.sparse.mm does not take {dtype}: {str(err)[:80]}")
            continue
        log(f"    torch.sparse.mm ({dtype}, nnz {vals.numel()}, x "
            f"{tuple(b.shape)}): {ms:.4f} ms")
        return ms
    raise AssertionError("unreachable")


def full_window_pattern(graph, nb: int = 1) -> tuple:
    """CSR index parts ``(crow, cols, size)`` of the full window: row i of
    item b holds the ``W`` columns from ``b·src_rows + window_start[i //
    block]``, block-diagonal over ``nb`` items. The graph fixes it, so a
    runtime ``(nb, N_pad, W)`` tile, flattened, is the values of a CSR
    tensor on it without a copy. int32 indices, which cuSPARSE takes
    faster."""
    n_pad, w, src = graph.num_padded_nodes, graph.window_size, graph.num_src_rows
    dev = graph.window_start.device
    rows = torch.arange(nb * n_pad, device=dev)
    first = (rows // n_pad) * src + graph.window_start.long()[
        (rows % n_pad) // graph.block_size]
    cols = (first[:, None] + torch.arange(w, device=dev)).reshape(-1)
    crow = torch.arange(nb * n_pad + 1, device=dev) * w
    return crow.int(), cols.int(), (nb * n_pad, nb * src)


def sampled_addmm_ms(graph, a: torch.Tensor, b: torch.Tensor,
                     kernel_out: torch.Tensor) -> float:
    """Time of ``torch.sparse.sampled_addmm`` on the full window pattern:
    the one PyTorch call that computes B8's SDDMM (its values are the
    ``(N_pad, W)`` tile), held to ``kernel_out`` first. In a's type where
    the library takes it, else in float32; pattern and padded operands are
    built outside the timed region. The port never calls it."""
    from gwen_tpu_torch.ops.spmm_cuda import _fit_rows

    crow, cols, size = full_window_pattern(graph)
    for dtype in (a.dtype, torch.float32):
        pat = torch.sparse_csr_tensor(
            crow, cols, torch.zeros(cols.numel(), dtype=dtype, device=a.device),
            size=size)
        ap = _fit_rows(a.to(dtype), size[0])
        bt = _fit_rows(b.to(dtype), size[1]).t()
        try:
            out = torch.sparse.sampled_addmm(pat, ap, bt, beta=0.0)
        except (RuntimeError, NotImplementedError) as err:
            if dtype == torch.float32:
                raise
            log(f"    torch.sparse.sampled_addmm does not take {dtype}: "
                f"{str(err)[:80]}")
            continue
        compare(f"B8 against torch.sparse.sampled_addmm ({dtype})", kernel_out,
                out.values().reshape(kernel_out.shape), F32_TOL)
        del out
        ms = cuda_ms(lambda: torch.sparse.sampled_addmm(pat, ap, bt, beta=0.0), 10)
        log(f"    torch.sparse.sampled_addmm ({dtype}, nnz {cols.numel()}): "
            f"{ms:.4f} ms")
        return ms
    raise AssertionError("unreachable")


def sparse_mm_t_ms(graph, s: torch.Tensor, g: torch.Tensor,
                   kernel_out: torch.Tensor) -> float:
    """Time of ``torch.sparse.mm`` on the transposed CSR tensor of the
    runtime tile ``s`` ``(N_pad, W)`` or ``(nb, N_pad, W)`` (one
    block-diagonal operator over the items): the one PyTorch call that
    computes B9 and B9b, held to ``kernel_out`` first. ``s`` is an operand
    of the call, so wrapping it as a CSR tensor on the fixed pattern (no
    copy) is inside the timed region; the pattern and the padded ``g`` are
    not. In s's type where the library takes it, else in float32. The port
    never calls it."""
    from gwen_tpu_torch.ops.spmm_cuda import _fit_rows

    nb = 1 if s.dim() == 2 else s.shape[0]
    crow, cols, size = full_window_pattern(graph, nb)

    def call_in(dtype):
        sv = s.to(dtype)
        gp = _fit_rows(g.to(dtype), graph.num_padded_nodes).reshape(size[0], -1)

        def call():
            op = torch.sparse_csr_tensor(crow, cols, sv.reshape(-1), size=size)
            return torch.sparse.mm(op.t(), gp)
        return call

    # The same function: held in float32, where the library rounds once.
    compare(f"B9{'b' if nb > 1 else ''} against torch.sparse.mm on the "
            f"transposed CSR (float32, nb {nb})", kernel_out,
            call_in(torch.float32)().reshape(kernel_out.shape), BF16_TOL)
    for dtype in (s.dtype, torch.float32):
        call = call_in(dtype)
        try:
            call()
        except (RuntimeError, NotImplementedError) as err:
            if dtype == torch.float32:
                raise
            log(f"    torch.sparse.mm on a transposed CSR does not take {dtype}: "
                f"{str(err)[:80]}")
            continue
        ms = cuda_ms(call, 5, 1)
        log(f"    torch.sparse.mm, transposed CSR ({dtype}, nnz {cols.numel()}, "
            f"nb {nb}): {ms:.4f} ms")
        return ms
    raise AssertionError("unreachable")


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
    import torch.nn.functional as F

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
    nnz = int((graph.s_mat != 0).sum())
    csr = window_csr(graph.s_mat, graph.window_start, graph.block_size,
                     graph.num_src_rows)
    results["B1"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **roofline((nonzero_bytes(graph.s_mat, "B1"), x[: graph.num_src_rows], fix),
                   (x,),
                   2.0 * (nnz + u) * f, torch.bfloat16),
        library_ms=sparse_mm_ms(csr, x), floor_ms=stored_floor_ms(graph.s_mat))
    # What the escape epilogue costs with one item.
    no_fix = cuda_ms(lambda: spmm_cuda.diag_window_spmm(graph, x))
    log(f"    B1: {ms:.4f} ms, with no fix rows (no epilogue) {no_fix:.4f} ms")

    # B3: banded SpMM on the esc2 graph (x compacted to the U endpoints).
    # Its kernel is shorter than the host's enqueue of a call, so kernel,
    # plain version and library call are timed by their device kernels
    # (device_ms), the back-to-back CUDA-event time logged beside.
    x2 = randn(g2.num_nodes, f)
    want = spmm_cuda.sliding_spmm_plain(g2_32, x2.float())
    err = compare("B3 bf16", spmm_cuda.sliding_spmm(g2, x2), want, BF16_TOL)
    compare("B3 f32", spmm_cuda.sliding_spmm(g2_32, x2.float()), want, F32_TOL)
    b3 = (lambda: spmm_cuda.sliding_spmm(g2, x2),
          lambda: spmm_cuda.sliding_spmm_plain(g2, x2))
    events_ms = timed_pair(*b3)
    log(f"    B3: back-to-back CUDA-event time (the host's enqueue bounds it) "
        f"kernel {events_ms[0]:.4f} ms, plain {events_ms[1]:.4f} ms")
    results["B3"] = dict(
        max_abs_err=err, ms=device_ms(b3[0]), plain_ms=device_ms(b3[1], 10),
        **roofline((nonzero_bytes(g2.s_mat, "B3"), x2),
                   (spmm_cuda.sliding_spmm(g2, x2),),
                   2.0 * int((g2.s_mat != 0).sum()) * f, torch.bfloat16),
        library_ms=sparse_mm_ms(window_csr(g2.s_mat, g2.window_start,
                                           g2.block_size, g2.num_src_rows), x2,
                                50, device_ms),
        floor_ms=stored_floor_ms(g2.s_mat))

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
    scb, bib = sc.bfloat16(), bi.bfloat16()
    lib = cuda_ms(lambda: h + F.layer_norm(m, (f,), scb, bib, 1e-6))
    log(f"    F.layer_norm + add (two calls, bf16): {lib:.4f} ms")
    results["B2"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **roofline((m, h, sc, bi), (m,), 10.0 * m.numel(), torch.float32),
        library_ms=lib)
    torch.cuda.synchronize()
    _log_times(results)
    return results


def _log_times(results: dict) -> None:
    for name, r in results.items():
        lib = r["library_ms"]
        floor = (f", floor (the operator as stored) {r['floor_ms']:.4f} ms"
                 if "floor_ms" in r else "")
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.0%} of it reached){floor}, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}")


def stored_floor_ms(*tensors) -> float:
    """Time to read a layout's operator as it is stored (dense S with its
    zeros, the bit words and scales) at the memory rate: a floor for a
    kernel that must read it whole, printed beside the bound, which counts
    the nonzeros only."""
    return sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S * 1e3


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
    _profile_step(lambda: sm.step(x), f"served {processor}")
    return launches


def check_train_kernels(graph, device, batch: int = TRAIN_BATCH) -> dict:
    """Phase 3 at train shapes: B4, B10 and B2b against their plain
    versions, and the diag composite's x-gradient against autograd through
    the plain versions."""
    import torch.nn.functional as F

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
    nnz = int((graph.s_mat != 0).sum())
    results["B4"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **roofline((nonzero_bytes(graph.s_mat, "B4"),
                    x[:, : graph.num_src_rows], fix), (x,),
                   2.0 * (nnz + u) * f * batch, torch.bfloat16),
        library_ms=sparse_mm_ms(window_csr(graph.s_mat, graph.window_start,
                                           graph.block_size,
                                           graph.num_src_rows), x, 5),
        floor_ms=stored_floor_ms(graph.s_mat))
    del want
    # What the escape epilogue costs, and the CRPS step's 16-item shape (four
    # groups of four: each row's S walked four times).
    no_fix = cuda_ms(lambda: spmm_cuda.diag_window_spmm_b(graph, x), 10)
    x16, fix16 = randn(16, graph.num_padded_nodes, f), randn(16, u, f)
    b16 = cuda_ms(lambda: spmm_cuda.diag_window_spmm_b(graph, x16, fix16), 5)
    log(f"    B4 batch {batch}: {ms:.4f} ms, with no fix rows (no epilogue) "
        f"{no_fix:.4f} ms; batch 16: {b16:.4f} ms ({b16 / 4:.4f} a group of four)")
    del x16, fix16

    # B10: batched banded SpMM on the esc2 graph.
    x2 = randn(batch, g2.num_nodes, f)
    want = spmm_cuda.sliding_spmm_plain(g2_32, x2.float())
    err = compare("B10 bf16", spmm_cuda.sliding_spmm_b(g2, x2), want, BF16_TOL)
    compare("B10 f32", spmm_cuda.sliding_spmm_b(g2_32, x2.float()), want, F32_TOL)
    ms, plain_ms = timed_pair(lambda: spmm_cuda.sliding_spmm_b(g2, x2),
                              lambda: spmm_cuda.sliding_spmm_plain(g2, x2))
    results["B10"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **roofline((nonzero_bytes(g2.s_mat, "B10"), x2),
                   (spmm_cuda.sliding_spmm_b(g2, x2),),
                   2.0 * int((g2.s_mat != 0).sum()) * f * batch, torch.bfloat16),
        library_ms=sparse_mm_ms(window_csr(g2.s_mat, g2.window_start,
                                           g2.block_size, g2.num_src_rows), x2),
        floor_ms=stored_floor_ms(g2.s_mat))

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
    # The library's version: autograd's backward of F.layer_norm (its graph
    # built outside the timed region).
    leaves = [m.detach().requires_grad_(), sc.bfloat16().requires_grad_(),
              torch.zeros(f, dtype=torch.bfloat16, device=device).requires_grad_()]
    out = F.layer_norm(leaves[0], (f,), leaves[1], leaves[2], 1e-6)
    lib = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
    log(f"    backward of F.layer_norm (bf16): {lib:.4f} ms")
    results["B2b"] = dict(
        max_abs_err=errs[0], ms=ms, plain_ms=plain_ms,
        **roofline((m, g, sc), (m, sc, sc), 20.0 * m.numel(), torch.float32),
        library_ms=lib)
    del m, g, w_dm, leaves, out

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
    _log_times(results)
    return results


def dense_window_bias(graph) -> torch.Tensor:
    """The window mask of a diag-window graph (weighted or packed) as a
    dense additive ``(N, N8)`` bf16 bias on its device, ``N8`` the node
    count rounded up to 8 (cut to ``[:, :N]`` for use): 0 on each row's
    in-window neighbours, −inf elsewhere."""
    from gwen_tpu_torch.graph import window_mask

    n = graph.num_nodes
    bias = torch.full((n, -(-n // 8) * 8), float("-inf"), dtype=torch.bfloat16,
                      device=graph.window_start.device)
    rows, rel = torch.nonzero(window_mask(graph), as_tuple=True)
    cols = graph.window_start.long()[rows // graph.block_size] + rel
    keep = (rows < n) & (cols < n)
    bias[rows[keep], cols[keep]] = 0
    return bias


def sdpa_library_ms(graph, inputs: dict) -> dict:
    """Times of ``F.scaled_dot_product_attention`` and its autograd backward
    on a dense additive ``(N, N)`` mask (0 on the window's neighbours, −inf
    elsewhere: 53.7 GB in bf16 at L7, built outside the timed region): the
    one PyTorch call that computes B5's function, and the one that yields
    B6's dQ or B7's dK and dV (its backward computes all three whichever
    is asked for). Each is held to the kernel first; both sides round to
    bf16, so to the sum of two bf16 bounds. The cuDNN backend is pinned: at
    this size the memory-efficient one returns wrong values. ``inputs`` maps
    nb to the ``(q, k, v, g)`` the kernels were timed on. Returns ms by
    ``(kernel, nb)``. The port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from gwen_tpu_torch.ops import attention_cuda as ac

    n = graph.num_nodes
    torch.cuda.empty_cache()
    bias = dense_window_bias(graph)
    mask, out = bias[:, :n], {}
    for nb, (q, k, v, g) in inputs.items():
        dh = q.shape[-1]
        scale = dh ** -0.5
        leaves = [t.detach().reshape(1, nb, n, dh).requires_grad_()
                  for t in (q, k, v)]
        cot = g.reshape(1, nb, n, dh)

        def fwd():
            with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
                return F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                      scale=scale)

        def grads(of):
            return torch.autograd.grad(res, of, cot, retain_graph=True)

        res = fwd()
        dq, st = ac.attention_dq(graph, q, k, v, g, scale)
        pairs = zip(("out", "dq", "dk", "dv"),
                    (ac.attention_fwd(graph, q, k, v, scale), dq,
                     *ac.attention_dkdv(graph, q, k, v, g, st, scale)),
                    (res, *grads(leaves)))
        for name, kern, lib in pairs:
            compare(f"B5/B6/B7 {name} against scaled_dot_product_attention on a "
                    f"dense mask (nb {nb})", kern, lib.reshape(kern.shape),
                    2 * BF16_TOL)
        del dq, st, pairs
        with torch.no_grad():
            out[("B5", nb)] = cuda_ms(fwd, 2, 1)
        out[("B6", nb)] = cuda_ms(lambda: grads(leaves[:1]), 2, 1)
        out[("B7", nb)] = cuda_ms(lambda: grads(leaves[1:]), 2, 1)
        log(f"    scaled_dot_product_attention (cuDNN, dense mask "
            f"{bias.numel() * 2 / 1e9:.1f} GB, nb {nb}): forward "
            f"{out[('B5', nb)]:.3f} ms, backward for dQ {out[('B6', nb)]:.3f} ms, "
            f"for dK and dV {out[('B7', nb)]:.3f} ms")
        del res, leaves
    del bias, mask
    torch.cuda.empty_cache()
    return out


def check_attention_kernels(graph, device) -> dict:
    """Phase 3 for attention: B5 (forward), B6 (dQ and the row stats) and
    B7 (dK, dV) against their plain versions at the L7 shapes: nb = 1
    through a direct 2-D call, nb = 2 (serving: 2 heads) and nb = 8
    (training: 2 heads × batch 4) at dh 128, nb = 4 at dh 64 (4 heads);
    then the autograd Function's gradients against autograd through the
    plain forward. Each kernel is timed beside its plain version at nb = 1,
    2 and 8, and beside the library's call (:func:`sdpa_library_ms`)."""
    from gwen_tpu_torch.ops import attention_cuda as ac
    from gwen_tpu_torch.ops.attention import windowed_attention

    gen = torch.Generator(device=device).manual_seed(3)
    n = graph.num_nodes

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    results, times, kept, row_of = {}, {}, {}, {}
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
            same_bits(f"B6, B7 {name} {tag}", (dq, st, dk, dv),
                      lambda: (*ac.attention_dq(graph, *a, scale),
                               *ac.attention_dkdv(graph, *a, st, scale)))
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
                dev = f", device kernel {device_ms(kern, 20):.4f} ms"
                log(f"  {key} nb={nb}: kernel {ms:.4f} ms{dev}, plain {plain_ms:.4f} ms")
            # JSON rows: the unbatched form at nb = 1; B5b at the serving
            # shape, B6b and B7b at the batch-4 train shape.
            rows = {1: {"B5": "B5", "B6": "B6", "B7": "B7"}, 2: {"B5": "B5b"},
                    8: {"B5": "B5b nb 8", "B6": "B6b", "B7": "B7b"}}[nb]
            # Bytes: q, k, v (and g, the stats) and the neighbour lists in,
            # the results out; operations per mask entry and head column: 4
            # forward (scores, P·V), 6 for dQ, 8 for dK and dV.
            nnz = int((graph.attn_nbr >= 0).sum())
            io = {"B5": ((q, k, v, graph.attn_nbr), (q,), 4),
                  "B6": ((q, k, v, g, graph.attn_nbr), (q, st), 6),
                  "B7": ((q, k, v, g, st, graph.attn_nbr_t), (k, v), 8)}
            for key, row in rows.items():
                ms, plain_ms = times[(key, nb)]
                ins, outs, ops = io[key]
                results[row] = dict(
                    max_abs_err=errs[(key, "bf16")], ms=ms, plain_ms=plain_ms,
                    **roofline(ins, outs, float(ops) * dh * nnz * nb,
                               torch.bfloat16),
                    library_ms=None)
                row_of[row] = (key, nb)
            kept[nb] = (q, k, v, g)
        del q, k, v, g
        torch.cuda.empty_cache()
    lib = sdpa_library_ms(graph, kept)
    for row, at in row_of.items():
        results[row]["library_ms"] = lib[at]
    del kept
    # B5b at the batch-4 train shape is not a row of the kernels line
    # (one row a kernel form): its numbers are logged here.
    _log_times({"B5b nb=8": results.pop("B5b nb 8")})

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


def build_wide_attention_graph(device, window: int = WINDOW):
    """An L5 graph in KD-patch order whose neighbour lists are wider than
    the attention kernels' register chunk (7 entries): the mesh, a hub
    joined both ways to every node within 150 rows of it (a row of ~300
    sources and a transpose list of ~300 destinations), and 300 appended
    nodes whose first whole block is cleared (128 rows with no source). As
    the bf16 diag layout (block 128, ``window``) with its attention lists.
    With a window over 1,536 the hub row's mask holds its whole window, so
    its list is wider than the 1,536 entries that a forward keeping a
    row's scores in 48 KB of shared memory (one warp a row, eight a CTA)
    would have to refuse."""
    from gwen_tpu_torch.graph import (apply_order, build_graph,
                                      diag_transpose_tables, icosphere_edges,
                                      kd_patch_order, to_diag_window)

    verts, s, r = icosphere_edges(5)
    n0 = verts.shape[0]
    s2, r2, _ = apply_order(kd_patch_order(verts, s, r, n0), s, r)
    s2, r2 = np.asarray(s2, np.int64), np.asarray(r2, np.int64)
    h, near = n0 // 4, set(s2[r2 == n0 // 4].tolist())
    others = np.array([c for c in range(h - 150, h + 150)
                       if c != h and c not in near])
    n = n0 + 300
    g = build_graph(np.concatenate([s2, others, np.full(others.size, h)]),
                    np.concatenate([r2, np.full(others.size, h), others]), n)
    diag = to_diag_window(g, window_size=window, dtype=torch.bfloat16)
    block = diag.block_size
    empty = -(-n0 // block)
    sm = diag.s_mat.clone()
    sm[empty * block:(empty + 1) * block] = 0
    if window > 1536:
        sm[h] = 1
    diag = diag_transpose_tables(dataclasses.replace(diag, s_mat=sm))
    width, width_t = diag.attn_nbr.shape[1], diag.attn_nbr_t.shape[1]
    if not (width > 7 and width_t > 7 and (empty + 1) * block <= n
            and (window <= 1536 or width > 1536)
            and not bool((diag.attn_nbr[empty * block:(empty + 1) * block] >= 0).any())):
        raise AssertionError("the wide attention graph lacks a row or a transpose "
                             "list over 7 entries (over 1,536 at a wide window), "
                             "or its block of empty rows")
    log(f"  wide attention graph: window {diag.window_size}, nodes {n}, "
        f"padded {diag.num_padded_nodes}, "
        f"lists {tuple(diag.attn_nbr.shape)} and {tuple(diag.attn_nbr_t.shape)}, "
        f"rows {empty * block}-{(empty + 1) * block - 1} with no source")
    return diag.to(device)


def check_wide_attention_graph(graph, device) -> None:
    """Phase 3, correctness only: B5, B6 and B7 on
    :func:`build_wide_attention_graph` against their plain versions, in
    bf16 and float32, at nb 1 (2-D), 3 and 8 (dh 128) and nb 2 at dh 64,
    once with q, k and v 100 rows short of the nodes (listed rows at or
    past them read as zero); one launch each a call, a second call the same
    bits, rows with no source 0."""
    from gwen_tpu_torch.ops import attention_cuda as ac

    gen = torch.Generator(device=device).manual_seed(13)
    n = graph.num_nodes
    has = (graph.attn_nbr >= 0).any(1)
    for lead, rows, dh in (((), n, 128), ((3,), n, 128), ((8,), n - 100, 128),
                           ((2,), n, 64)):
        tag = f"nb={lead[0] if lead else 1} rows={rows} dh={dh}"
        q, k, v, g = (torch.randn(*lead, rows, dh, generator=gen, device=device)
                      for _ in range(4))
        scale = dh ** -0.5
        busy, idle = has[:rows], ~has[:rows]
        w_out = ac.attention_fwd_plain(graph, q, k, v, scale)
        w_dq, w_st = ac.attention_dq_plain(graph, q, k, v, g, scale)
        w_dk, w_dv = ac.attention_dkdv_plain(graph, q, k, v, g, w_st, scale)
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            name = f"wide graph {'bf16' if dt == torch.bfloat16 else 'f32'} {tag}"
            a = [t.to(dt) for t in (q, k, v, g)]
            before = (ac.attention_fwd.launches, ac.attention_dq.launches,
                      ac.attention_dkdv.launches)
            out = ac.attention_fwd(graph, *a[:3], scale)
            dq, st = ac.attention_dq(graph, *a, scale)
            dk, dv = ac.attention_dkdv(graph, *a, st, scale)
            if (ac.attention_fwd.launches - before[0], ac.attention_dq.launches
                    - before[1], ac.attention_dkdv.launches - before[2]) != (1, 1, 1):
                raise AssertionError(f"{name}: B5, B6 and B7 did not launch once each")
            compare(f"B5 {name} out", out, w_out, tol)
            compare(f"B6 {name} dq", dq, w_dq, tol)
            # A row with no source holds mx = -1e30: stats are held on the
            # others, and those rows to 0.
            for i, stat in enumerate(("mx", "den", "delta")):
                compare(f"B6 {name} {stat}", st[..., busy, i], w_st[..., busy, i],
                        tol)
            compare(f"B7 {name} dk", dk, w_dk, tol)
            compare(f"B7 {name} dv", dv, w_dv, tol)
            same_bits(f"B5, B6, B7 {name}", (out, dq, st, dk, dv),
                      lambda: (ac.attention_fwd(graph, *a[:3], scale),
                               *ac.attention_dq(graph, *a, scale),
                               *ac.attention_dkdv(graph, *a, st, scale)))
            if (bool(out[..., idle, :].any()) or bool(dq[..., idle, :].any())
                    or bool(st[..., idle, 1:].any())):
                raise AssertionError(f"{name}: a row with no source is not 0")
    torch.cuda.empty_cache()


def build_packed_graphs(device, perm) -> dict:
    """The bit-packed L7 graphs, keyed by the ``mesh.kernel`` that takes
    them: the diag layout in the serving graph's KD order (with the
    attention tables) and the banded layout in RCM order at the reference's
    defaults (block 256)."""
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      rcm_order, to_diag_window, to_sliding_packed)

    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    s2, r2, _ = apply_order(perm, s, r)
    diag = to_diag_window(build_graph(s2, r2, n), window_size=WINDOW,
                          dtype=torch.bfloat16, transpose_tables=True, packed=True)
    s3, r3, _ = apply_order(rcm_order(s, r, n), s, r)
    sliding = to_sliding_packed(build_graph(s3, r3, n))
    return {"diag_packed": diag.to(device), "packed": sliding.to(device)}


def check_packed_kernels(graph, packed: dict, device, unpacked: dict,
                         batch: int = TRAIN_BATCH) -> dict:
    """Phase 3 for the bit-packed layouts: packed B1 (F 256), packed B4
    (batch 4) and B13 (F 256, unbatched and at the batch-4 train shape)
    against their plain versions in bf16 and float32; the packed
    composites' x-gradients against autograd through the plain versions;
    the packed diag composite (packed B1) against the unpacked one (B1) on
    the same x. The float32 plain versions get the scales rounded to bf16,
    as the bf16 kernels round them. Times beside the plain versions' and
    the unpacked kernels' (``unpacked``)."""
    from gwen_tpu_torch.ops import aggregate, spmm_cuda

    gen = torch.Generator(device=device).manual_seed(4)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    def rounded(g, *names):
        return dataclasses.replace(
            g, **{k: getattr(g, k).bfloat16().float() for k in names})

    f = LATENT
    pg, sg = packed["diag_packed"], packed["packed"]
    p32 = rounded(pg, "r1_col", "r1_row")
    s32 = rounded(sg, "col_scale", "row_scale")
    u, rows, n = pg.escape.rows.shape[0], pg.num_padded_nodes, sg.num_nodes
    # name, kernel, plain, graph, float32 graph, x, fix, kept for the JSON
    cases = (
        ("B1p", spmm_cuda.diag_window_spmm_packed,
         spmm_cuda.diag_window_spmm_packed_plain, pg, p32, (rows, f), (u, f), True),
        ("B4p", spmm_cuda.diag_window_spmm_packed_b,
         spmm_cuda.diag_window_spmm_packed_plain, pg, p32, (batch, rows, f),
         (batch, u, f), True),
        ("B13u", spmm_cuda.sliding_packed_spmm, spmm_cuda.sliding_packed_spmm_plain,
         sg, s32, (n, f), None, True),
        ("B13", spmm_cuda.sliding_packed_spmm, spmm_cuda.sliding_packed_spmm_plain,
         sg, s32, (batch, n, f), None, True),
    )
    results = {}
    for key, kern, plain, g, g32, shape, fix_shape, keep in cases:
        x = randn(*shape)
        extra = () if fix_shape is None else (randn(*fix_shape),)
        extra32 = tuple(e.float() for e in extra)
        tag = f"{key} {tuple(shape)}"
        want = plain(g32, x.float(), *extra32)
        err = compare(f"{tag} bf16", kern(g, x, *extra), want, BF16_TOL)
        compare(f"{tag} f32", kern(g32, x.float(), *extra32), want, F32_TOL)
        del want
        ms, plain_ms = timed_pair(lambda: kern(g, x, *extra),
                                  lambda: plain(g, x, *extra),
                                  5 if len(shape) == 3 else 20)
        ref = unpacked["B4" if len(shape) == 3 else "B1"]["ms"]
        log(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unpacked "
            f"{'B4' if len(shape) == 3 else 'B1'} {ref:.4f} ms")
        if key in ("B1p", "B4p"):
            log(f"    {key} with no fix rows (no epilogue): "
                f"{cuda_ms(lambda: kern(g, x), 10):.4f} ms")
        if keep:
            # The operator the kernel rebuilds, a_r a_s ⊙ S01, as CSR.
            packed_diag = g is pg
            col, row = ((g.r1_col, g.r1_row) if packed_diag
                        else (g.col_scale, g.row_scale))
            dense = spmm_cuda.packed_s(g.s_pack, g.window_start, col,
                                       torch.bfloat16)
            dense = dense * row.bfloat16()[: dense.shape[0], None]
            csr = window_csr(dense, g.window_start, g.block_size, g.num_src_rows)
            del dense
            nb = shape[0] if len(shape) == 3 else 1
            results[key] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **roofline((g.s_pack, col, row, x[..., : g.num_src_rows, :],
                            *extra), (x[..., : g.num_padded_nodes, :],),
                           2.0 * csr[2].numel() * f * nb, torch.bfloat16),
                library_ms=sparse_mm_ms(csr, x, 5 if len(shape) == 3 else 20),
                floor_ms=stored_floor_ms(g.s_pack, col, row))
            _log_times({tag: results[key]})
            del csr
        del x, extra, extra32
        torch.cuda.empty_cache()

    # The composites' x-gradients (packed B1/B3 unbatched, packed B4/B10
    # and B13 at batch 4) against autograd through the plain versions.
    for g, g32, shape in ((pg, p32, (rows, f)), (pg, p32, (batch, rows, f)),
                          (sg, s32, (batch, n, f))):
        x = randn(*shape).requires_grad_()
        cot = randn(*shape, dtype=torch.float32)
        (gx,) = torch.autograd.grad((aggregate(g, x).float() * cot).sum(), x)
        x32 = x.detach().float().requires_grad_()
        (want,) = torch.autograd.grad(
            (aggregate(g32, x32, backend="plain") * cot).sum(), x32)
        compare(f"{type(g).__name__} composite x-grad {tuple(shape)}", gx, want,
                BF16_TOL)
        del x, cot, gx, x32, want
    # Packed against unpacked on the same x. The composites round the
    # weights at different places (bf16(a_r a_s) against bf16(a_s)·bf16(a_r)
    # and the output), each within BF16_TOL of the operator, so the two are
    # held to the sum of both bounds.
    x = randn(rows, f)
    compare("packed diag composite vs unpacked (packed B1 vs B1)",
            spmm_cuda.spmm_diag_window(pg, x), spmm_cuda.spmm_diag_window(graph, x),
            2 * BF16_TOL)
    torch.cuda.empty_cache()
    return results


def build_wide_window_graphs(device) -> dict:
    """Two L5 graphs in RCM order that the row gathers (B13, B11) must get
    right, each as the bit-packed banded layout and the float32
    windowed-dense layout: ``hub``, the mesh plus one node joined to every
    node within 300 rows of it (a row of 601 nonzeros, a window of 1,024
    columns), and ``empty``, the mesh with one destination block's rows
    cleared (no nonzero in the block), its dense layout also with the
    blocks in reverse order (starts not monotone)."""
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      rcm_order, to_sliding_packed, to_windowed_dense)

    verts, s, r = icosphere_edges(5)
    n = verts.shape[0]
    s2, r2, _ = apply_order(rcm_order(s, r, n), s, r)
    h = n // 2
    near = set(s2[r2 == h].tolist())
    others = np.array([c for c in range(h - 300, h + 301) if c != h and c not in near])
    hub = build_graph(np.concatenate([s2, others, np.full(others.size, h)]),
                      np.concatenate([r2, np.full(others.size, h), others]), n)
    mesh = build_graph(s2, r2, n)
    sp, wd = to_sliding_packed(mesh), to_windowed_dense(mesh)
    bits, sm = sp.s_pack.clone(), wd.s_mat.clone()
    bp, bd = sp.num_blocks // 2, wd.num_blocks // 2
    bits[bp * sp.block_size:(bp + 1) * sp.block_size] = 0
    sm[bd * wd.block_size:(bd + 1) * wd.block_size] = 0
    rev = torch.arange(wd.num_blocks - 1, -1, -1)
    reverse = dataclasses.replace(
        wd, s_mat=sm.reshape(wd.num_blocks, wd.block_size, -1)[rev].reshape(sm.shape),
        window_start=wd.window_start[rev].contiguous())
    graphs = {"hub": (to_sliding_packed(hub), to_windowed_dense(hub)),
              "empty": (dataclasses.replace(sp, s_pack=bits),
                        dataclasses.replace(wd, s_mat=sm), reverse)}
    return {k: tuple(g.to(device) for g in v) for k, v in graphs.items()}


def check_wide_window_graphs(graphs: dict, device) -> None:
    """Phase 3, correctness only: B13 (bf16 and float32) and B11 (its six
    operand modes) on the L5 hub and empty-block graphs
    (:func:`build_wide_window_graphs`) against their plain versions,
    unbatched on fewer rows than the layout's sources (F 24: lanes past F)
    and at batch 5 (a batch group of four and one of one) at F 256."""
    from gwen_tpu_torch.ops import spmm_cuda

    gen = torch.Generator(device=device).manual_seed(5)
    for name, (sp, *dense) in graphs.items():
        s32 = dataclasses.replace(sp, col_scale=sp.col_scale.bfloat16().float(),
                                  row_scale=sp.row_scale.bfloat16().float())
        for shape in ((sp.num_nodes - 100, 24), (5, sp.num_nodes, LATENT)):
            x = torch.randn(*shape, generator=gen, device=device).bfloat16()
            tag = f"{name} graph {tuple(shape)}"
            want = spmm_cuda.sliding_packed_spmm_plain(s32, x.float())
            compare(f"B13 {tag} bf16", spmm_cuda.sliding_packed_spmm(sp, x), want,
                    BF16_TOL)
            compare(f"B13 {tag} f32", spmm_cuda.sliding_packed_spmm(s32, x.float()),
                    want, F32_TOL)
            for g in dense:
                starts = ("not monotone"
                          if bool((g.window_start.diff() < 0).any()) else "monotone")
                check_b11_modes(g, x, f"{tag}, window {g.window_size}, starts {starts}")
    torch.cuda.synchronize()


def build_diag_gather_graphs(device) -> dict:
    """An L5 graph in KD-patch order that B4, packed B4 and B10 (the row
    gathers with the escape epilogue) must get right: the mesh, a hub joined
    both ways to every node within 150 rows of it (~300 nonzeros in its
    window) and to 100 nodes of one block far outside its window (a block of
    > 32 escape rows), and 300 appended nodes with self loops only, whose
    first whole block is cleared (no nonzero, no escape). As the weighted
    bf16 diag layout (window 384, block 128) with the esc2 contraction (B10),
    its packed form, and one rank's halo-diag local graph of the mesh in two
    partitions (``n_pad`` rows, a window over the halo-extended sources)."""
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      kd_patch_order, to_diag_window, window_mask)
    from gwen_tpu_torch.parallel import local_graph, partition_graph

    verts, s, r = icosphere_edges(5)
    n0 = verts.shape[0]
    s2, r2, _ = apply_order(kd_patch_order(verts, s, r, n0), s, r)
    s2, r2 = np.asarray(s2, np.int64), np.asarray(r2, np.int64)
    h, block = n0 // 4, 128
    far0 = (3 * n0 // 4) // block * block
    near = set(s2[r2 == h].tolist())
    others = np.array([c for c in (*range(h - 150, h + 150), *range(far0, far0 + 100))
                       if c != h and c not in near])
    n = n0 + 300
    g = build_graph(np.concatenate([s2, others, np.full(others.size, h)]),
                    np.concatenate([r2, np.full(others.size, h), others]), n)
    kw = dict(window_size=WINDOW, esc2_min_rows=1)
    diag = to_diag_window(g, dtype=torch.bfloat16, **kw)
    packed = to_diag_window(g, packed=True, **kw)
    empty = -(-n0 // block)
    rows = slice(empty * block, (empty + 1) * block)
    sm, bits = diag.s_mat.clone(), packed.s_pack.clone()
    sm[rows], bits[rows] = 0, 0
    diag = dataclasses.replace(diag, s_mat=sm)
    packed = dataclasses.replace(packed, s_pack=bits)
    per_row, per_block = window_mask(diag).sum(1), diag.esc_ptr.diff()
    if not (int(per_row.max()) > 32 and int(per_block.max()) > 32
            and int(per_row[rows].sum()) == 0 and int(per_block[empty]) == 0
            and rows.stop <= n < diag.num_src_rows):
        raise AssertionError("the L5 gather graph lacks a hub row, a block of "
                             "> 32 escapes or an empty block of real rows")
    pg = partition_graph(s2, r2, n0, 2, reorder=False, layout="diag",
                         s_dtype=torch.bfloat16, diag_window=WINDOW)
    halo = local_graph(pg, 1).local
    log(f"  L5 gather graphs: nodes {n}, padded {diag.num_padded_nodes}, src rows "
        f"{diag.num_src_rows}, hub row {int(per_row.max())} in-window nonzeros, "
        f"at most {int(per_block.max())} escape rows a block, block {empty} empty, "
        f"esc2 S {tuple(diag.esc2_graph.s_mat.shape)}; halo-diag local S "
        f"{tuple(halo.s_mat.shape)} over {halo.num_src_rows} extended rows, "
        f"{0 if halo.escape is None else halo.escape.rows.shape[0]} escape rows")
    return {k: v.to(device) for k, v in
            {"diag": diag, "packed": packed, "halo": halo}.items()}


def check_diag_gather_graphs(graphs: dict, device) -> None:
    """Phase 3, correctness only: B4 (a bf16 S, its float32 copy, and a
    float32 x on the bf16 S), packed B4 and B10 (on the esc2 graph) on the
    graphs of :func:`build_diag_gather_graphs` against their plain versions,
    at batch 1, 3, 5 and 16 (groups of four and a remainder), F 8 and 264 in
    bf16 (lanes past F, a second column pass) and F 4 and 132 in float32,
    the float32-on-bf16 mode at F 4, x with fewer rows than the sources;
    the same for the unbatched forms on a 2-d x (the gathers' batch-1 walk):
    B1, packed B1, and B1 on a runtime S (``window_matvec``) with the
    graph's mask (the hub's ~300 nonzeros fill the walk's list several
    times) and with every window column nonzero; B4, packed B4, B1 and
    packed B1 with no fix rows; B4, B1 and ``window_matvec`` on the
    halo-diag local graph. Each call must launch its wrapper's kernel
    once."""
    from gwen_tpu_torch.graph import window_mask
    from gwen_tpu_torch.ops import spmm_cuda

    gen = torch.Generator(device=device).manual_seed(9)
    counters = _counters()

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    def held(key, tag, kernel, want, tol):
        before = counters[key].launches
        got = kernel()
        if counters[key].launches != before + 1:
            raise AssertionError(f"{key} {tag}: its kernel did not launch once")
        compare(f"{key} {tag}", got, want, tol)

    dg, pg, halo = graphs["diag"], graphs["packed"], graphs["halo"]
    g2 = dg.esc2_graph
    d32 = dataclasses.replace(dg, s_mat=dg.s_mat.float())
    g2_32 = dataclasses.replace(g2, s_mat=g2.s_mat.float())
    p_bf = dataclasses.replace(pg, r1_col=pg.r1_col.bfloat16().float(),
                               r1_row=pg.r1_row.bfloat16().float())
    n, u = dg.num_nodes, dg.escape.rows.shape[0]
    modes = ((torch.bfloat16, 8), (torch.bfloat16, 264), (torch.float32, 4),
             (torch.float32, 132))
    for batch in (1, 3, 5, 16):
        for dtype, f in modes:
            bf = dtype == torch.bfloat16
            tol = BF16_TOL if bf else F32_TOL
            tag = f"batch {batch} F {f} {'bf16' if bf else 'f32'}"
            x, fix = randn(batch, n, f, dtype=dtype), randn(batch, u, f, dtype=dtype)
            xf, ff = x.float(), fix.float()
            held("B4", tag, lambda: spmm_cuda.diag_window_spmm_b(dg if bf else d32, x, fix),
                 spmm_cuda.diag_window_spmm_plain(d32, xf, ff), tol)
            held("B4p", tag, lambda: spmm_cuda.diag_window_spmm_packed_b(pg, x, fix),
                 spmm_cuda.diag_window_spmm_packed_plain(p_bf if bf else pg, xf, ff),
                 tol)
            x2 = randn(batch, g2.num_nodes, f, dtype=dtype)
            held("B10", tag, lambda: spmm_cuda.sliding_spmm_b(g2 if bf else g2_32, x2),
                 spmm_cuda.sliding_spmm_plain(g2_32, x2.float()), tol)
            if f == 4:  # a float32 x on the bf16 S
                held("B4", f"{tag} on the bf16 S",
                     lambda: spmm_cuda.diag_window_spmm_b(dg, x, fix),
                     spmm_cuda.diag_window_spmm_plain(d32, x, fix), F32_TOL)
                held("B10", f"{tag} on the bf16 S",
                     lambda: spmm_cuda.sliding_spmm_b(g2, x2),
                     spmm_cuda.sliding_spmm_plain(g2_32, x2), F32_TOL)
    def runtime_s(graph, dtype):
        """A runtime S on ``graph``'s window: random values on its mask (as
        attention probabilities lie), and random in every column."""
        shape = (graph.num_padded_nodes, graph.window_size)
        masked = torch.rand(*shape, generator=gen, device=device) * window_mask(graph)
        return {"masked": masked.to(dtype), "dense": randn(*shape, dtype=dtype)}

    for dtype, f in modes:
        bf = dtype == torch.bfloat16
        tol = BF16_TOL if bf else F32_TOL
        tag = f"2-d x F {f} {'bf16' if bf else 'f32'}"
        x, fix = randn(n, f, dtype=dtype), randn(u, f, dtype=dtype)
        xf, ff = x.float(), fix.float()
        held("B1", tag, lambda: spmm_cuda.diag_window_spmm(dg if bf else d32, x, fix),
             spmm_cuda.diag_window_spmm_plain(d32, xf, ff), tol)
        held("B1p", tag, lambda: spmm_cuda.diag_window_spmm_packed(pg, x, fix),
             spmm_cuda.diag_window_spmm_packed_plain(p_bf if bf else pg, xf, ff),
             tol)
        for kind, sm in runtime_s(dg, dtype).items():
            held("B1", f"window_matvec, {kind} S, {tag}",
                 lambda: spmm_cuda.window_matvec(sm, dg, x),
                 spmm_cuda.window_spmm_plain(sm.float(), dg.window_start, xf,
                                             dg.num_src_rows), tol)
        if f == 4:  # a float32 x on the bf16 S
            held("B1", f"{tag} on the bf16 S",
                 lambda: spmm_cuda.diag_window_spmm(dg, x, fix),
                 spmm_cuda.diag_window_spmm_plain(d32, x, fix), F32_TOL)
    for lead in ((3,), ()):
        x = randn(*lead, n, 264)
        tag = f"{'batch 3' if lead else '2-d x'} F 264 bf16, no fix rows"
        held("B4" if lead else "B1", tag,
             lambda: (spmm_cuda.diag_window_spmm_b if lead
                      else spmm_cuda.diag_window_spmm)(dg, x),
             spmm_cuda.diag_window_spmm_plain(d32, x.float(), None), BF16_TOL)
        held("B4p" if lead else "B1p", tag,
             lambda: (spmm_cuda.diag_window_spmm_packed_b if lead
                      else spmm_cuda.diag_window_spmm_packed)(pg, x),
             spmm_cuda.diag_window_spmm_packed_plain(p_bf, x.float(), None), BF16_TOL)
    h32 = dataclasses.replace(halo, s_mat=halo.s_mat.float())
    k = 0 if halo.escape is None else halo.escape.rows.shape[0]
    for lead in ((), (1,), (5,)):
        x = randn(*lead, halo.num_src_rows, 264)
        fix = randn(*lead, k, 264) if k else None
        tag = f"halo-diag local graph, {f'batch {lead[0]}' if lead else '2-d x'} F 264 bf16"
        held("B4" if lead else "B1", tag,
             lambda: (spmm_cuda.diag_window_spmm_b if lead
                      else spmm_cuda.diag_window_spmm)(halo, x, fix),
             spmm_cuda.diag_window_spmm_plain(
                 h32, x.float(), None if fix is None else fix.float()), BF16_TOL)
    x = randn(halo.num_src_rows, 264)
    for kind, sm in runtime_s(halo, torch.bfloat16).items():
        held("B1", f"window_matvec on the halo-diag local graph, {kind} S, F 264",
             lambda: spmm_cuda.window_matvec(sm, halo, x),
             spmm_cuda.window_spmm_plain(sm.float(), halo.window_start, x.float(),
                                         halo.num_src_rows), BF16_TOL)
    torch.cuda.synchronize()


def build_window_graph(device, levels: int):
    """The L``levels`` icosphere in KD-patch order on the bf16 diag-window
    layout (window ``WINDOW``, 128-row blocks) with its transpose tables."""
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      kd_patch_order, to_diag_window)

    verts, s, r = icosphere_edges(levels)
    n = verts.shape[0]
    s2, r2, _ = apply_order(kd_patch_order(verts, s, r, n), s, r)
    return to_diag_window(build_graph(s2, r2, n), window_size=WINDOW,
                          dtype=torch.bfloat16, transpose_tables=True).to(device)


def check_unfused_kernels(graph, packed_diag, device) -> dict:
    """Phase 3 for the unfused attention operators: B8 (SDDMM), B9 and B9b
    (transpose SpMM at nb 1, 2 and 8) and ``diag_matvec``'s forward (B1 on a
    runtime S: random in every window column, and random on the window's
    mask as the unfused backend gives it, the pattern it is timed on)
    against their plain versions at f 128 and 256; the gradients
    of ``diag_matvec`` (in s and x) and ``diag_sddmm`` (in a and b) against
    autograd through the plain versions; ``aggregate`` on a float32
    ``(4, N, 1)`` field over the bf16 and the packed diag graph. Times at
    f 128, the attention head width, beside the library's calls on the full
    window pattern as CSR: ``torch.sparse.sampled_addmm`` for B8,
    ``torch.sparse.mm`` on the transposed operator for B9 and B9b."""
    from gwen_tpu_torch.graph import window_mask
    from gwen_tpu_torch.ops import aggregate, spmm_cuda, unfused_cuda
    from gwen_tpu_torch.ops.attention import diag_matvec, diag_sddmm

    gen = torch.Generator(device=device).manual_seed(7)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    n, n_pad, w = graph.num_nodes, graph.num_padded_nodes, graph.window_size
    src = graph.num_src_rows
    results, errs = {}, {}
    for f in (128, 256):
        for nb in (1, 2, 8):
            lead = () if nb == 1 else (nb,)
            tag = f"nb={nb}{' (2-D)' if nb == 1 else ''} f={f}"
            a, b = randn(*lead, n, f), randn(*lead, n, f)
            want = unfused_cuda.sddmm_plain(graph, a.float(), b.float())
            errs[("B8", nb, f)] = compare(
                f"B8 bf16 {tag}", unfused_cuda.sddmm(graph, a, b), want, BF16_TOL)
            compare(f"B8 f32 {tag}", unfused_cuda.sddmm(graph, a.float(), b.float()),
                    want, F32_TOL)
            del want
            s, g = randn(*lead, n_pad, w), randn(*lead, n, f)
            want = unfused_cuda.spmm_t_plain(graph, s.float(), g.float())
            errs[("B9", nb, f)] = compare(
                f"B9{'b' if nb > 1 else ''} bf16 {tag}",
                unfused_cuda.spmm_t(graph, s, g), want, BF16_TOL)
            compare(f"B9{'b' if nb > 1 else ''} f32 {tag}",
                    unfused_cuda.spmm_t(graph, s.float(), g.float()), want, F32_TOL)
            del want
            if nb == 1:
                # B1 on a runtime S: the random tile (every window column
                # nonzero) and, as the unfused backend gives it, random
                # probabilities on the window's mask; timed on both.
                x = randn(n, f)
                p_mat = (torch.rand(n_pad, w, generator=gen, device=device)
                         * window_mask(graph)).bfloat16()
                for kind, sm in (("dense", s), ("masked", p_mat)):
                    want = unfused_cuda.matvec_plain(graph, sm.float(), x.float())
                    compare(f"diag_matvec forward (B1 on a runtime {kind} S) bf16 "
                            f"f={f}", unfused_cuda.matvec(graph, sm, x), want,
                            BF16_TOL)
                    compare(f"diag_matvec forward ({kind} S) f32 f={f}",
                            unfused_cuda.matvec(graph, sm.float(), x.float()), want,
                            F32_TOL)
                    del want
                ms = cuda_ms(lambda: unfused_cuda.matvec(graph, p_mat, x))
                dense_ms = cuda_ms(lambda: unfused_cuda.matvec(graph, s, x), 3, 1)
                log(f"  diag_matvec forward f={f}: B1 on a runtime S, the mask's "
                    f"pattern (as the unfused backend gives it) {ms:.4f} ms; every "
                    f"window column nonzero {dense_ms:.4f} ms")
                # Its bound and the library call on the mask's pattern: P's
                # nonzeros with their indices, x and the output; the CSR is
                # built outside the timed region.
                csr = window_csr(p_mat, graph.window_start, graph.block_size, src)
                _log_times({f"diag_matvec B1 on the mask's pattern f={f}": dict(
                    ms=ms, plain_ms=cuda_ms(
                        lambda: unfused_cuda.matvec_plain(graph, p_mat, x), 5, 1),
                    **roofline((nonzero_bytes(p_mat, "diag_matvec P"), x),
                               (n_pad * f * x.element_size(),),
                               2.0 * csr[2].numel() * f, torch.bfloat16),
                    library_ms=sparse_mm_ms(csr, x),
                    floor_ms=stored_floor_ms(p_mat))})
                del p_mat, csr
            iters = 20 if nb < 8 else 5
            pairs = {"B8": (lambda: unfused_cuda.sddmm(graph, a, b),
                            lambda: unfused_cuda.sddmm_plain(graph, a, b)),
                     "B9": (lambda: unfused_cuda.spmm_t(graph, s, g),
                            lambda: unfused_cuda.spmm_t_plain(graph, s, g))}
            # JSON rows at f 128: B8 and B9 as the unfused backend calls them
            # (one item), B9b at nb 2.
            rows = {1: {"B8": "B8", "B9": "B9"}, 2: {"B9": "B9b"}}.get(nb, {})
            for key, (kern, plain) in pairs.items():
                ms, plain_ms = timed_pair(kern, plain, iters)
                log(f"  {key}{'b' if key == 'B9' and nb > 1 else ''} {tag}: "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                if f == 128 and key in rows:
                    out = kern()
                    ins, lib = (((a, b), sampled_addmm_ms(graph, a, b, out))
                                if key == "B8" else
                                ((s, g), sparse_mm_t_ms(graph, s, g, out)))
                    results[rows[key]] = dict(
                        max_abs_err=errs[(key, nb, f)], ms=ms, plain_ms=plain_ms,
                        **roofline(ins, (out,), 2.0 * nb * n_pad * w * f,
                                   torch.bfloat16),
                        library_ms=lib)
                    del out
            del a, b, s, g
            torch.cuda.empty_cache()
    _log_times(results)

    # An L5 graph, whose source blocks have up to 11 covering blocks, at f
    # 264 and nb 3: B9's walk over those covers and its 128-feature slices
    # (the third mostly past f, zeros from TMA), B8 past the 256 features
    # it keeps resident (a streamed beside b), and operands shorter than
    # the graph's rows.
    l5 = build_window_graph(device, 5)
    n5, nb, f = l5.num_nodes, 3, 264
    log(f"  L5 graph: {n5} nodes, {l5.num_blocks} blocks, covering blocks a "
        f"source block {int(l5.t_cnt.min())} to {int(l5.t_cnt.max())}")
    a, b = randn(nb, n5 - 100, f), randn(nb, n5, f)
    want = unfused_cuda.sddmm_plain(l5, a.float(), b.float())
    compare(f"B8 bf16 L5 nb={nb} f={f}", unfused_cuda.sddmm(l5, a, b), want, BF16_TOL)
    compare(f"B8 f32 L5 nb={nb} f={f}", unfused_cuda.sddmm(l5, a.float(), b.float()),
            want, F32_TOL)
    s, g = randn(nb, l5.num_padded_nodes, w), randn(nb, n5 - 100, f)
    want = unfused_cuda.spmm_t_plain(l5, s.float(), g.float())
    compare(f"B9b bf16 L5 nb={nb} f={f}", unfused_cuda.spmm_t(l5, s, g), want,
            BF16_TOL)
    compare(f"B9b f32 L5 nb={nb} f={f}", unfused_cuda.spmm_t(l5, s.float(), g.float()),
            want, F32_TOL)
    del l5, a, b, s, g, want
    torch.cuda.empty_cache()

    # The two Functions' gradients against autograd through the plain
    # versions, float32 from the same values.
    s, x = randn(n_pad, w).requires_grad_(), randn(n, 128).requires_grad_()
    cot = randn(n, 128, dtype=torch.float32)
    got = torch.autograd.grad((diag_matvec(graph, s, x).float() * cot).sum(), (s, x))
    s32, x32 = (t.detach().float().requires_grad_() for t in (s, x))
    want = torch.autograd.grad(
        (unfused_cuda.matvec_plain(graph, s32, x32)[:n] * cot).sum(), (s32, x32))
    for name, u, v in zip(("ds", "dx"), got, want):
        compare(f"diag_matvec {name} vs autograd through the plain version", u, v,
                BF16_TOL)
    a, b = randn(n, 128).requires_grad_(), randn(n, 128).requires_grad_()
    cot = randn(n_pad, w, dtype=torch.float32)
    got = torch.autograd.grad((diag_sddmm(graph, a, b) * cot).sum(), (a, b))
    a32, b32 = (t.detach().float().requires_grad_() for t in (a, b))
    want = torch.autograd.grad(
        (unfused_cuda.sddmm_plain(graph, a32, b32) * cot).sum(), (a32, b32))
    for name, u, v in zip(("da", "db"), got, want):
        compare(f"diag_sddmm {name} vs autograd through the plain version", u, v,
                BF16_TOL)
    del s, x, a, b, cot, got, want, s32, x32, a32, b32
    torch.cuda.empty_cache()

    # What the ensemble code hands aggregate: a float32 field with a member
    # axis and one channel, on a bf16 and on a packed layout. Through the
    # batched kernels (B4 or packed B4, and B10), never the plain versions.
    counters = _counters()
    for name, g, b4 in (("bf16 diag", graph, "B4"), ("packed diag", packed_diag,
                                                     "B4p")):
        x = randn(4, n, 1, dtype=torch.float32)
        before = {k: counters[k].launches for k in (b4, "B10")}
        plain_before = PLAIN_ON_CUDA["calls"]
        got = aggregate(g, x)
        ran = {k: counters[k].launches - v for k, v in before.items()}
        if got.dtype != torch.float32 or got.shape != x.shape or ran != {
                b4: 1, "B10": 1} or PLAIN_ON_CUDA["calls"] != plain_before:
            raise AssertionError(f"aggregate (4, N, 1) float32 on the {name} "
                                 f"graph: {got.dtype} {tuple(got.shape)}, "
                                 f"launches {ran}")
        compare(f"aggregate (4, N, 1) float32 on the {name} graph ({b4}, B10)",
                got, aggregate(g, x, backend="plain"), F32_TOL)
        ms = cuda_ms(lambda: aggregate(g, x))
        log(f"  aggregate (4, N, 1) float32 on the {name} graph: {ms:.4f} ms")
        _profile_step(lambda: aggregate(g, x),
                      f"aggregate (4, N, 1) float32 on the {name} graph", top=6)
    torch.cuda.empty_cache()
    return results


def skill_launches(processor: str, kernel: str = "diag") -> dict:
    """Kernel launches of ``train-mesh``'s skill verification (4 members,
    ``SKILL_HORIZON`` steps, no calibration): the float32 skill model runs
    the LayerNorm kernel once per process step and forecast step; the
    attention skill model also B5, and its noise smoothing the batched
    aggregation kernels of the trained diag graph twice. The GCN and
    interaction skill models aggregate on the COO graph."""
    fwd = SKILL_HORIZON * PROCESS_STEPS
    if processor == "attention":
        return {"B5": fwd, "B2": fwd, "B10": 2,
                "B4p" if kernel == "diag_packed" else "B4": 2}
    return {"B2": fwd} if processor == "gcn" else {}


def expected_launches(remat, process_steps: int, processor: str = "gcn",
                      kernel: str = "diag") -> dict:
    """Kernel launches per batched train step under a remat policy.

    GCN: each aggregation runs its kernels once forward and once backward,
    plus once per recompute of its step: B4 and B10 on the diag layout,
    packed B4 and B10 on ``kernel="diag_packed"``, B13 alone on the
    bit-packed banded layout (``kernel="packed"``); on the partitioned path
    ``kernel`` names the partition layout: ``"sliding"`` B10, ``"dense"``
    B11, ``"ell"`` B12; ``"tiles"`` is the block-tile graph, B14. Attention (the same on
    either diag layout): each step runs B5 once per forward or recompute, B6
    and B7 once. Each LayerNorm runs B2 once per forward or recompute and
    B2b once. ``save_agg`` keeps the GCN aggregation output (no recompute)
    but recomputes the attention block around its kept output, not the
    LayerNorm after it. Under ``nested:G`` a group's recompute stops once
    the tensors it needs are rebuilt (torch's non-reentrant checkpoint), so
    the group's last step is recomputed once, the others twice."""
    from gwen_tpu_torch.nn.gnn import parse_remat

    kind, k = parse_remat(remat, process_steps)
    s = process_steps
    groups = -(-s // k) if kind == "nested" else 0
    saved = min(k, s) if kind == "save_agg" else 0
    recompute = {"none": 0, "full": s, "save_agg": s,
                 "nested": 2 * s - groups}[kind]
    out = dict.fromkeys(("B1", "B3", "B4", "B10", "B2", "B2b", "B5", "B6", "B7",
                         "B1p", "B4p", "B13", "B8", "B9", "B11", "B12", "B14",
                         "B3r"),
                        0)
    if processor == "interaction":  # COO graph, its own LayerNorm: no kernel
        return out
    if processor == "attention":
        out.update(B5=s + recompute, B6=s, B7=s, B2=s + recompute - saved,
                   B2b=s)
    else:
        agg = 2 * s + recompute - saved
        aggs = {"packed": ("B13",), "diag_packed": ("B4p", "B10"),
                "sliding": ("B10",), "dense": ("B11",), "ell": ("B12",),
                "tiles": ("B14",)}
        out.update(dict.fromkeys(aggs.get(kernel, ("B4", "B10")), agg),
                   B2=s + recompute, B2b=s)
    return out


def _counters() -> dict:
    from gwen_tpu_torch.ops import attention_cuda, fused_ln, spmm_cuda, unfused_cuda

    return {"B1": spmm_cuda.diag_window_spmm, "B3": spmm_cuda.sliding_spmm,
            "B4": spmm_cuda.diag_window_spmm_b, "B10": spmm_cuda.sliding_spmm_b,
            "B2": fused_ln.residual_layernorm,
            "B2b": fused_ln.residual_layernorm_bwd,
            "B5": attention_cuda.attention_fwd, "B6": attention_cuda.attention_dq,
            "B7": attention_cuda.attention_dkdv,
            "B1p": spmm_cuda.diag_window_spmm_packed,
            "B4p": spmm_cuda.diag_window_spmm_packed_b,
            "B13": spmm_cuda.sliding_packed_spmm,
            "B8": unfused_cuda.sddmm, "B9": unfused_cuda.spmm_t,
            "B11": spmm_cuda.windowed_dense_spmm, "B12": spmm_cuda.block_ell_spmm,
            "B14": spmm_cuda.block_tiles_spmm, "B3r": spmm_cuda.sliding_rank1_spmm}


# Calls of a kernel's plain version with a CUDA tensor: the main paths must
# make none (a wrapper takes its plain version only for CPU tensors).
PLAIN_ON_CUDA = {"calls": 0}


def count_plain_calls_on_cuda() -> None:
    """Wrap every kernel's plain version so that each call with a CUDA
    tensor adds one to ``PLAIN_ON_CUDA``."""
    from gwen_tpu_torch.ops import attention_cuda, fused_ln, spmm_cuda, unfused_cuda

    # window_spmm_plain sits under the plain versions of B1, B3, B4, B10,
    # B11, of the packed forms and B13, and of diag_matvec's forward.
    plains = ((spmm_cuda, ("window_spmm_plain", "block_ell_spmm_plain",
                           "block_tiles_spmm_plain")),
              (unfused_cuda, ("sddmm_plain", "spmm_t_plain")),
              (fused_ln, ("residual_layernorm_plain",
                          "residual_layernorm_bwd_plain")),
              (attention_cuda, ("attention_fwd_plain", "attention_dq_plain",
                                "attention_dkdv_plain")))
    def counting(fn):
        def counted(*args, **kwargs):
            if any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in (*args, *kwargs.values())):
                PLAIN_ON_CUDA["calls"] += 1
            return fn(*args, **kwargs)
        return counted

    for mod, names in plains:
        for name in names:
            setattr(mod, name, counting(getattr(mod, name)))


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
    return cuda_ms(step, iters, warmup=1)


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


def _run_train_mesh(workdir: Path, device, processor: str = "gcn",
                    kernel: str = "auto", extra: tuple = (),
                    per_step: "dict | None" = None,
                    batch: int = TRAIN_BATCH,
                    partition: str = "") -> tuple[dict, dict]:
    """``train-mesh graph.refine=7 train.batch_size=4`` through the CLI entry
    point with ``mesh.kernel=kernel`` (and the ``extra`` options): checks
    the run (at least 8 steps, finite loss, finite skill numbers), the
    layout it took, and the launch counts: per step what remat off implies
    (or ``per_step``, merged over it), plus the skill verification's, with
    no plain version called on CUDA tensors. With ``partition`` the run is
    the partitioned path on one rank (``mesh.force_partition=true``) with
    that ``mesh.partition_layout``. Returns the CLI's JSON line and the
    launch counts."""
    import contextlib
    import io

    from gwen_tpu_torch.cli.main import main as cli
    from gwen_tpu_torch.registry import Run

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    PLAIN_ON_CUDA["calls"] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(["train-mesh", f"graph.refine={LEVELS}",
                  f"model.processor={processor}", f"mesh.kernel={kernel}",
                  f"train.batch_size={batch}", *extra,
                  *((f"mesh.partition_layout={partition}",
                     "mesh.force_partition=true") if partition else ()),
                  f"run.registry_root={workdir / 'runs'}", "--device", str(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if rc != 0:
        raise AssertionError(f"train-mesh returned {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    steps = out["steps"]
    log(f"  train-mesh: {json.dumps(out)}")
    log(f"  wall {wall:.1f} s ({'stored' if '--data' in extra else 'synthetic'} "
        f"L{LEVELS} data, graph build and {steps} steps)")
    if steps < 8 or not math.isfinite(out["best_train_loss"]):
        raise AssertionError(f"train-mesh ran {steps} steps, best loss "
                             f"{out['best_train_loss']}")
    skill = {k: out.get(k) for k in SKILL_KEYS}
    if not all(isinstance(v, float) and math.isfinite(v) for v in skill.values()):
        raise AssertionError(f"skill verification gave {skill}")
    layout = ("HaloDiagGraph" if partition == "diag" else
              "HaloGraph" if partition else
              "Graph" if processor == "interaction" else
              "SlidingPackedGraph" if kernel == "packed" else "DiagWindowGraph")
    if (out["layout"] != layout or out["packed"] != ("packed" in kernel)
            or out.get("partition_layout", "") != partition):
        raise AssertionError(f"train-mesh took the {out['layout']} path "
                             f"(packed: {out['packed']}, partition layout "
                             f"{out.get('partition_layout')!r})")
    per_step = {**expected_launches(False, PROCESS_STEPS, processor,
                                    partition or kernel),
                **(per_step or {})}
    want = {k: v * steps for k, v in per_step.items()}
    for k, v in skill_launches(processor, kernel).items():
        want[k] += v
    log(f"  launches during training: {launches} (want {want}); plain versions "
        f"called on CUDA tensors: {PLAIN_ON_CUDA['calls']}")
    if launches != want or PLAIN_ON_CUDA["calls"]:
        raise AssertionError(f"kernel launch counts {launches} != {want}, or a "
                             "plain version ran on the card")
    losses = [r["value"] for r in Run(Path(out["run_dir"])).metrics("train_loss")]
    log(f"  logged train losses: {losses}")
    return out, launches


def _check_and_time_step(model, graph, x, y, tag: str) -> None:
    """One train step against the same step through the plain versions, at
    batch 4, or at batch 2 where the plain versions' step does not fit; then
    the batch-4 train-step time and peak memory (kernels, then plain)."""
    try:
        _against_plain_step(model, graph, x, y)
    except torch.cuda.OutOfMemoryError:
        log(f"  the plain versions' step at batch {TRAIN_BATCH} is out of "
            "memory; comparing at batch 2")
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        _against_plain_step(model, graph, x[:2], y[:2])
    torch.cuda.empty_cache()

    timing = {}
    for backend in ("auto", "plain"):
        model.backend = backend
        torch.cuda.reset_peak_memory_stats()
        try:
            ms = _step_ms(_adam_step(model, graph, x, y))
        except torch.cuda.OutOfMemoryError:
            log(f"  batch-{TRAIN_BATCH} {tag} train step ({backend}): out of "
                "memory")
            torch.cuda.empty_cache()
            continue
        timing[backend] = (ms, torch.cuda.max_memory_allocated())
    model.backend = "auto"
    for backend, (ms, peak) in timing.items():
        log(f"  batch-{TRAIN_BATCH} {tag} train step ({backend}): "
            f"{ms:.3f} ms, peak memory {peak / 2**30:.2f} GiB")


def _train_batch(n: int, device, rng) -> tuple[torch.Tensor, torch.Tensor]:
    x = torch.from_numpy(rng.normal(size=(TRAIN_BATCH, n, CHANNELS)).astype(np.float32)).to(device)
    return x, 0.9 * x + 0.1


def _unbatched_step(graph, device, rng, kernels: tuple) -> dict:
    """The unbatched EPD train step at 256 channels (``bench.py``'s shape):
    time, peak memory and launch counts; fails unless each of ``kernels``
    ran. Returns the counts."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    x1 = torch.from_numpy(rng.normal(size=(graph.num_nodes, LATENT)).astype(np.float32)).to(device)
    m1 = _train_model(device, LATENT)
    torch.cuda.reset_peak_memory_stats()
    ms1 = _step_ms(_adam_step(m1, graph, x1, 0.9 * x1))
    launches = {k: c.launches for k, c in counters.items()}
    log(f"  unbatched EPD train step ({LATENT} channels): {ms1:.3f} ms, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if not all(launches[k] for k in kernels):
        raise AssertionError(f"the unbatched train step did not run {kernels}")
    del m1, x1
    torch.cuda.empty_cache()
    return launches


def train(graph, device, workdir: Path, processor: str = "gcn") -> dict:
    """Phases 6 and 7: train through the CLI (launch counts per step as
    remat off implies, no plain version on the card), one step against the
    plain versions, step times and peak memory, export and serve."""
    attention = processor == "attention"
    counters = _counters()
    out, launches = _run_train_mesh(workdir, device, processor)
    n = graph.num_nodes
    rng = np.random.default_rng(5)
    x, y = _train_batch(n, device, rng)
    model = _train_model(device, CHANNELS, processor=processor)
    _check_and_time_step(model, graph, x, y, processor)
    if attention:
        by_name = _profile_step(_adam_step(model, graph, x, y),
                                f"batch-{TRAIN_BATCH} attention")
        busy = sum(by_name.values())
        for key, kernel in (("B6", "attn_dq_kernel"), ("B7", "attn_dkdv_kernel")):
            us = sum(t for name, t in by_name.items() if kernel in name)
            log(f"  {key} ({kernel}) in the profiled attention step: "
                + (f"{us / 1e3:.3f} ms, {us / busy:.1%} of the device busy time"
                   if busy else "not measured"))
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
        _unbatched_step(graph, device, rng, ("B1", "B3"))

        # One step at the default batch with the cheapest remat policy that
        # fits.
        xb = torch.from_numpy(rng.normal(size=(DEFAULT_BATCH, n, CHANNELS))
                              .astype(np.float32)).to(device)
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

    _export_and_predict(out, n, device, workdir, rng, processor)
    return launches


def _export_and_predict(out: dict, n: int, device, workdir: Path, rng,
                        processor: str) -> None:
    """Training feeds serving: ``export`` the run of the ``train-mesh`` JSON
    line ``out`` through the CLI (its registry root, its experiment and,
    for a store-trained run, ``--data`` on its store), check the artifact
    (``rollout_steps`` 4, ``node_perm.npy`` the permutation
    ``ServingModel.load`` computes), answer one ``predict`` request of 2
    steps from it with every count from 0 (GCN: B1, B3 and B2 each 2 x
    ``PROCESS_STEPS``; attention: B5 and B2; nothing else, and no plain
    version on the card), then list the run with ``runs``."""
    import contextlib
    import io

    from gwen_tpu_torch.cli.main import main as cli
    from gwen_tpu_torch.registry import Run
    from gwen_tpu_torch.serve import ServingModel

    run_dir = Path(out["run_dir"])
    root, experiment = run_dir.parents[1], run_dir.parent.name
    meta = Run(run_dir).meta
    _, cfg = Run(run_dir).load_model()
    if cfg["processor"] != processor:
        raise AssertionError(f"the saved run is a {cfg['processor']} run")
    art = workdir / "trained"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = cli(["export", "--out", str(art), "--experiment", experiment,
                  *(("--data", cfg["data"]) if cfg.get("data") else ()),
                  "--device", str(device), f"run.registry_root={root}"])
    said = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"  export: {said}, {time.perf_counter() - t0:.1f} s")
    if rc != 0 or said["nodes"] != n or said["platform"] != torch.device(device).type:
        raise AssertionError(f"export returned {rc}: {said}")
    written = json.loads((art / "meta.json").read_text())
    sm = ServingModel.load(art, device)
    perm = np.load(art / "node_perm.npy")
    # 4: export's default --rollout-steps.
    if (written["rollout_steps"] != 4 or sm.rollout_steps != 4
            or not np.array_equal(perm, sm.node_perm)):
        raise AssertionError(f"artifact: rollout_steps {written['rollout_steps']}, "
                             "node_perm.npy "
                             f"{'equals' if np.array_equal(perm, sm.node_perm) else 'differs from'}"
                             " the served permutation")
    log(f"  artifact: rollout_steps {sm.rollout_steps}, node_perm.npy equals "
        f"the served graph's {written['metadata']['node_order']} order")
    del sm

    x0 = rng.normal(size=(n, CHANNELS)).astype(np.float32)
    np.save(workdir / "x_trained.npy", x0)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    PLAIN_ON_CUDA["calls"] = 0
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli(["predict", "--artifact", str(art), "--input",
                  str(workdir / "x_trained.npy"), "--steps", "2", "--out",
                  str(workdir / "y_trained.npy"), "--device", str(device)])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(dict.fromkeys(("B5", "B2") if processor == "attention"
                              else ("B1", "B3", "B2"), 2 * PROCESS_STEPS))
    traj = np.load(workdir / "y_trained.npy")
    if rc != 0 or traj.shape != (2, n, CHANNELS) or not np.isfinite(traj).all():
        raise AssertionError(f"predict from the trained run: rc {rc}, "
                             f"{traj.shape}, finite={np.isfinite(traj).all()}")
    log(f"  predict from the exported {processor} run"
        f"{' (graph from ' + cfg['data'] + ')' if cfg.get('data') else ''}: "
        f"{traj.shape}, finite; launches {launches} (want {want}); plain "
        f"versions called on CUDA tensors: {PLAIN_ON_CUDA['calls']}")
    if launches != want or PLAIN_ON_CUDA["calls"]:
        raise AssertionError(f"kernel launch counts {launches} != {want}, or a "
                             "plain version ran on the card")

    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = cli(["runs", "--root", str(root)])
    rows = [r for r in json.loads(buf.getvalue()) if r["run_id"] == out["run_id"]]
    log(f"  runs: {rows}")
    if (rc != 0 or len(rows) != 1 or rows[0]["experiment"] != experiment
            or rows[0]["status"] != "FINISHED"
            or rows[0]["best_metric"] != meta["best_metric"]
            or not math.isfinite(rows[0]["best_metric"])):
        raise AssertionError(f"runs --root {root} gave {rows}")


def train_packed(graphs: dict, device, workdir: Path) -> dict:
    """Phase 8: ``train-mesh`` on the bit-packed layouts (``diag_packed``
    for GCN and attention, ``packed`` for GCN): launch counts per step and
    no plain version on the card, one step against the plain versions, step
    time and peak memory (the ``packed`` step also under ``torch.profiler``);
    then the unbatched 256-channel EPD step on ``diag_packed`` (packed B1).
    Returns the packed kernels' launch counts on these paths."""
    launches = {}
    rng = np.random.default_rng(6)
    for kernel, processor, keys in (("diag_packed", "gcn", ("B4p",)),
                                    ("diag_packed", "attention", ()),
                                    ("packed", "gcn", ("B13",))):
        log(f"  -- mesh.kernel={kernel} model.processor={processor}")
        graph = graphs[kernel]
        _, got = _run_train_mesh(workdir / f"{kernel}-{processor}", device,
                                 processor, kernel)
        launches.update({k: got[k] for k in keys})
        x, y = _train_batch(graph.num_nodes, device, rng)
        model = _train_model(device, CHANNELS, processor=processor)
        _check_and_time_step(model, graph, x, y, f"{kernel} {processor}")
        if kernel == "packed":
            _profile_step(_adam_step(model, graph, x, y),
                          f"batch-{TRAIN_BATCH} {kernel} {processor}")
        del model, x, y
        torch.cuda.empty_cache()
    log("  -- the unbatched step on mesh.kernel=diag_packed")
    launches["B1p"] = _unbatched_step(graphs["diag_packed"], device, rng,
                                      ("B1p", "B3"))["B1p"]
    return launches


def _profile_step(step, tag: str, top: int = 10) -> dict:
    """One ``step()`` under ``torch.profiler`` (``profile_step``): logs the
    busy share of its span and its kernels by device time. Returns the µs
    by kernel name (empty where the trace held no device event)."""
    prof = profile_step(step)
    by_name = prof["kernels_us"]
    if not by_name:
        log(f"  {tag} profile: the trace holds no device event; kernel shares "
            "not measured")
        return by_name
    busy = sum(by_name.values())
    log(f"  {tag} profile of one step: device busy {prof['busy_ms']:.3f} ms of a "
        f"{prof['span_ms']:.3f} ms span ({prof['busy_share']:.1%}); by kernel:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"    {us / 1e3:8.3f} ms {us / busy:6.1%}  {name[:90]}")
    return by_name


def _task_step(model, loss_fn, graph, batch, tag: str,
               profile: bool = False) -> None:
    """Time one Adam step of ``loss_fn(batch, graph)`` (CUDA events, 3 steps
    after a warm-up) with its peak memory; with ``profile``, trace one more
    step and log its kernels' shares."""
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    def step():
        loss, _ = loss_fn(batch, graph)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = _step_ms(step, 3)
    log(f"  {tag} train step: {ms:.3f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        _profile_step(step, tag)


def check_unfused_attention(graph, device) -> dict:
    """Phase 9, first part: ``windowed_attention(backend="unfused")`` at
    the L7 attention shapes (nb 2, dh 128, bf16), forward and the q, k, v
    gradients, against ``backend="auto"`` (B5, B6, B7), and a batched
    ``diag_spmm_t`` (B9b) against its items; the launch counts the item
    loop implies and no plain version on the card. Both backends round P
    and the gradients to bf16 at their own places, so they are held to the
    sum of two bf16 bounds. Returns the launch counts."""
    from gwen_tpu_torch.ops.attention import diag_spmm_t, windowed_attention

    gen = torch.Generator(device=device).manual_seed(9)
    n, nb, dh = graph.num_nodes, ATTN_HEADS, LATENT // ATTN_HEADS

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    q, k, v = (randn(nb, n, dh).requires_grad_() for _ in range(3))
    cot = randn(nb, n, dh)

    def run(backend):
        out = windowed_attention(graph, q, k, v, backend=backend)
        return (out.detach(), *torch.autograd.grad(out, (q, k, v), cot))

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    PLAIN_ON_CUDA["calls"] = 0
    got = run("unfused")
    s, g = randn(nb, graph.num_padded_nodes, graph.window_size), randn(nb, n, dh)
    batched = diag_spmm_t(graph, s, g)
    launches = {key: c.launches for key, c in counters.items()}
    # Per item: B8 forward and for dP, B1 for P·V and for dQ, B9 for dV and
    # dK; one more B9 launch for the batched call and none yet for its items.
    want = dict.fromkeys(counters, 0)
    want.update(B8=2 * nb, B1=2 * nb, B9=2 * nb + 1)
    log(f"  launches of one unfused forward and backward (nb {nb}) and one "
        f"batched diag_spmm_t: { {k: v for k, v in launches.items() if v} }; "
        f"plain versions called on CUDA tensors: {PLAIN_ON_CUDA['calls']}")
    if launches != want or PLAIN_ON_CUDA["calls"]:
        raise AssertionError(f"unfused attention launched {launches}, want "
                             f"{want}, or a plain version ran on the card")
    for i in range(nb):
        compare(f"batched diag_spmm_t (B9b) item {i} vs the 2-D call (B9)",
                batched[i], diag_spmm_t(graph, s[i], g[i]), F32_TOL)
    del s, g, batched
    ref = run("auto")
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        compare(f"unfused vs auto {name} (nb {nb}, dh {dh})", a, b, 2 * BF16_TOL)
    del got, ref
    for backend in ("unfused", "auto"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fwd = cuda_ms(lambda: windowed_attention(graph, q, k, v, backend=backend),
                          5, 1)
        both = cuda_ms(lambda: run(backend), 5, 1)
        log(f"  windowed_attention backend={backend!r} (nb {nb}, dh {dh}): "
            f"forward {fwd:.3f} ms, forward and backward {both:.3f} ms, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    return launches


def ensemble_paths(graph, device, workdir: Path) -> None:
    """Phase 9, second part: ``train-mesh`` on the ensemble tasks, each to
    its end (skill verification included) with the launch counts it implies
    and no plain version on the card, then the task's train-step time and
    peak memory. CRPS: the model sees batch × members = 16 items a step
    (the batched kernels launch as for any batch), and the noise smoothing
    adds two batched aggregations of a float32 field per step. Rollout
    horizon 2: two forwards and backwards per step. Interaction: the COO
    graph, no kernel; at the largest batch of 1, 2, 4 whose step fits
    without remat."""
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      rcm_order)
    from gwen_tpu_torch.train import (ensemble_crps_loss_fn, mesh_graph_loss_fn,
                                      rollout_loss_fn)

    n = graph.num_nodes
    rng = np.random.default_rng(8)
    x, y = _train_batch(n, device, rng)
    base = expected_launches(False, PROCESS_STEPS)

    log("  -- train.loss=crps-ensemble (GCN, 4 members x batch 4)")
    _run_train_mesh(workdir / "crps", device, extra=("train.loss=crps-ensemble",),
                    per_step={"B4": base["B4"] + 2, "B10": base["B10"] + 2})
    for processor in ("gcn", "attention"):
        model = _train_model(device, CHANNELS, processor=processor)
        _task_step(model, ensemble_crps_loss_fn(model, num_members=4), graph,
                   (x, y, 3), f"batch-{TRAIN_BATCH} {processor} crps-ensemble",
                   profile=True)
        del model
    torch.cuda.empty_cache()

    log("  -- train.rollout_horizon=2 (GCN)")
    _run_train_mesh(workdir / "rollout", device,
                    extra=("train.rollout_horizon=2",),
                    per_step={k: 2 * v for k, v in base.items()})
    model = _train_model(device, CHANNELS)
    _task_step(model, rollout_loss_fn(model, 2), graph,
               (x, torch.stack([y, 0.9 * y + 0.1], dim=1)),
               f"batch-{TRAIN_BATCH} gcn rollout-horizon-2")
    del model
    torch.cuda.empty_cache()

    log("  -- model.processor=interaction (COO graph, RCM order)")
    verts, s, r = icosphere_edges(LEVELS)
    s2, r2, _ = apply_order(rcm_order(s, r, n), s, r)
    coo = build_graph(s2, r2, n).to(device)
    fits = 0
    for batch in (1, 2, 4):
        model = _train_model(device, CHANNELS, processor="interaction")
        try:
            _task_step(model, mesh_graph_loss_fn(model), coo,
                       (x[:batch], y[:batch]), f"batch-{batch} interaction")
            fits = batch
        except torch.cuda.OutOfMemoryError:
            log(f"  batch-{batch} interaction train step: out of memory")
        del model
        torch.cuda.empty_cache()
        if fits != batch:
            break
    if not fits:
        raise AssertionError("the interaction train step does not fit at batch 1")
    _run_train_mesh(workdir / "interaction", device, processor="interaction",
                    batch=fits)


def build_partition_layouts(device, kd_perm) -> dict:
    """The L7 mesh in RCM order as the windowed-dense layout (S in float32)
    and the blocked-ELL layout, one partition's local, halo-extended
    (non-square) operators of both and its banded operator (the ``sliding``
    layout, B10's wide window), and the blocked-ELL layout in the serving
    graph's KD-patch order (``kd_perm``), the order B1 and B4 are timed
    in."""
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      rcm_order, to_block_ell, to_windowed_dense)
    from gwen_tpu_torch.parallel import local_graph, partition_graph

    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    s2, r2, _ = apply_order(rcm_order(s, r, n), s, r)
    g = build_graph(s2, r2, n)
    halo = local_graph(partition_graph(s2, r2, n, 1, reorder=False,
                                       layout="dense"), 0).to(device)
    sliding = local_graph(partition_graph(s2, r2, n, 1, reorder=False,
                                          layout="sliding",
                                          s_dtype=torch.bfloat16), 0).to(device)
    return {"dense32": to_windowed_dense(g).to(device),
            "ell": to_block_ell(g).to(device),
            "ell_kd": to_block_ell(build_graph(
                *apply_order(kd_perm, s, r)[:2], n)).to(device),
            "halo_dense": halo.local_windowed_dense(),
            "halo_ell": halo.local_block_ell(),
            "halo_sliding": sliding.local_sliding_dense()}


def b11_modes(g32) -> list:
    """B11's six operand modes on the float32 layout ``g32``: ``(name, the
    layout the kernel takes, x's type, the float32 layout holding the
    values the kernel reads, tolerance)``. The kernel casts S to x's type,
    so the bf16 modes are held to S rounded to bf16."""
    r16 = dataclasses.replace(g32, s_mat=g32.s_mat.bfloat16())
    rr = dataclasses.replace(g32, s_mat=r16.s_mat.float())
    i8 = dataclasses.replace(g32, s_mat=(g32.s_mat != 0).to(torch.int8))
    i8f = dataclasses.replace(g32, s_mat=i8.s_mat.float())
    f32, b16 = torch.float32, torch.bfloat16
    return [("float32 S, float32 x", g32, f32, g32, F32_TOL),
            ("bf16 S, bf16 x", r16, b16, rr, BF16_TOL),
            ("bf16 S, float32 x", r16, f32, rr, F32_TOL),
            ("float32 S, bf16 x", g32, b16, rr, BF16_TOL),
            ("int8 S01, float32 x", i8, f32, i8f, F32_TOL),
            ("int8 S01, bf16 x", i8, b16, i8f, BF16_TOL)]


def check_b11_modes(g32, x: torch.Tensor, tag: str, timed: bool = False) -> dict:
    """B11 in each operand mode (:func:`b11_modes`) on ``x`` (bf16 values)
    against its plain version in float32; with ``timed``, each mode's time.
    Returns ``{mode name: (max abs error, ms or None)}``."""
    from gwen_tpu_torch.ops import spmm_cuda

    out = {}
    for name, g, dt, want_g, tol in b11_modes(g32):
        xt = x.to(dt)
        err = compare(f"B11 {tag} {name}", spmm_cuda.windowed_dense_spmm(g, xt),
                      spmm_cuda.windowed_dense_spmm_plain(want_g, x.float()), tol)
        ms = (cuda_ms(lambda: spmm_cuda.windowed_dense_spmm(g, xt),
                      5 if x.dim() == 3 else 20) if timed else None)
        if timed:
            log(f"    B11 {tag} {name}: {ms:.4f} ms")
        out[name] = (err, ms)
        torch.cuda.empty_cache()
    return out


def check_partition_kernels(layouts: dict, device, batch: int = TRAIN_BATCH) -> dict:
    """Phase 10, first part: B11 and B12 against their plain versions at L7
    (F 256; unbatched and batch 4; B12 in bf16 and float32, B11 in its six
    operand modes), timed beside the plain versions, the bound, the
    operator as stored and ``torch.sparse.mm`` on the same operator as a
    bf16 CSR; B11 in every mode and B12 on the halo-extended operator; B10
    on the ``sliding`` partition's wide window (the row gather) at batch 4,
    timed the same way. The bounds count a fixed operator as its nonzeros
    with their indices (B12: its nonzero slots)."""
    from gwen_tpu_torch.ops import spmm_cuda

    gen = torch.Generator(device=device).manual_seed(10)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    f = LATENT
    wd32, ell = layouts["dense32"], layouts["ell"]
    wd = dataclasses.replace(wd32, s_mat=wd32.s_mat.bfloat16())
    n = wd.num_nodes
    log(f"  RCM L{LEVELS}: windowed-dense S {tuple(wd.s_mat.shape)} "
        f"({wd.s_mat.nbytes / 2**20:.0f} MiB bf16, {wd32.s_mat.nbytes / 2**20:.0f} "
        f"MiB float32), ELL tables {tuple(ell.nbr.shape)}, window "
        f"{ell.window_size}")
    csr = window_csr(wd.s_mat, wd.window_start, wd.block_size, wd.num_src_rows)
    nnz = csr[2].numel()
    s_need = nonzero_bytes(wd.s_mat, "B11")
    ell_need = nonzero_slot_bytes(ell.nbr, ell.nbr_weight, "B12")
    results = {}
    b11, b11p = spmm_cuda.windowed_dense_spmm, spmm_cuda.windowed_dense_spmm_plain
    b12, b12p = spmm_cuda.block_ell_spmm, spmm_cuda.block_ell_spmm_plain
    for shape in ((n, f), (batch, n, f)):
        x = randn(*shape)
        nb = shape[0] if len(shape) == 3 else 1
        iters = 5 if nb > 1 else 20
        tag = f"{tuple(shape)}"
        modes = check_b11_modes(wd32, x, tag, timed=True)
        ms, plain_ms = timed_pair(lambda: b11(wd, x), lambda: b11p(wd, x), iters)
        lib = sparse_mm_ms(csr, x, iters)
        out_like = x.new_empty(*shape[:-2], wd.num_padded_nodes, f)
        row11 = dict(max_abs_err=modes["bf16 S, bf16 x"][0], ms=ms,
                     plain_ms=plain_ms,
                     **roofline((s_need, x), (out_like,), 2.0 * nnz * f * nb,
                                torch.bfloat16), library_ms=lib,
                     floor_ms=stored_floor_ms(wd.s_mat))
        log(f"    B11 {tag} float32 S under the bf16 x: floor (S as stored) "
            f"{stored_floor_ms(wd32.s_mat):.4f} ms")
        want = b12p(ell, x.float())
        err = compare(f"B12 {tag} bf16", b12(ell, x), want, BF16_TOL)
        compare(f"B12 {tag} f32", b12(ell, x.float()), want, F32_TOL)
        del want
        ms, plain_ms = timed_pair(lambda: b12(ell, x), lambda: b12p(ell, x), iters)
        row12 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     **roofline((ell_need, x), (out_like,),
                                2.0 * int((ell.nbr_weight != 0).sum()) * f * nb,
                                torch.bfloat16), library_ms=lib,
                     floor_ms=stored_floor_ms(ell.nbr, ell.nbr_weight))
        _log_times({f"B11 {tag}": row11, f"B12 {tag}": row12})
        if nb == 1:
            results.update(B11=row11, B12=row12)
        del x, out_like
        torch.cuda.empty_cache()
    del csr, wd
    # B12 on the same mesh in KD-patch order, where a block's sources span
    # nearly the whole array: the ordering B1 and B4 run in.
    kd = layouts["ell_kd"]
    for shape in ((n, f), (batch, n, f)):
        x = randn(*shape)
        compare(f"B12 {tuple(shape)} KD-patch order (window {kd.window_size}) "
                "bf16", b12(kd, x), b12p(kd, x.float()), BF16_TOL)
        ms, plain_ms = timed_pair(lambda: b12(kd, x), lambda: b12p(kd, x),
                                  5 if len(shape) == 3 else 20)
        log(f"  B12 {tuple(shape)} KD-patch order: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        del x
        torch.cuda.empty_cache()
    # One partition's local operator: ext_rows source rows, n_local outputs.
    for key in ("halo_dense", "halo_ell"):
        g = layouts[key]
        x = randn(batch, g.num_src_rows, f)
        tag = (f"{key} ({g.num_src_rows} source rows -> {g.num_padded_nodes}, "
               f"batch {batch})")
        if key == "halo_dense":
            check_b11_modes(g, x, tag)
        else:
            got = b12(g, x)
            if got.shape[-2] != g.num_padded_nodes:
                raise AssertionError(f"{key}: {g.num_src_rows} source rows gave "
                                     f"{tuple(got.shape)}")
            compare(f"{tag} bf16", got, b12p(g, x.float()), BF16_TOL)
            del got
        if g.num_src_rows == g.num_padded_nodes:
            raise AssertionError(f"{key} is not halo-extended")
        del x
        torch.cuda.empty_cache()
    # B10 on the `sliding` partition's band (the row gather, as at every
    # width), at the train shape.
    g = layouts["halo_sliding"]
    x = randn(batch, g.num_src_rows, f)
    tag = f"B10 wide window ({g.window_size}, batch {batch}, {g.num_src_rows} rows)"
    want = spmm_cuda.sliding_spmm_plain(
        dataclasses.replace(g, s_mat=g.s_mat.float()), x.float())
    err = compare(f"{tag} bf16", spmm_cuda.sliding_spmm_b(g, x), want, BF16_TOL)
    del want
    ms, plain_ms = timed_pair(lambda: spmm_cuda.sliding_spmm_b(g, x),
                              lambda: spmm_cuda.sliding_spmm_plain(g, x), 5)
    csr = window_csr(g.s_mat, g.window_start, g.block_size, g.num_src_rows)
    _log_times({tag: dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **roofline((nonzero_bytes(g.s_mat, "B10 wide window"), x),
                   (x[:, : g.num_padded_nodes],),
                   2.0 * csr[2].numel() * f * batch, torch.bfloat16),
        library_ms=sparse_mm_ms(csr, x, 5), floor_ms=stored_floor_ms(g.s_mat))})
    del x, csr
    torch.cuda.empty_cache()
    return results


def _halo_float32(graph):
    """One rank's halo graph with every S in float32, holding the values S
    has when rounded to bf16 (what the kernels see under a bf16 x)."""
    def f32(g):
        return dataclasses.replace(g, s_mat=g.s_mat.bfloat16().float())

    if hasattr(graph, "local"):
        return dataclasses.replace(
            graph, local=f32(graph.local),
            esc2=None if graph.esc2 is None else f32(graph.esc2))
    return graph if graph.s_mat is None else f32(graph)


def check_halo_operators(graph, processor: str, device,
                         batch: int = TRAIN_BATCH) -> None:
    """The partitioned path's operators on one rank's halo graph, at the
    shapes ``train-mesh`` gives them (batch 4, the halo-extended source
    rows), against their plain versions on the same path: for GCN
    ``aggregate_halo`` (``sliding``: B10 on the band; ``diag``: B4 over the
    extended rows with the fix rows of the gathered contraction, B10;
    ``dense``: B11; ``ell``: B12) in bf16 and in float32; for attention
    ``attend_halo`` (B5 on the extended K/V, B6 and B7 through its
    gradients) in bf16 against autograd through the plain forward in
    float32."""
    from gwen_tpu_torch.parallel import aggregate_halo, attend_halo

    gen = torch.Generator(device=device).manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    n = graph.n_local
    if processor == "attention":
        dh = LATENT // ATTN_HEADS
        ts = [randn(ATTN_HEADS, batch, n, dh).requires_grad_() for _ in range(3)]
        cot = randn(ATTN_HEADS, batch, n, dh).float()
        out = attend_halo(graph, *ts)
        got = (out, *torch.autograd.grad((out.float() * cot).sum(), ts))
        t32 = [t.detach().float().requires_grad_() for t in ts]
        out = attend_halo(graph, *t32, backend="plain")
        want = (out, *torch.autograd.grad((out * cot).sum(), t32))
        for name, a, b in zip(("forward", "dq", "dk", "dv"), got, want):
            compare(f"attend_halo {name} ({ATTN_HEADS} heads x batch {batch}, "
                    f"{graph.ext_rows} extended rows) vs plain", a.detach(),
                    b.detach(), BF16_TOL)
        return
    g32 = _halo_float32(graph)
    x = randn(batch, n, LATENT)
    want = aggregate_halo(g32, x.float(), backend="plain")
    tag = (f"aggregate_halo on {type(graph).__name__} (batch {batch}, "
           f"{graph.ext_rows} extended rows -> {n})")
    compare(f"{tag} bf16", aggregate_halo(graph, x), want, BF16_TOL)
    compare(f"{tag} f32", aggregate_halo(g32, x.float()), want, F32_TOL)


def partitioned_paths(device, workdir: Path) -> dict:
    """Phase 10, second part: ``train-mesh`` on the partitioned path with
    one rank, for each partition layout (GCN) and for attention on ``diag``:
    launch counts per step, no plain version on the card, finite skill
    numbers; then, on the same rank's graph, the halo operators against
    their plain versions, one train step against the same step through the
    plain versions, and the layout's train-step time, peak memory and
    profile. Returns the launch counts of B11 and B12 on these paths."""
    from gwen_tpu_torch.graph import (apply_order, icosphere_edges,
                                      kd_patch_order, rcm_order)
    from gwen_tpu_torch.parallel import make_partitioned_apply, partition_graph
    from gwen_tpu_torch.train import make_mesh, partitioned_mesh_loss_fn

    launches = {}
    rng = np.random.default_rng(10)
    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    orders = {}
    for layout, processor in (("sliding", "gcn"), ("diag", "gcn"), ("dense", "gcn"),
                              ("ell", "gcn"), ("diag", "attention")):
        log(f"  -- mesh.partition_layout={layout} model.processor={processor}")
        _, got = _run_train_mesh(workdir / f"part-{layout}-{processor}", device,
                                 processor, partition=layout)
        launches.update({k: got[k] for k in ("B11", "B12") if got[k]})
        kd = layout == "diag"
        if kd not in orders:
            perm = kd_patch_order(np.asarray(verts), s, r, n) if kd else rcm_order(s, r, n)
            orders[kd] = apply_order(perm, s, r)[:2]
        pg = partition_graph(*orders[kd], n, num_parts=1, reorder=False,
                             layout=layout, s_dtype=torch.bfloat16,
                             diag_window=WINDOW)
        model = _train_model(device, CHANNELS, processor=processor)
        apply_fn = make_partitioned_apply(model, pg, make_mesh(1, 1), device,
                                          transpose_tables=processor == "attention")
        check_halo_operators(apply_fn.graph, processor, device)
        torch.cuda.empty_cache()
        x, y = _train_batch(pg.padded_nodes, device, rng)
        try:
            _against_plain_step(model, apply_fn.graph, x, y)
        except torch.cuda.OutOfMemoryError:
            log(f"  the plain versions' step at batch {TRAIN_BATCH} is out of "
                "memory; comparing at batch 2")
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            _against_plain_step(model, apply_fn.graph, x[:2], y[:2])
        loss_fn = partitioned_mesh_loss_fn(apply_fn)
        _task_step(model, lambda batch, _: loss_fn(batch), None, (x, y),
                   f"batch-{TRAIN_BATCH} partitioned {layout} {processor}",
                   profile=True)
        del model, apply_fn, pg, x, y
        torch.cuda.empty_cache()
    return launches


def build_tile_layouts(device, kd_perm) -> dict:
    """The L7 mesh as the block-tile layout in RCM order and in the serving
    graph's KD-patch order (``kd_perm``), a ``num_src``-extended (non-square)
    operator, the int8 rank-1 banded layout in RCM order, and the RCM-ordered
    COO graph they came from."""
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      rcm_order, to_block_tiles, to_sliding_rank1)

    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    g = build_graph(*apply_order(rcm_order(s, r, n), s, r)[:2], n)
    g_kd = build_graph(*apply_order(kd_perm, s, r)[:2], n)
    return {"coo": g.to(device), "coo_kd": g_kd.to(device),
            "rcm": to_block_tiles(g).to(device),
            "kd": to_block_tiles(g_kd).to(device),
            "ext": to_block_tiles(g, num_src=n + 1536).to(device),
            "rank1": to_sliding_rank1(g).to(device)}


def build_hub_tiles(device):
    """An L5 mesh in RCM order with a hub joined both ways to every node
    within 150 rows of it (a row of ~300 live slots, wider than the B14
    walk's list of 32 entries), as the block-tile layout (block 128), with
    the COO graph it came from."""
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      rcm_order, to_block_tiles)

    verts, s, r = icosphere_edges(5)
    n = verts.shape[0]
    s2, r2, _ = apply_order(rcm_order(s, r, n), s, r)
    s2, r2 = np.asarray(s2, np.int64), np.asarray(r2, np.int64)
    h, near = n // 2, set(s2[r2 == n // 2].tolist())
    others = np.array([c for c in range(h - 150, h + 150) if c != h and c not in near])
    g = build_graph(np.concatenate([s2, others, np.full(others.size, h)]),
                    np.concatenate([r2, np.full(others.size, h), others]), n)
    tiles = to_block_tiles(g)
    live = int((tiles.tw != 0).sum(1).max())
    if live <= 32:
        raise AssertionError(f"the hub tile graph's widest row has {live} live slots")
    log(f"  hub block-tile graph: nodes {n}, {tiles.tnbr.shape[1]} slots a row, "
        f"widest row {live} live slots")
    return g.to(device), tiles.to(device)


def coo_csr(graph, rows: int, cols: int) -> tuple:
    """A COO graph's operator as CSR parts ``(crow, cols, values, size)``
    with duplicate edges summed."""
    e = graph.num_edges
    a = torch.sparse_coo_tensor(
        torch.stack([graph.receivers[:e], graph.senders[:e]]),
        graph.weights[:e], size=(rows, cols)).coalesce().to_sparse_csr()
    return a.crow_indices(), a.col_indices(), a.values(), (rows, cols)


def build_rank1_layout(device) -> dict:
    """The L7 mesh in RCM order as the int8 rank-1 banded layout and as the
    COO graph it came from."""
    from gwen_tpu_torch.graph import (apply_order, build_graph, icosphere_edges,
                                      rcm_order, to_sliding_rank1)

    verts, s, r = icosphere_edges(LEVELS)
    n = verts.shape[0]
    g = build_graph(*apply_order(rcm_order(s, r, n), s, r)[:2], n)
    return {"coo": g.to(device), "rank1": to_sliding_rank1(g).to(device)}


def check_rank1_kernels(layouts: dict, device, batch: int = TRAIN_BATCH) -> dict:
    """Phase 3, last part: the int8 rank-1 form of B3 and B10 in RCM order
    (B3r, B10r; F 256, unbatched and batch 4): one launch a call, bf16
    against its plain version (one rounding) and against
    ``aggregate_segment``, float32 against the plain version, the x-gradient
    against autograd through the plain version; timed beside the plain
    version, the bound (S01's nonzeros with their indices, both scales, x
    and the output) and ``torch.sparse.mm`` on the weighted operator as a
    bf16 CSR."""
    from gwen_tpu_torch.ops import aggregate_segment, spmm_cuda

    gen = torch.Generator(device=device).manual_seed(13)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    r1, coo = layouts["rank1"], layouts["coo"]
    f, n, results = LATENT, r1.num_nodes, {}
    core = r1.core
    kern, plain = spmm_cuda.sliding_rank1_spmm, spmm_cuda.sliding_rank1_spmm_plain
    log(f"  int8 rank-1 banded layout (RCM): S01 {tuple(core.s_mat.shape)} int8 "
        f"({core.s_mat.nbytes / 2**20:.0f} MiB; bf16 S would be "
        f"{core.s_mat.nbytes * 2 / 2**20:.0f} MiB), window {core.window_size}, "
        f"scales {(r1.col_scale.nbytes + r1.row_scale.nbytes) / 1e6:.2f} MB")
    # The weighted operator a_r a_s ⊙ S01 is the COO graph's: the library
    # call computes the same function as the composite.
    csr = coo_csr(coo, r1.num_padded_nodes, r1.num_src_rows)
    need = nonzero_bytes(core.s_mat, "int8 S01")
    for shape in ((n, f), (batch, n, f)):
        x = randn(*shape)
        nb = shape[0] if len(shape) == 3 else 1
        name = "B10r" if nb > 1 else "B3r"
        tag = f"{name} (int8 rank-1 form of {'B10' if nb > 1 else 'B3'}) {tuple(shape)}"
        before = {k: c.launches for k, c in _counters().items()}
        got = spmm_cuda.spmm_sliding_rank1(r1, x)
        ran = {k: c.launches - before[k] for k, c in _counters().items()
               if c.launches != before[k]}
        if ran != {"B3r": 1}:
            raise AssertionError(f"spmm_sliding_rank1 {tuple(shape)} launched {ran}, "
                                 "want one int8 rank-1 gather")
        # One rounding in bf16 (both scales inside the gather), as the plain
        # version rounds: held to it and to the float32 segment sum alike.
        err = compare(f"{tag} bf16", got,
                      spmm_cuda.spmm_sliding_rank1(r1, x, plain=True), BF16_TOL)
        want = spmm_cuda.spmm_sliding_rank1(r1, x.float(), plain=True)
        compare(f"{tag} f32", spmm_cuda.spmm_sliding_rank1(r1, x.float()), want,
                F32_TOL)
        compare(f"{tag} against aggregate_segment (float32)", got,
                aggregate_segment(coo, x.float()), BF16_TOL)
        del want
        xg = x.clone().requires_grad_()
        cot = randn(*shape).float()
        (gk,) = torch.autograd.grad(
            (spmm_cuda.spmm_sliding_rank1(r1, xg).float() * cot).sum(), xg)
        x32 = x.float().requires_grad_()
        (gp,) = torch.autograd.grad(
            (spmm_cuda.spmm_sliding_rank1(r1, x32, plain=True) * cot).sum(), x32)
        compare(f"{tag} x-gradient vs autograd through the plain version", gk, gp,
                BF16_TOL)
        del xg, cot, gk, gp, x32
        iters = 3 if nb > 1 else 10
        ms, plain_ms = timed_pair(lambda: kern(r1, x), lambda: plain(r1, x), iters)
        comp_ms = cuda_ms(lambda: spmm_cuda.spmm_sliding_rank1(r1, x), iters)
        log(f"  {tag}: the composite spmm_sliding_rank1 {comp_ms:.4f} ms (one "
            f"launch), the kernel alone {ms:.4f} ms")
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **roofline((need, r1.col_scale, r1.row_scale, x), (got,),
                       2.0 * int((core.s_mat != 0).sum()) * f * nb, torch.bfloat16),
            library_ms=sparse_mm_ms(csr, x, iters),
            floor_ms=stored_floor_ms(core.s_mat, r1.col_scale, r1.row_scale))
        _log_times({tag: results[name]})
        del x, got
        torch.cuda.empty_cache()
    del csr
    return results


def check_tile_kernels(layouts: dict, device, batch: int = TRAIN_BATCH) -> dict:
    """Phase 11, first part: B14 against its plain version at L7 in RCM and
    in KD-patch order (F 256; unbatched, batch 4 and batch 5, a group of
    four and one item more; bf16 and float32), on an L5 graph with a hub
    row of more live slots than the walk's list holds (:func:`build_hub_tiles`;
    unbatched, batch 4 and batch 5 on fewer x rows), on a
    float32 field of F 1 and 3, on a ``num_src``-extended operator, and the
    x-gradient of ``spmm_block_tiles`` against autograd through the plain
    version; timed beside the plain version, the bound (x, the output and
    the tables as the port stores them) and ``torch.sparse.mm`` on the same
    operator as a bf16 CSR, held to the kernel first."""
    from gwen_tpu_torch.ops import aggregate_segment, spmm_cuda

    gen = torch.Generator(device=device).manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    f = LATENT
    b14, b14p = spmm_cuda.block_tiles_spmm, spmm_cuda.block_tiles_spmm_plain
    results = {}
    n = layouts["rcm"].num_nodes
    for order in ("rcm", "kd"):
        t = layouts[order]
        nnz = int((t.tw != 0).sum())
        log(f"  B14 {order} order: tiles_max {t.tiles_max}, mean n_active "
            f"{t.n_active.float().mean().item():.2f}, tile_degree {t.tile_degree}, "
            f"{t.tnbr.shape[1]} slots a row (uint8 index, float32 weight), tile "
            f"lists {(t.tile_idx.nbytes + t.n_active.nbytes) / 1e6:.2f} MB")
        need = nonzero_slot_bytes(t.tnbr, t.tw, f"B14 {order}")
        coo = layouts["coo" if order == "rcm" else "coo_kd"]
        csr = coo_csr(coo, t.num_padded_nodes, t.num_src_rows)
        for shape in ((n, f), (batch, n, f), (batch + 1, n, f)):
            x = randn(*shape)
            nb = shape[0] if len(shape) == 3 else 1
            iters = 5 if nb > 1 else 20
            tag = f"{order} {tuple(shape)}"
            want = b14p(t, x.float())
            got = b14(t, x)
            err = compare(f"B14 {tag} bf16", got, want, BF16_TOL)
            compare(f"B14 {tag} f32", b14(t, x.float()), want, F32_TOL)
            compare(f"B14 {tag} against aggregate_segment", got[..., :n, :],
                    aggregate_segment(coo, x.float()), BF16_TOL)
            if nb > batch:  # correctness only
                del want, x, got
                continue
            x2 = spmm_cuda._fit_rows(x, t.num_src_rows)
            x2 = x2.transpose(0, 1).reshape(t.num_src_rows, -1) if nb > 1 else x2
            # The same function: held in float32, where the library rounds once.
            lib_out = torch.sparse.mm(torch.sparse_csr_tensor(
                csr[0], csr[1], csr[2], size=csr[3]), x2.float().contiguous())
            if nb > 1:
                lib_out = lib_out.reshape(-1, nb, f).transpose(0, 1)
            compare(f"B14 {tag} against torch.sparse.mm", got, lib_out, BF16_TOL)
            del want, lib_out, x2
            ms, plain_ms = timed_pair(lambda: b14(t, x), lambda: b14p(t, x), iters)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       **roofline((t.tile_idx, t.n_active, need, x), (got,),
                                  2.0 * nnz * f * nb, torch.bfloat16),
                       library_ms=sparse_mm_ms(csr, x, iters))
            _log_times({f"B14 {tag}": row})
            if order == "rcm" and nb == 1:
                results["B14"] = row
            del x, got
            torch.cuda.empty_cache()
        del csr
    t = layouts["rcm"]
    for ch in (1, 3):
        x = torch.randn(batch, n, ch, generator=gen, device=device)
        compare(f"spmm_block_tiles on a float32 field (batch {batch}, F {ch})",
                spmm_cuda.spmm_block_tiles(t, x),
                spmm_cuda.spmm_block_tiles(t, x, plain=True), F32_TOL)
    coo, hub = build_hub_tiles(device)
    for shape in ((hub.num_nodes, f), (batch, hub.num_nodes, f),
                  (batch + 1, hub.num_nodes - 10, 24)):
        x = randn(*shape)
        want = b14p(hub, x.float())
        compare(f"B14 hub graph {shape} bf16", b14(hub, x), want, BF16_TOL)
        compare(f"B14 hub graph {shape} f32", b14(hub, x.float()), want, F32_TOL)
    del coo, hub
    ext = layouts["ext"]
    x = randn(batch, ext.num_src_rows, f)
    got = b14(ext, x)
    if got.shape[-2] != ext.num_padded_nodes or ext.num_src_rows == ext.num_padded_nodes:
        raise AssertionError(f"B14 extended: {ext.num_src_rows} source rows gave "
                             f"{tuple(got.shape)}")
    compare(f"B14 num_src-extended ({ext.num_src_rows} source rows -> "
            f"{ext.num_padded_nodes}, batch {batch}) bf16", got,
            b14p(ext, x.float()), BF16_TOL)
    del x, got
    for shape in ((n, f), (batch, n, f)):
        x = randn(*shape).requires_grad_()
        cot = randn(*shape).float()
        (gk,) = torch.autograd.grad(
            (spmm_cuda.spmm_block_tiles(t, x).float() * cot).sum(), x)
        x32 = x.detach().float().requires_grad_()
        (gp,) = torch.autograd.grad(
            (spmm_cuda.spmm_block_tiles(t, x32, plain=True) * cot).sum(), x32)
        compare(f"spmm_block_tiles x-gradient {tuple(shape)} vs autograd through "
                "the plain version", gk, gp, BF16_TOL)
        del x, cot, gk, gp, x32
    torch.cuda.empty_cache()

    return results


RANK1_PROFILE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from gwen_tpu_torch.ops import spmm_cuda
from gwen_tpu_torch.profiling import device_events
dev = torch.device("cuda", 0)
r1 = cs.build_rank1_layout(dev)["rank1"]
out = {}
for shape in ((r1.num_nodes, cs.LATENT), (cs.TRAIN_BATCH, r1.num_nodes, cs.LATENT)):
    x = torch.randn(*shape, device=dev).bfloat16()
    spmm_cuda.spmm_sliding_rank1(r1, x)
    out[str(shape)] = [ev.name for ev in device_events(
        lambda: spmm_cuda.spmm_sliding_rank1(r1, x))]
print(json.dumps(out))
"""


ATTN_PROFILE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from gwen_tpu_torch.ops import attention_cuda as ac
from gwen_tpu_torch.profiling import device_events
dev = torch.device("cuda", 0)
graph = cs.build_serving_graph(dev, torch.bfloat16)[0]
out, scale = {}, 128 ** -0.5
for lead in ((), (cs.ATTN_HEADS * cs.TRAIN_BATCH,)):
    q, k, v, g = (torch.randn(*lead, graph.num_nodes, 128, device=dev).bfloat16()
                  for _ in range(4))
    ac.attention_fwd(graph, q, k, v, scale)
    st = ac.attention_dq(graph, q, k, v, g, scale)[1]
    ac.attention_dkdv(graph, q, k, v, g, st, scale)
    nb = lead[0] if lead else 1
    out[f"B5 nb {nb}"] = [ev.name for ev in device_events(
        lambda: ac.attention_fwd(graph, q, k, v, scale))]
    out[f"B6 nb {nb}"] = [ev.name for ev in device_events(
        lambda: ac.attention_dq(graph, q, k, v, g, scale))]
    out[f"B7 nb {nb}"] = [ev.name for ev in device_events(
        lambda: ac.attention_dkdv(graph, q, k, v, g, st, scale))]
print(json.dumps(out))
"""


def one_kernel_per_call(script: str, what: str, want: dict) -> None:
    """Fail unless each call that the child ``script`` runs once under
    ``torch.profiler`` ran exactly one device kernel, named with the
    substring ``want`` gives for the call's key prefix. In a fresh child
    process: in this one, after the kernel builds and Triton's compiles of
    phase 2, a profiler window of one call has come back without the device
    kernel it ran (on an H100, torch 2.11); windows of many calls keep
    theirs. Run last, as the NCCL probe: the parent's own traces are read
    before it."""
    torch.cuda.empty_cache()  # the child allocates on the same card
    res = subprocess.run([sys.executable, "-c", script,
                          str(Path(__file__).resolve().parent)],
                         timeout=300, capture_output=True, text=True)
    if res.returncode != 0:
        raise AssertionError(f"the {what} profile run failed:\n{res.stderr[-2000:]}")
    for call, names in json.loads(res.stdout.strip().splitlines()[-1]).items():
        kernel = next(v for k, v in want.items() if call.startswith(k))
        log(f"  {what} {call}: one call under torch.profiler ran "
            f"{len(names)} device kernel(s) {[nm[:60] for nm in names]}")
        if len(names) != 1 or kernel not in names[0]:
            raise AssertionError(f"{what} {call}: one call ran {names}, want one "
                                 f"{kernel}")


def rank1_path(layouts: dict, device) -> dict:
    """Phase 11: the int8 rank-1 layout as a user calls it: ``aggregate`` forward and
    backward, unbatched and at batch 4, with every launch count set to 0
    before. Each call is one launch of the int8 rank-1 gather (B3r/B10r)
    and nothing else. Returns the counts."""
    from gwen_tpu_torch.ops import aggregate

    r1 = layouts["rank1"]
    gen = torch.Generator(device=device).manual_seed(12)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    PLAIN_ON_CUDA["calls"] = 0
    for shape in ((r1.num_nodes, LATENT), (TRAIN_BATCH, r1.num_nodes, LATENT)):
        x = torch.randn(*shape, generator=gen, device=device).bfloat16()
        x.requires_grad_()
        out = aggregate(r1, x)
        out.float().square().sum().backward()
        if (out.shape != x.shape or not bool(torch.isfinite(out).all())
                or not bool(torch.isfinite(x.grad).all())):
            raise AssertionError(f"aggregate on the int8 rank-1 layout {shape}: "
                                 f"{tuple(out.shape)}, not finite")
    launches = {k: c.launches for k, c in counters.items()}
    want = {**dict.fromkeys(counters, 0), "B3r": 4}
    log(f"  launches of aggregate on the int8 rank-1 layout, forward and "
        f"backward, unbatched and batch {TRAIN_BATCH}: "
        f"{ {k: v for k, v in launches.items() if v} }; plain versions called on "
        f"CUDA tensors: {PLAIN_ON_CUDA['calls']}")
    if launches != want or PLAIN_ON_CUDA["calls"]:
        raise AssertionError(f"int8 rank-1 path launched {launches}, want {want}, "
                             "or a plain version ran on the card")
    return launches


def tile_model_paths(layouts: dict, device) -> dict:
    """Phase 11, second part: the EPD model on the L7 ``BlockTileGraph`` (RCM
    order, latent 256, 4 process steps, bf16), driven as its users drive
    this layout, ``EncodeProcessDecode(...)(to_block_tiles(g), x)``: serves
    3 x 4 steps under ``inference_mode`` (B14 and B2 4 launches per step),
    one step against the plain versions; 5 Adam steps at batch 4 through
    ``Trainer`` and ``mesh_graph_loss_fn`` (B14 8 per step, B2 and B2b 4),
    one step's loss and gradients against the plain versions, step time and
    peak memory; no plain version on the card. Then one float32 forward on
    the L7 multimesh (finest level through B12, the coarse levels through
    ``index_add_``) against the same model on the union as one COO graph.
    Returns the launch counts of the served and trained runs."""
    from gwen_tpu_torch.graph import (apply_order, build_graph,
                                      build_multilevel_graph,
                                      icosphere_multilevel_edges, rcm_order)
    from gwen_tpu_torch.nn import EncodeProcessDecode
    from gwen_tpu_torch.train import (Trainer, TrainState, make_optimizer,
                                      mesh_graph_loss_fn)

    graph = layouts["rcm"]
    n = graph.num_nodes
    counters = _counters()

    def reset():
        for c in counters.values():
            c.launches = 0
        PLAIN_ON_CUDA["calls"] = 0

    def held(tag, per_step, steps):
        got = {k: c.launches for k, c in counters.items()}
        want = {**dict.fromkeys(counters, 0),
                **{k: v * steps for k, v in per_step.items()}}
        log(f"  launches {tag}: { {k: v for k, v in got.items() if v} } (want "
            f"{ {k: v for k, v in want.items() if v} }); plain versions called "
            f"on CUDA tensors: {PLAIN_ON_CUDA['calls']}")
        if got != want or PLAIN_ON_CUDA["calls"]:
            raise AssertionError(f"{tag}: kernel launch counts {got} != {want}, "
                                 "or a plain version ran on the card")
        return got

    # Serving: 3 requests of 4 steps.
    model = _serving_model(device, "gcn")
    inputs = [torch.from_numpy(np.random.default_rng(110 + k).normal(
        size=(n, CHANNELS)).astype(np.float32)).to(device) for k in range(REQUESTS)]
    reset()
    step_ms, first = [], None
    with torch.inference_mode():
        for x in inputs:
            for _ in range(ROLLOUT_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                x = model(graph, x)
                end.record()
                torch.cuda.synchronize()
                step_ms.append(start.elapsed_time(end))
                first = x if first is None else first
            if x.shape != (n, CHANNELS) or not bool(torch.isfinite(x).all()):
                raise AssertionError(f"block-tile rollout gave {tuple(x.shape)}")
    served = held("while serving on the block-tile graph",
                  {"B14": PROCESS_STEPS, "B2": PROCESS_STEPS},
                  REQUESTS * ROLLOUT_STEPS)
    with torch.inference_mode():
        model.backend = "plain"
        plain = model(graph, inputs[0])
        model.backend = "auto"
    compare("served block-tile step vs plain versions", first, plain, BF16_TOL,
            ulps=STEP_ULPS)
    log(f"  serve block-tile step ms: median {np.median(step_ms):.3f}, steady "
        f"median (first step of each request left out) "
        f"{np.median([v for i, v in enumerate(step_ms) if i % ROLLOUT_STEPS]):.3f}")
    del model, plain, first

    # Training: 5 Adam steps at batch 4 through the Trainer.
    rng = np.random.default_rng(111)
    steps = 5
    model = _train_model(device, CHANNELS)
    trainer = Trainer(mesh_graph_loss_fn(model), device, log_every=0,
                      context=graph)

    def batches(_epoch):
        for _ in range(steps):
            x = rng.normal(size=(TRAIN_BATCH, n, CHANNELS)).astype(np.float32)
            yield x, 0.9 * x + 0.1

    reset()
    state, best = trainer.fit(
        TrainState(model, make_optimizer(model.parameters(), 1e-4)), batches, 1)
    torch.cuda.synchronize()
    if state.step != steps or not math.isfinite(best):
        raise AssertionError(f"block-tile training: {state.step} steps, loss {best}")
    trained = held("while training on the block-tile graph",
                   expected_launches(False, PROCESS_STEPS, "gcn", "tiles"), steps)
    log(f"  block-tile training: {steps} steps, mean loss {best:.6g}")
    x, y = _train_batch(n, device, rng)
    _check_and_time_step(model, trainer.context, x, y, "block-tile")
    del model, trainer, state, x, y
    torch.cuda.empty_cache()

    # The multimesh: finest level as blocked ELL, coarse levels as COO.
    t0 = time.perf_counter()
    verts, s, r, lv = icosphere_multilevel_edges(LEVELS)
    fine = lv == lv.max()
    s2, r2, _ = apply_order(rcm_order(s[fine], r[fine], n), s, r)
    ml = build_multilevel_graph(s2, r2, lv, n, fine_layout="ell").to(device)
    union = build_graph(s2, r2, n).to(device)
    log(f"  L{LEVELS} multimesh built in {time.perf_counter() - t0:.1f} s: "
        f"{len(ml.subgraphs)} levels, {ml.num_edges} edges with self loops, "
        f"finest level {type(ml.subgraphs[-1]).__name__} (window "
        f"{ml.subgraphs[-1].window_size}), coarse levels "
        f"{sum(g.num_edges for g in ml.subgraphs[:-1])} edges as COO")
    # float32: the union's index_add_ in bf16 rounds after every edge.
    model = EncodeProcessDecode(
        CHANNELS, CHANNELS, device=device, latent_size=LATENT,
        process_steps=PROCESS_STEPS, generator=torch.Generator().manual_seed(0)).eval()
    x = inputs[0]
    reset()
    with torch.inference_mode():
        got = model(ml, x)
    held("of one forward on the multimesh", {"B12": PROCESS_STEPS, "B2": PROCESS_STEPS}, 1)
    with torch.inference_mode():
        want = model(union, x)
    compare("EPD forward on the multimesh (B12 + index_add_) vs the union as one "
            "COO graph, float32", got, want, 1e-4)
    return {"served": served, "trained": trained}


def store_paths(device, workdir: Path) -> None:
    """Phase 11, third part: ``make-mesh-data`` → ``train-mesh --data`` at
    ``graph.refine=7``, batch 4, default ``mesh.kernel`` (launch counts as
    phase 6, finite skill numbers), once more with ``data.lazy=true`` on a
    shorter store, then ``export --data`` on the run and ``predict`` on the
    artifact, whose graph comes from the store's sidecar."""
    import contextlib
    import io

    from gwen_tpu_torch.cli.main import main as cli
    from gwen_tpu_torch.data import zarrstore
    from gwen_tpu_torch.graph import icosphere_edges

    n = icosphere_edges(LEVELS)[0].shape[0]
    rng = np.random.default_rng(112)
    for name, steps, extra in (("mesh16.zarr", 16, ()),
                               ("mesh12.zarr", 12, ("data.lazy=true",))):
        store = workdir / name
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = cli(["make-mesh-data", "--out", str(store), "--members", "4",
                      "--steps", str(steps), f"graph.refine={LEVELS}"])
        made = json.loads(buf.getvalue().strip().splitlines()[-1])
        arr = zarrstore.open_array(store)
        on_disk = sum(f.stat().st_size for f in store.iterdir())
        log(f"  -- make-mesh-data: {made}, {time.perf_counter() - t0:.1f} s, "
            f"{on_disk / 2**20:.1f} MiB on disk, chunks {arr.chunks}; train-mesh "
            f"--data {' '.join(extra)}")
        if rc != 0 or made["fields"] != [steps, 4, n, CHANNELS]:
            raise AssertionError(f"make-mesh-data returned {rc}: {made}")
        out, _ = _run_train_mesh(workdir / f"runs-{steps}", device,
                                 extra=("--data", str(store), *extra))
        if out["nodes"] != n:
            raise AssertionError(f"train-mesh --data saw {out['nodes']} nodes")
        if not extra:
            _export_and_predict(out, n, device, workdir, rng, "gcn")


def member_graph_pipeline(device, workdir: Path) -> None:
    """Phase 11, fourth part: ``preprocess`` → ``train-gnn --no-animate`` on
    a raw store written here: 125 members (124 inputs, 1 target), fully
    connected member graph, a field of height 32 x ncells 512 (16,384
    features a member node; the original GWEN publishes no field size, this
    one is this script's), 40 time steps, ``hidden_feats`` 1024, batch 4, 1
    epoch, and ``train-cnn --no-animate`` on its stores at batch 21, both
    launched together as a user launches the data-parallel runs, under
    ``torch.distributed.run --nproc_per_node 1`` (:func:`launched`): finite
    losses and rank 0's runs in the registry; then ten train steps
    at those shapes, each timed, with the peak memory and one step's
    profile (:func:`_step_spread`). The aggregation here is ``adj @ x`` on
    a 125 x 125 matrix, a plain product in the reference too: the path runs
    no hand-written kernel."""
    import contextlib
    import io

    from gwen_tpu_torch.cli.main import main as cli
    from gwen_tpu_torch.data import zarrstore
    from gwen_tpu_torch.graph import build_graph, erdos_renyi_edges, to_dense
    from gwen_tpu_torch.nn import GCNStack
    from gwen_tpu_torch.nn.core import count_params
    from gwen_tpu_torch.registry import Registry
    from gwen_tpu_torch.train import gnn_loss_fn

    t_len, members, height, ncells, hidden, split = 40, 125, 32, 512, 1024, 124
    rng = np.random.default_rng(113)
    t0 = time.perf_counter()
    tt = np.arange(t_len, dtype=np.float32)[:, None, None, None]
    mm = np.arange(members, dtype=np.float32)[None, :, None, None]
    hh = np.arange(height, dtype=np.float32)[None, None, :, None]
    cc = np.arange(ncells, dtype=np.float32)[None, None, None, :]
    raw = (280 + 5 * np.sin(0.3 * tt + 0.05 * mm) * np.cos(0.2 * hh + 0.02 * cc)
           + 0.1 * rng.standard_normal((t_len, members, height, ncells),
                                       dtype=np.float32)).astype(np.float32)
    arr = zarrstore.create(workdir / "raw.zarr", raw.shape,
                           ("time", "member", "height", "ncells"),
                           chunks=(32, 1, height, ncells),
                           meta={"variable": "theta_v",
                                 "members": [f"{m}.0_3000.0_2000.0"
                                             for m in range(members)]})
    arr.write(..., raw)
    log(f"  raw store {raw.shape} ({raw.nbytes / 2**20:.0f} MiB) written in "
        f"{time.perf_counter() - t0:.1f} s")
    del raw
    cfg = {"data": {"zarr_path": str(workdir / "raw.zarr"),
                    "data_train": str(workdir / "train.zarr"),
                    "data_test": str(workdir / "test.zarr"),
                    "scaling_path": str(workdir / "scaling.json"),
                    "boundary_cells": 0},
           "model": {"hidden_feats": hidden},
           "train": {"member_split": split, "batch_size": TRAIN_BATCH,
                     "epochs": 1},
           "run": {"registry_root": str(workdir / "runs"), "experiment": "GWEN"}}
    (workdir / "cfg.json").write_text(json.dumps(cfg))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = cli(["preprocess", "--config", str(workdir / "cfg.json")])
    log(f"  preprocess: {buf.getvalue().strip().splitlines()[-1]}, "
        f"{time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise AssertionError(f"preprocess returned {rc}")
    cfg_path = str(workdir / "cfg.json")
    launched(workdir, {
        "GWEN": ["train-gnn", "--no-animate", "--device", "cuda", "--config",
                 cfg_path],
        "GWEN_CNN": ["train-cnn", "--no-animate", "--device", "cuda", "--config",
                     cfg_path, f"train.batch_size={DEFAULT_BATCH}"]})
    params, mcfg = Registry(workdir / "launched").get_runs("GWEN")[0].load_model()
    feats = height * ncells
    if mcfg != {"hidden_feats": hidden, "channels": feats} or \
            params["gcn_0.w"].shape != (feats, hidden):
        raise AssertionError(f"train-gnn saved {mcfg}, gcn_0.w "
                             f"{tuple(params['gcn_0.w'].shape)}")

    # Ten train steps at the run's shapes, each timed.
    s, r = erdos_renyi_edges(members, 1.0, seed=42)
    graph = to_dense(build_graph(s, r, members)).to(device)
    model = GCNStack(feats, feats, device=device, hidden_feats=hidden,
                     generator=torch.Generator().manual_seed(0))
    mask = torch.zeros(members, dtype=torch.bool, device=device)
    mask[split:] = True
    batch = {"x": torch.randn(TRAIN_BATCH, members, feats, device=device),
             "mask": mask}
    loss_fn = gnn_loss_fn(model, graph)
    log(f"  GCNStack widths {model.widths}, {count_params(model) / 1e6:.1f} M "
        "parameters")
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    def step():
        loss, _ = loss_fn(batch)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)

    _step_spread(step, f"batch-{TRAIN_BATCH} member-graph GCNStack (125 members "
                 f"x {feats} features, hidden {hidden}, float32)")


def launched(workdir: Path, runs: dict) -> dict:
    """Start each run of ``runs`` (its registry experiment → the argv of
    ``python -m gwen_tpu_torch``) under ``python -m torch.distributed.run
    --standalone --nproc_per_node 1`` (one rank on this card: no process
    group, no collective), all at once, in ``workdir`` with this checkout on
    the path and ``run.registry_root`` at ``workdir / "launched"``, and
    wait for them (at most 600 s; killed at the limit). Logs each one's
    wall seconds, JSON line and the run rank 0 wrote to the registry;
    returns the JSON lines by experiment. Fails unless each run finished
    on the card as one rank with its run in the registry."""
    from gwen_tpu_torch.registry import Registry

    torch.cuda.empty_cache()  # the children allocate on the same card
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent), *filter(None, [env.get("PYTHONPATH")])])
    root = workdir / "launched"
    procs = {}
    try:
        for experiment, argv in runs.items():
            with open(workdir / f"{experiment}.out", "w") as out, \
                    open(workdir / f"{experiment}.err", "w") as err:
                procs[experiment] = subprocess.Popen(
                    [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", "1", "-m", "gwen_tpu_torch", *argv,
                     f"run.registry_root={root}"],
                    cwd=workdir, env=env, stdout=out, stderr=err)
        t0, wall = time.perf_counter(), {}
        while len(wall) < len(procs):
            if time.perf_counter() - t0 > 600:
                raise AssertionError(f"launched runs not done in 600 s: {list(procs)}")
            for experiment, proc in procs.items():
                if experiment not in wall and proc.poll() is not None:
                    wall[experiment] = time.perf_counter() - t0
            time.sleep(0.2)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = {}
    for experiment, argv in runs.items():
        if procs[experiment].returncode != 0:
            raise AssertionError(
                f"{argv[0]} under torch.distributed.run returned "
                f"{procs[experiment].returncode}:\n"
                f"{(workdir / f'{experiment}.err').read_text()[-3000:]}")
        out = json.loads((workdir / f"{experiment}.out").read_text()
                         .strip().splitlines()[-1])
        registered = Registry(root).get_runs(experiment)
        run = next((r for r in registered if r.run_id == out["run_id"]), None)
        log(f"  {argv[0]} under `torch.distributed.run --nproc_per_node 1` "
            f"({len(runs)} launched together): {wall[experiment]:.1f} s wall, "
            f"{out}; rank 0's registry run {out['run_id']}: "
            f"{None if run is None else run.meta.get('status')}, best metric "
            f"{None if run is None else run.meta.get('best_metric')}")
        if (run is None or run.meta.get("status") != "FINISHED" or out["world"] != 1
                or not out["device"].startswith("cuda")
                or not math.isfinite(out["best_train_loss"])
                or not math.isfinite(out["test_loss"])):
            raise AssertionError(f"{argv[0]} launched: {out}, runs "
                                 f"{[r.run_id for r in registered]}")
        outs[experiment] = out
    return outs


def _step_spread(step, tag: str, steps: int = 10) -> None:
    """``steps`` calls of ``step()`` after a warm-up, each timed by CUDA
    events, by the host to its barrier (``StepTimer``) and by the host to
    the return of ``step()`` (its enqueue), once with Python's garbage
    collector on and once with it off: the median, the spread and each
    step; the peak memory and the card's clock and power before and after;
    then one step under ``torch.profiler`` (busy share and kernels)."""
    import gc

    smi = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
           "--format=csv,noheader"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    before = subprocess.run(smi, capture_output=True, text=True, timeout=60).stdout
    for collector in ("on", "off"):
        timer, device, enqueue = StepTimer(window=steps), [], []
        if collector == "off":
            gc.disable()
        try:
            for _ in range(steps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with timer:
                    t0 = time.perf_counter()
                    start.record()
                    step()
                    end.record()
                    enqueue.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                device.append(start.elapsed_time(end))
        finally:
            gc.enable()
        host = [d * 1e3 for d in timer.durations]
        log(f"  {tag} train step, {steps} steps, garbage collector {collector}: "
            f"median {np.median(device):.3f} ms (CUDA events), spread "
            f"{min(device):.3f} to {max(device):.3f} ms, each "
            f"{[round(v, 3) for v in device]}; host to the barrier (StepTimer) "
            f"median {np.median(host):.3f} ms, spread {min(host):.3f} to "
            f"{max(host):.3f} ms; host enqueue median {np.median(enqueue):.3f} "
            f"ms, spread {min(enqueue):.3f} to {max(enqueue):.3f} ms")
    after = subprocess.run(smi, capture_output=True, text=True, timeout=60).stdout
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"clocks.sm, power.draw, temperature before {before.strip()}, after "
        f"{after.strip()}")
    _profile_step(step, tag)


def cnn_pipeline(device, workdir: Path) -> None:
    """Phase 11, last part: ``train-cnn --no-animate`` on the stores that
    :func:`member_graph_pipeline` preprocessed (125 members x height 32 x
    ncells 512, ``member_split`` 124: 124 input channels, 1 output) with
    the UNet at its default width (hidden 64, depth 4: widths 64 to 512,
    ~4.8 M parameters), the default batch of 21, 1 epoch. First through the
    entry point in this process, from torch's default TF32 flags
    (``cudnn.allow_tf32`` on, ``cuda.matmul.allow_tf32`` off), which
    ``train-cnn`` must clear for its float32 model and restore: a finite
    test loss, the flags as they were after it, the run in the registry,
    reloaded through ``load_best_model(..., params_template=...)``, and the
    run's own first test forward on the card against the CPU forward of the
    saved parameters on the same sample (float32, ``CNN_TOL``); for the
    record, that forward again with TF32 on and its error. Then the time
    and peak memory of one train step at batch 21 (TF32 off, as
    this script sets it) and its profile. The convs are cuDNN's
    (``F.conv2d``): the path runs no hand-written kernel, as the
    reference's runs no Pallas one."""
    import contextlib
    import io

    from gwen_tpu_torch.cli.main import main as cli
    from gwen_tpu_torch.config import load_config
    from gwen_tpu_torch.data.dataset import load_split
    from gwen_tpu_torch.nn.core import count_params
    from gwen_tpu_torch.nn.unet import UNet
    from gwen_tpu_torch.registry import Registry
    from gwen_tpu_torch.train import cnn_loss_fn

    cfg = load_config(str(workdir / "cfg.json"))
    test, _ = load_split(cfg.data, "test")  # (time, member, height, ncells)
    _, members, height, ncells = test.shape
    split = cfg.train.member_split

    # The run's first test forward (eval mode), as it ran on the card.
    seen = []

    def keep_first_eval_forward(module, args, output):
        if isinstance(module, UNet) and not module.training and not seen:
            seen.append((args[0].detach().cpu(), output.detach().cpu()))

    torch.backends.cudnn.allow_tf32 = True  # torch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    hook = torch.nn.modules.module.register_module_forward_hook(
        keep_first_eval_forward)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = cli(["train-cnn", "--no-animate", "--device", str(device),
                      "--config", str(workdir / "cfg.json"),
                      f"train.batch_size={DEFAULT_BATCH}"])
        torch.cuda.synchronize()
    finally:
        hook.remove()
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"  train-cnn (in this process, from torch's default TF32 flags): {out}, "
        f"{time.perf_counter() - t0:.1f} s; flags after it: cudnn.allow_tf32 "
        f"{flags[0]}, cuda.matmul.allow_tf32 {flags[1]}")
    if (rc != 0 or not math.isfinite(out["test_loss"])
            or not math.isfinite(out["best_train_loss"])
            or not out["device"].startswith(torch.device(device).type)):
        raise AssertionError(f"train-cnn returned {rc}: {out}")
    if flags != (True, False):
        raise AssertionError(f"train-cnn left the TF32 flags at {flags}")
    cpu_model = UNet(split, members - split, device="cpu")
    params, mcfg = Registry(workdir / "runs").load_best_model(
        "GWEN_CNN", params_template=cpu_model.state_dict())
    want = {"hidden": 64, "depth": 4, "channels_in": split,
            "channels_out": members - split}
    if mcfg != want:
        raise AssertionError(f"train-cnn saved {mcfg}, want {want}")
    cpu_model.load_state_dict(params)
    model = UNet(split, members - split, device=device)
    model.load_state_dict(params)
    log(f"  UNet widths {model.widths}, {count_params(model) / 1e6:.2f} M "
        "parameters, reloaded through its template")

    # The run's forward on the card against the CPU forward of its saved
    # parameters on the same test sample; then, for the record, TF32.
    if not seen or seen[0][0].shape != (1, split, height, ncells):
        raise AssertionError("train-cnn ran no test forward of one sample")
    x, got = seen[0]
    with torch.no_grad():
        plain = cpu_model(x)
        compare("train-cnn's own UNet forward on the card (from torch's default "
                "TF32 flags) vs on the CPU (float32)", got, plain, CNN_TOL)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = model(x.to(device)).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = False
    err = (tf32 - plain).abs().max().item()
    ref = plain.abs().max().item()
    log(f"  for the record, the same forward with cuDNN's TF32 on: max|err| "
        f"{err:.4g} of max|CPU| {ref:.4g} ({err / ref:.3g} relative; not held)")

    batch = (torch.randn(DEFAULT_BATCH, split, height, ncells, device=device),
             torch.randn(DEFAULT_BATCH, members - split, height, ncells,
                         device=device))
    loss_fn = cnn_loss_fn(model)
    log(f"  {smi_line()}")
    _task_step(model, lambda b, _: loss_fn(b), None, batch,
               f"batch-{DEFAULT_BATCH} UNet ({split} -> {members - split} "
               f"channels, {height} x {ncells}, hidden 64, depth 4, float32, "
               "TF32 off)", profile=True)


# The reference's extras keys (``bench.py``'s ``extra`` on the diag layouts):
# the port's ``# train-step:`` line carries the same set.
BENCH_EXTRA_KEYS = {"metric", "level", "nodes", "edges", "latent",
                    "process_steps", "kernel", "value", "unit",
                    "train_edges_per_s", "agg_ms", "agg_edges_per_s",
                    "vs_segment_baseline", "backend", "ts", "attn_agg_ms",
                    "attn_agg_edges_per_s"}
BENCH_HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline"]


def bench_run() -> int:
    """Phase 12, first part: ``gwen_tpu_torch bench`` at its defaults (L7, F
    256, ``diag_packed``, bf16; every ``GWEN_BENCH_*`` knob unset for the
    run) through the CLI in this process, its output captured, with every
    count from 0 just before it. Fails unless it returns 0 with exactly one
    stdout line, the reference's headline keys and metric with ``value``
    and ``vs_baseline`` finite and positive, a ``# train-step:`` line with
    the reference's extras keys and finite values on ``cuda``, the
    checkout's ``BENCH_EXTRA.json`` (the reference's file) byte for byte as
    before, no plain version on the card, and the launch counts its calls
    imply: each ``scan_timeit`` chain of N makes 3N warm-up and 3·3N timed
    calls, so 12·ITERS aggregations plus ``device_ms``'s ITERS + 5, and
    12·max(ITERS // 4, 5) train steps of 8 aggregations (4 forward, 4
    backward) and 4 ``h + LN(m)`` each way; packed B1 and B3 (the escape
    contraction) once an aggregation, B5 once an attention call (12·ITERS),
    nothing else. Logs the bench's lines and wall seconds; returns B5's
    count."""
    import contextlib
    import io

    import gwen_tpu_torch.bench as gb
    from gwen_tpu_torch.cli.main import main as cli

    reference_file = Path(__file__).resolve().parent / "BENCH_EXTRA.json"
    before = reference_file.read_bytes() if reference_file.exists() else None
    knobs = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("GWEN_BENCH_")}
    out, err = io.StringIO(), io.StringIO()
    counters = _counters()
    try:
        iters = gb.knobs()["iters"]
        torch.cuda.empty_cache()
        for c in counters.values():
            c.launches = 0
        PLAIN_ON_CUDA["calls"] = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(["bench"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.update(knobs)
    launches = {k: c.launches for k, c in counters.items()}
    stdout, stderr = out.getvalue(), err.getvalue()
    for line in stdout.splitlines() + stderr.splitlines():
        if line.startswith(("{", "#")):
            log(f"  bench: {line}")
    log(f"  `gwen_tpu_torch bench` returned {rc} after {wall:.1f} s")
    if rc:
        raise AssertionError(f"bench returned {rc}:\n{stderr[-3000:]}")

    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} stdout lines, want 1")
    head = json.loads(lines[0])
    if (list(head) != BENCH_HEADLINE_KEYS
            or head["metric"] != "spmm_edges_per_sec_per_chip"
            or head["unit"] != "edges/s"):
        raise AssertionError(f"bench headline {head} is not the reference's")
    for key in ("value", "vs_baseline"):
        v = head[key]
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            raise AssertionError(f"bench {key} = {v!r}, want finite and positive")
    train = [ln for ln in stderr.splitlines() if ln.startswith("# train-step: ")]
    if len(train) != 1:
        raise AssertionError("bench printed no `# train-step:` line")
    extra = json.loads(train[0][len("# train-step: "):])
    if set(extra) != BENCH_EXTRA_KEYS:
        raise AssertionError(f"bench extras keys {sorted(extra)} are not the "
                             "reference's")
    bad = [k for k, v in extra.items() if isinstance(v, float) and not math.isfinite(v)]
    if bad or extra["backend"] != "cuda":
        raise AssertionError(f"bench extras not finite ({bad}) or not on cuda")
    after = reference_file.read_bytes() if reference_file.exists() else None
    if after != before:
        raise AssertionError("bench changed the reference's BENCH_EXTRA.json")
    log("  the reference's BENCH_EXTRA.json is byte for byte as before")

    aggs, steps = 12 * iters + iters + 5, 12 * max(iters // 4, 5)
    want = {"B1p": aggs + 8 * steps, "B3": aggs + 8 * steps, "B2": 4 * steps,
            "B2b": 4 * steps, "B5": 12 * iters}
    got = {k: v for k, v in launches.items() if v}
    log(f"  bench launches {got} (want {want}), plain versions on the card "
        f"{PLAIN_ON_CUDA['calls']}")
    if got != want or PLAIN_ON_CUDA["calls"]:
        raise AssertionError(f"bench launches {got}, want {want}; "
                             f"{PLAIN_ON_CUDA['calls']} plain calls on the card")
    torch.cuda.empty_cache()
    return launches["B5"]


def bench_graphs(device) -> tuple:
    """The bench's default graph, as ``bench.main`` builds it: L7 in KD
    order, the packed diag window 384 in bf16, on ``device``, with its
    attention transpose tables. Returns ``(graph, tables, nodes)``."""
    import gwen_tpu_torch.bench as gb

    t0 = time.perf_counter()
    g_host, n = gb._build(LEVELS, "kd")
    graph_host, _ = gb.aggregation_graph(g_host, "diag_packed", torch.bfloat16,
                                         WINDOW)
    out = (graph_host.to(device), gb.diag_transpose_tables(graph_host).to(device), n)
    log(f"  the bench's L{LEVELS} packed diag graph and its attention tables "
        f"built in {time.perf_counter() - t0:.1f} s")
    return out


def bench_attention(tg, n: int, device) -> dict:
    """Phase 12: B5 at the bench's attention shape, f 256 on the bench's
    packed L7 diag graph (KD order, window 384) with its transpose tables
    ``tg``. Held with independent q, k and v, N(0, 1) rounded to bf16, at
    the bench's scale f^-1/2: each score is then about N(0, 1), so the
    softmax spreads over the window and no one row (the self edge where q
    is k) decides the output. Against its plain version (bf16 at
    ``BF16_TOL``, float32 at ``F32_TOL``) and
    ``scaled_dot_product_attention`` on the dense mask; fails too where
    the plain output lies within ``BF16_TOL`` of v itself, where the check
    could not tell a kernel that attends to the self row alone. Then the
    bench's own call (x as q, k and v) is run, timed beside its plain
    version and held to its bound; the library's time is taken on the
    independent inputs (a dense call, the same work whatever the values).
    Returns the B5 f-256 row of the kernels line."""
    from gwen_tpu_torch.ops import attention_cuda as ac

    f = 256
    scale = f ** -0.5
    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn(n, f, generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    q32, k32, v32 = q.float(), k.float(), v.float()
    want_out = ac.attention_fwd_plain(tg, q32, k32, v32, scale)
    self_only = (want_out - v32).abs().max().item()
    log(f"  B5 f 256 check inputs: max|plain − v| {self_only:.4g} against "
        f"max|plain| {want_out.abs().max().item():.4g}")
    if self_only <= BF16_TOL * want_out.abs().max().item():
        raise AssertionError("B5 f 256: the plain output is v within the "
                             "tolerance; the check cannot see the neighbours")
    err = compare("B5 bf16 f 256 (independent q, k and v)",
                  ac.attention_fwd(tg, q, k, v, scale), want_out, BF16_TOL)
    compare("B5 f32 f 256 (independent q, k and v)",
            ac.attention_fwd(tg, q32, k32, v32, scale), want_out, F32_TOL)
    del want_out, q32, k32, v32
    library_ms = sdpa_forward_ms(tg, q, k, v, ac.attention_fwd(tg, q, k, v, scale),
                                 scale)
    del q, k, v

    # The bench's own call: x as q, k and v (the self edge's score, |x|²/16,
    # outweighs the rest, so this shows the call runs, not that it is right).
    x = torch.randn(n, f, generator=torch.Generator(device=device).manual_seed(0),
                    device=device).to(torch.bfloat16)

    def kern():
        return ac.attention_fwd(tg, x, x, x, scale)

    x32 = x.float()
    compare("B5 bf16 f 256 (the bench's call, x as q, k and v)", kern(),
            ac.attention_fwd_plain(tg, x32, x32, x32, scale), BF16_TOL)
    del x32
    ms, plain_ms = timed_pair(kern, lambda: ac.attention_fwd_plain(
        tg, x, x, x, scale))
    # Bytes: x once (q, k and v are the one input), the neighbour lists, the
    # output; 4 operations per mask entry and column (scores, P·V).
    nnz = int((tg.attn_nbr >= 0).sum())
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **roofline((x, tg.attn_nbr), (x,), 4.0 * f * nnz, torch.bfloat16),
               library_ms=library_ms)
    log(f"  B5 f 256: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"scaled_dot_product_attention "
        f"{'not run' if library_ms is None else f'{library_ms:.3f} ms'}")
    del x
    torch.cuda.empty_cache()
    return row


def bench_profile(graph, tg, n: int, device) -> None:
    """Phase 12: one aggregation call, one EPD train step and one attention
    aggregation of the bench's own functions, each under ``torch.profiler``.
    Fails unless the aggregation ran ``packed_row1_kernel``, the train step
    ``packed_row1_kernel``, ``ln_fwd`` and ``ln_bwd``, and the attention
    ``attn_fwd_kernel``, each in one of ``PROFILE_TRIES`` windows: on the
    H100 machine a window now and then comes back short of its device
    events, even in a fresh process (one attention window of one call: 0
    events), and a wrapper that ran no kernel shows it in none.
    Logs the attention's device time."""
    import gwen_tpu_torch.bench as gb
    from gwen_tpu_torch.profiling import device_events

    x = torch.randn(n, 256, device=device).bfloat16()
    xb, y = gb.timed_input(graph, x), x * 0.9
    state = gb.epd_state(256, device)
    calls = {"aggregation": (lambda: gb.spmm_diag_window(graph, xb),
                             ("packed_row1_kernel",)),
             "train step": (lambda: gb.train_step(state, graph, x, y),
                            ("packed_row1_kernel", "ln_fwd", "ln_bwd")),
             "attention": (lambda: gb.attention_aggregation(tg, x),
                           ("attn_fwd_kernel",))}
    for what, (fn, kernels) in calls.items():
        for attempt in range(1, PROFILE_TRIES + 1):
            with torch.set_grad_enabled(what == "train step"):
                fn()
                names = [ev.name for ev in device_events(fn)]
            log(f"  bench {what}, one call under torch.profiler (window "
                f"{attempt}): {len(names)} device events, kernels "
                f"{sorted({nm[:50] for nm in names})[:12]}")
            missing = [k for k in kernels if not any(k in nm for nm in names)]
            if not missing:
                break
        else:
            raise AssertionError(f"bench {what}: no {missing} among its device "
                                 f"kernels in {PROFILE_TRIES} windows")
    with torch.no_grad():
        ms = device_ms(calls["attention"][0], 20)
    log(f"  bench attention (B5 at f 256): {ms:.4f} ms of device time a call "
        "(device_ms, 20 calls)")
    del state
    torch.cuda.empty_cache()


PROFILE_TRIES = 3
BENCH_PHASE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
device = torch.device("cuda", 0)
cs.count_plain_calls_on_cuda()
graph, tg, n = cs.bench_graphs(device)
cs.bench_profile(graph, tg, n, device)
del graph
launches = cs.bench_run()
row = cs.bench_attention(tg, n, device)
print(json.dumps({"launches": launches, "row": row}))
"""


def bench_phase() -> tuple[int, dict]:
    """Phase 12 in a fresh child process: on the bench's graph
    (:func:`bench_graphs`) :func:`bench_profile`, then :func:`bench_run`
    and :func:`bench_attention`. Not in this process: here, after eleven
    phases, ``torch.profiler`` windows of the bench's calls came back
    empty or short, and the bench reads one (``device_ms`` on its ``#
    mesh`` line). Relays the child's log lines; fails where it fails.
    Returns B5's launches in the bench's run and the B5 f-256 row."""
    torch.cuda.empty_cache()  # the child allocates on the same card
    res = subprocess.run([sys.executable, "-c", BENCH_PHASE,
                          str(Path(__file__).resolve().parent)],
                         timeout=900, capture_output=True, text=True)
    lines = res.stdout.splitlines()
    for line in lines[:-1] if res.returncode == 0 else lines:
        log(line)
    if res.returncode != 0:
        raise AssertionError(f"phase 12's child failed:\n{res.stderr[-3000:]}")
    out = json.loads(lines[-1])
    return out["launches"], out["row"]


def sdpa_forward_ms(graph, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kernel_out: torch.Tensor, scale: float) -> "float | None":
    """``scaled_dot_product_attention`` (cuDNN) on the graph's dense window
    mask (:func:`dense_window_bias`): held to the kernel's output on the
    same q, k and v at two bf16 bounds, then timed. None, with the reason
    logged, where the library refuses the shape."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    n, f = q.shape
    torch.cuda.empty_cache()
    bias = dense_window_bias(graph)
    mask = bias[:, :n]
    q4, k4, v4 = (t.reshape(1, 1, n, f) for t in (q, k, v))

    def fwd():
        with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  scale=scale)

    try:
        with torch.no_grad():
            lib = fwd()
            compare("B5 f 256 against scaled_dot_product_attention on a dense "
                    "mask", kernel_out, lib.reshape(kernel_out.shape),
                    2 * BF16_TOL)
            out = cuda_ms(fwd, 2, 1)
    except RuntimeError as e:
        log(f"  scaled_dot_product_attention (cuDNN) refused f {f}: "
            f"{str(e).splitlines()[0][:200]}")
        out = None
    del bias, mask
    torch.cuda.empty_cache()
    return out


NCCL_PROBE = r"""
import datetime, os, tempfile, torch, torch.distributed as dist
store = os.path.join(tempfile.mkdtemp(), "store")
dist.init_process_group("nccl", init_method=f"file://{store}", world_size=1,
                        rank=0, timeout=datetime.timedelta(seconds=60))
t = torch.ones(4, device="cuda")
dist.all_reduce(t)
parts = [torch.empty_like(t)]
dist.all_gather(parts, t)
dist.all_reduce(t, group=dist.new_group([0]))
torch.cuda.synchronize()
assert t.tolist() == parts[0].tolist() == [1.0] * 4
print("nccl", ".".join(map(str, torch.cuda.nccl.version())))
dist.destroy_process_group()
"""


# The rows of every product with a weight in the benchmark's cells: the
# L7 mesh's 163,842 nodes times 2, 4, 8 and 16 members and 21 samples.
LINEAR_ROWS = (327_684, 655_368, 1_310_736, 2_621_472, 3_440_682)
LINEAR_SHAPES = ((1, 256), (256, 256), (256, 1))  # (K, N)


def is_gemm(name: str) -> bool:
    return any(tag in name for tag in ("nvjet", "gemm", "gemv", "cutlass"))


def old_linear(x, w, b, relu=False):
    """The expression :func:`nn.core.linear` replaced."""
    y = x @ w.to(x.dtype) + b.to(x.dtype)
    return torch.relu(y) if relu else y


def check_linear(device) -> None:
    """``nn.core.linear`` at the cells' shapes (``LINEAR_ROWS`` × the
    encoder's K = 1, the latent products, the decoder's N = 1; with and
    without the ReLU where N > 1), bf16 operands and float32 parameters:
    within one bf16 ulp at max|old| of the expression it replaced (one
    rounding against two), its route counts, the device kernels of three
    calls under ``torch.profiler``, and its time beside the old
    expression's (CUDA events, in turns). With N > 1 each call runs one
    GEMM with the bias (or ReLU-bias) epilogue and nothing else but a
    memset, the casts of ``w`` and ``b`` to bf16 and, for K = 1, the zero
    padding's fills and copies: no ``elementwise_kernel<128, 4>`` and no
    other pass over the output. Then,
    at the first row count, its gradients against autograd through the old
    expression (``BF16_TOL``), the ReLU's mask taken from the helper's
    output (the two roundings can differ in sign next to zero). First, the
    allocator's growth over the process's first product and first
    bias-epilogue product; last, the routes of one GCN and one attention
    forward on the L7 graph: every product with a bias and more than one
    output column in the epilogue, ``plain`` only for the decoder's N = 1."""
    from gwen_tpu_torch.nn import core
    from gwen_tpu_torch.profiling import device_events

    gen = torch.Generator(device=device).manual_seed(21)
    a, wb, bb = (torch.randn(*shape, device=device, generator=gen).bfloat16()
                 for shape in ((1024, 256), (256, 256), (256,)))
    held = [torch.cuda.memory_allocated()]
    for product in (lambda: a @ wb, lambda: torch.addmm(bb, a, wb)):
        product()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    log(f"  the allocator holds {(held[1] - held[0]) / 2**20:.2f} MiB more after this "
        f"process's first product and {(held[2] - held[1]) / 2**20:.2f} MiB more after "
        "its first bias-epilogue product (the libraries' workspaces)")
    pad = ("Memset", "Memcpy", "FillFunctor", "CatArrayBatchedCopy")
    for k, n in LINEAR_SHAPES:
        w = torch.randn(k, n, device=device, generator=gen) * k ** -0.5
        b = torch.randn(n, device=device, generator=gen) * 0.1
        for relu in (False, True) if n > 1 else (False,):
            for m in LINEAR_ROWS:
                x = torch.randn(m, k, device=device, generator=gen).bfloat16()
                tag = f"linear K {k} N {n} M {m}{' relu' if relu else ''}"

                def new(x=x, relu=relu):
                    return core.linear(x, w, b, relu=relu)

                before = dict(core.linear.routes)
                compare(tag, new(), old_linear(x, w, b, relu), 0.0, ulps=1)
                routes = {r: c - before[r] for r, c in core.linear.routes.items()
                          if c != before[r]}
                names = [ev.name for ev in device_events(new, 3)]
                ms, old_ms = timed_pair(new, lambda x=x, relu=relu: old_linear(x, w, b, relu))
                log(f"  {tag}: {ms:.4f} ms, old expression {old_ms:.4f} ms, "
                    f"routes {routes}, 3 calls ran {[nm[:48] for nm in names]}")
                if n == 1:
                    continue
                gemms = [nm for nm in names if is_gemm(nm)]
                rest = [nm for nm in names if not is_gemm(nm) and not (
                    nm.startswith("Memset") or "bfloat16_copy_kernel" in nm
                    or k == 1 and any(p in nm for p in pad))]
                if (routes != {"outer" if k == 1 else "epilogue": 1} or len(gemms) != 3
                        or not all("bias" in nm for nm in gemms) or rest):
                    raise AssertionError(f"{tag}: routes {routes}, kernels {names}")
        relu = n > 1
        x = torch.randn(LINEAR_ROWS[0], k, device=device, generator=gen).bfloat16()
        cot = torch.randn(LINEAR_ROWS[0], n, device=device, generator=gen).bfloat16()
        grads = []
        for fn in (core.linear, old_linear):
            leaves = [x.clone().requires_grad_(k > 1), w.clone().requires_grad_(),
                      b.clone().requires_grad_()]
            if fn is core.linear:
                y = fn(*leaves, relu=relu)
                y.backward(cot)
            else:  # the ReLU's mask from the helper's output: one rounding
                fn(*leaves).backward(cot * (y > 0) if relu else cot)
            grads.append([t.grad for t in leaves if t.requires_grad])
        for name, mine, theirs in zip(("dx", "dw", "db")[k == 1:], *grads):
            compare(f"linear K {k} N {n} M {LINEAR_ROWS[0]}{' relu' if relu else ''} "
                    f"{name} vs autograd through the old expression", mine, theirs,
                    BF16_TOL)
        del x, cot, grads, y
        torch.cuda.empty_cache()
    graph = build_serving_graph(device, torch.bfloat16)[0]
    for processor, members, epilogue in (("gcn", 4, 2), ("attention", 2, 2 + 4 * PROCESS_STEPS)):
        x = torch.randn(members, graph.num_nodes, CHANNELS, device=device, generator=gen)
        model = _serving_model(device, processor)
        before = dict(core.linear.routes)
        with torch.no_grad():
            model(graph, x)
        routes = {r: c - before[r] for r, c in core.linear.routes.items()}
        log(f"  one {processor} forward at {members} members: linear routes {routes}")
        if routes != {"epilogue": epilogue, "outer": 1, "plain": 1}:
            raise AssertionError(f"{processor} forward: routes {routes}, want "
                                 f"{epilogue} epilogue, 1 outer, 1 plain (the decoder's N = 1)")


LINEAR_CHECK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
cs.check_linear(torch.device("cuda", 0))
"""


def linear_phase() -> None:
    """:func:`check_linear` in a fresh child process (its profiler windows
    are read there; see :func:`one_kernel_per_call`), its lines relayed."""
    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, "-c", LINEAR_CHECK,
                          str(Path(__file__).resolve().parent)],
                         timeout=600, capture_output=True, text=True)
    for line in res.stdout.splitlines():
        log(line)
    if res.returncode != 0:
        raise AssertionError(f"the linear check failed:\n{res.stderr[-2000:]}")


# GraphCast's latent width and the published model's sizes: the segment
# sums' shapes, and one training step of the model (every block recomputed)
# whose sums are counted.
GC_LATENT, GC_CHANNELS, GC_STEPS = 512, (474, 227), 16
GC_LAUNCHES = 4 * (GC_STEPS + 2)  # sums forward, recomputed, two a backward


def check_segment_sum(device) -> dict:
    """The segment sum of ``ops/edges.py`` (``csrc/edge_sum.cu``) on the
    0.25° GraphCast graphs, bf16 at L 512: for each block (grid2mesh, the
    multimesh, mesh2grid) its receiver side (the receiver-sorted spans, as
    ``edge_sum`` and the join's backward run it) and its sender side
    (through ``sender_order``), each on the slice of an ``E × 3L`` join as
    the backward reads it, against the plain version within one bf16 ulp at
    max|plain|: both sum in float32 and round once, but in other orders
    (the kernel in edge order, a long row in pieces added in order;
    ``index_add_`` on the card by atomics), so a float32 sum can differ in
    its last bits and its rounding fall the other way. The slice and a
    contiguous copy give the same bits, and so do two calls. Each is timed
    beside its byte bound (the edge rows and their indices read once, the
    output written once), the plain version and the path it replaced
    (a float32 copy, ``index_add_`` into a zeroed float32 buffer, a cast:
    ``library_ms``). Then batch 2, float32, rows that are not 16-byte
    aligned (the one-element form) and empty segments, and last one
    ``Trainer.train_step`` of the published model with every block
    recomputed: ``GC_LAUNCHES`` launches, no plain version on the card and
    no ``index_add_`` kernel (``indexFuncLargeIndex``) among its device
    kernels. Returns the kernel table's entry, at mesh2grid's sender side
    (its largest sum)."""
    from gwen_tpu_torch.graph.graphcast import BipartiteGraph, build_graphcast_graphs
    from gwen_tpu_torch.ops import edges

    t0 = time.perf_counter()
    graphs = build_graphcast_graphs().to(device)
    log(f"  0.25 deg graphs built and moved in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(23)
    out = {}
    for name in ("grid2mesh", "mesh", "mesh2grid"):
        g = getattr(graphs, name)
        joined = torch.randn(g.num_edges, 3 * GC_LATENT, device=device,
                             generator=gen).bfloat16()
        for side, offsets, order, index, src in (
                ("receivers", g.receiver_offsets, None, g.receivers,
                 joined[:, 2 * GC_LATENT:]),
                ("senders", g.sender_offsets, g.sender_order, g.senders,
                 joined[:, GC_LATENT:2 * GC_LATENT])):
            out = _segment_side(f"segment sum {name} {side}", src, offsets, order, index)
        del joined, src
    torch.cuda.empty_cache()
    g = graphs.mesh
    for tag, src in (
            ("batch 2, strided", torch.randn(
                2, g.num_edges, 3 * GC_LATENT, device=device,
                generator=gen).bfloat16()[..., GC_LATENT:2 * GC_LATENT]),
            ("float32", torch.randn(g.num_edges, GC_LATENT, device=device, generator=gen)),
            ("36 wide, not 16-byte aligned", torch.randn(
                g.num_edges, 37, device=device, generator=gen).bfloat16()[:, 1:])):
        for side, offsets, order in (("receivers", g.receiver_offsets, None),
                                     ("senders", g.sender_offsets, g.sender_order)):
            got = edges.segment_sum(src, offsets, order)
            compare(f"segment sum mesh {side} {tag}", got,
                    edges.segment_sum_plain(src, offsets, order), F32_TOL,
                    ulps=0 if src.dtype == torch.float32 else 1)
    empty = BipartiteGraph.from_edges(np.array([0, 2, 2, 1]), np.array([1, 1, 3, 3]), 3, 5,
                                      np.zeros((4, 4), np.float32)).to(device)
    src = torch.randn(4, GC_LATENT, device=device, generator=gen).bfloat16()
    for offsets, order in ((empty.receiver_offsets, None),
                           (empty.sender_offsets, empty.sender_order)):
        got = edges.segment_sum(src, offsets, order)
        if not torch.equal(got, edges.segment_sum_plain(src, offsets, order)):
            raise AssertionError("segment sum with empty segments: other values")
    log("  segment sum: batch 2, float32, the one-element form and empty segments agree")
    del src, got
    torch.cuda.empty_cache()
    graphcast_step_launches(graphs, device)
    return out


def _segment_side(tag: str, src: torch.Tensor, offsets: torch.Tensor, order, index
                  ) -> dict:
    """One side of a block for :func:`check_segment_sum`: checks and times."""
    from gwen_tpu_torch.ops import edges

    rows = offsets.shape[0] - 1
    seg = (offsets[1:] - offsets[:-1]).float()

    def kernel():
        return edges.segment_sum(src, offsets, order)

    def plain():
        return edges.segment_sum_plain(src, offsets, order)

    def library():
        buf = torch.zeros(rows, src.shape[-1], dtype=torch.float32, device=src.device)
        return buf.index_add_(0, index, src.float()).to(src.dtype)

    got = kernel()
    err = compare(tag, got, plain(), 0.0, ulps=1)
    compare(f"{tag} against the path it replaced", got, library(), 0.0, ulps=1)
    same_bits(tag, (got,), lambda: (kernel(),))
    if not torch.equal(edges.segment_sum(src.contiguous(), offsets, order), got):
        raise AssertionError(f"{tag}: the slice and its copy give other bits")
    ms, plain_ms = timed_pair(kernel, plain)
    library_ms = cuda_ms(library)
    tables = offsets.numel() * 4 + (0 if order is None else order.numel() * 4)
    bound = roofline([src, tables], [got], float(src.numel()), torch.bfloat16)
    log(f"  {tag}: rows {rows}, edges {src.shape[-2]}, a row's edges mean "
        f"{seg.mean().item():.2f} max {int(seg.max().item())}; {ms:.4f} ms, bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
        f"{100 * bound['bound_ms'] / ms:.1f} %), plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)


def graphcast_step_launches(graphs, device) -> None:
    """One ``Trainer.train_step`` of the published GraphCast (batch 1, bf16,
    every block recomputed, AdamW) after one warm-up step: its segment-sum
    launches, its plain-version calls on the card, its device kernels'
    names, its time and peak memory."""
    from gwen_tpu_torch.nn.graphcast import GraphCast
    from gwen_tpu_torch.ops import edges
    from gwen_tpu_torch.profiling import device_events
    from gwen_tpu_torch.train import Trainer, TrainState, graphcast_loss_fn, make_optimizer
    from gwen_tpu_torch.train.tasks import graphcast_channel_weights

    cin, cout = GC_CHANNELS
    model = GraphCast(cin, cout, device=device, latent_size=GC_LATENT,
                      process_steps=GC_STEPS, remat=True)
    opt = make_optimizer(model.parameters(), 1e-3, weight_decay=0.1, betas=(0.9, 0.95))
    weights = graphcast_channel_weights(list(range(1, 38)), 6, [1.0, 0.1, 0.1, 0.1, 0.1])
    trainer = Trainer(graphcast_loss_fn(model, *graphs.grid_shape, weights), device,
                      context=graphs)
    state = TrainState(model, opt)
    gen = torch.Generator(device=device).manual_seed(29)
    batch = (torch.randn(1, graphs.num_grid, cin, device=device, generator=gen),
             torch.randn(1, graphs.num_grid, cout, device=device, generator=gen))
    trainer.train_step(state, batch)
    plain_calls = []
    plain = edges.segment_sum_plain
    edges.segment_sum_plain = lambda *a, **k: plain_calls.append(1) or plain(*a, **k)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = edges.segment_sum.launches
        t0 = time.perf_counter()
        loss = float(trainer.train_step(state, batch))
        step_s = time.perf_counter() - t0
        launches = edges.segment_sum.launches - before
        names = {ev.name for ev in device_events(lambda: trainer.train_step(state, batch))}
    finally:
        edges.segment_sum_plain = plain
    sums = sorted(nm for nm in names if "segment_sum" in nm)
    log(f"  GraphCast train step (batch 1, every block recomputed): loss {loss:.5f}, "
        f"{step_s * 1e3:.1f} ms, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"segment-sum launches {launches} (want {GC_LAUNCHES}), plain versions on the "
        f"card {len(plain_calls)}, kernels {[nm[:60] for nm in sums]}")
    if (launches != GC_LAUNCHES or plain_calls or not sums or not math.isfinite(loss)
            or any("indexFuncLargeIndex" in nm for nm in names)):
        raise AssertionError("GraphCast train step: not every sum on the segment-sum "
                             "kernel, or an index_add_ left")


SEGMENT_CHECK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
print(json.dumps(cs.check_segment_sum(torch.device("cuda", 0))))
"""


def segment_phase() -> dict:
    """:func:`check_segment_sum` in a fresh child process (its profiler
    window is read there; see :func:`one_kernel_per_call`), its lines
    relayed; returns its kernel-table entry."""
    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, "-c", SEGMENT_CHECK,
                          str(Path(__file__).resolve().parent)],
                         timeout=900, capture_output=True, text=True)
    lines = res.stdout.splitlines()
    for line in lines[:-1]:
        log(line)
    if res.returncode != 0:
        raise AssertionError(f"the segment-sum check failed:\n{res.stderr[-2000:]}")
    return json.loads(lines[-1])


def nccl_one_rank_probe() -> None:
    """Whether this host's NCCL carries the collectives the partitioned
    path uses (``all_reduce`` for the gradients, ``all_gather`` for the
    escape rows, ``new_group``) on a 1-rank group over a file store. Logged
    only: with one card the port's one-rank path needs no process group,
    and two ranks cannot share a card. Runs in a child process with its own
    time limit, which is killed at it."""
    try:
        res = subprocess.run([sys.executable, "-c", NCCL_PROBE], timeout=120,
                             capture_output=True, text=True)
        said = (res.stdout.strip().splitlines() or ["no output"])[-1]
        log(f"  1-rank NCCL group (all_reduce, all_gather, new_group): "
            f"{'ok, ' + said if res.returncode == 0 else 'failed: ' + res.stderr[-300:]}")
    except subprocess.TimeoutExpired:
        log("  1-rank NCCL group: no answer in 120 s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from gwen_tpu_torch.ops import attention_cuda, edges, fused_ln, spmm_cuda, unfused_cuda

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
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        nvcc_jobs = [pool.submit(mod.build)
                     for mod in (spmm_cuda, attention_cuda, unfused_cuda, edges)]
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
    log("  the attention kernels (B5, B6, B7) on an L5 graph with lists over "
        "the register chunk and rows with no source, at window 384 and at "
        "window 2048 with a hub row listing its whole window:")
    for window in (WINDOW, 2048):
        check_wide_attention_graph(build_wide_attention_graph(device, window), device)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    packed = build_packed_graphs(device, perm)
    pg, sg = packed["diag_packed"], packed["packed"]
    log(f"  bit-packed L{LEVELS} graphs built in {time.perf_counter() - t0:.1f} s: "
        f"diag bits {tuple(pg.s_pack.shape)} int32 ({pg.s_pack.nbytes / 2**20:.2f} "
        f"MiB; bf16 S would be {pg.num_padded_nodes * pg.window_size * 2 / 2**20:.1f} "
        f"MiB), escape edges {pg.escape.num_edges}; RCM banded: block "
        f"{sg.block_size}, W {sg.window_size}, padded {sg.num_padded_nodes}, bits "
        f"{tuple(sg.s_pack.shape)} ({sg.s_pack.nbytes / 2**20:.2f} MiB)")
    log("  bit-packed layouts (packed B1, packed B4, B13):")
    results.update(check_packed_kernels(graph, packed, device, results))
    log("  the row gathers (B13, B11) on an L5 hub graph and an empty-block graph:")
    check_wide_window_graphs(build_wide_window_graphs(device), device)
    log("  the batched diag forms on the row gathers (B4, packed B4, B10) on an "
        "L5 hub graph with a block of > 32 escape rows and an empty block:")
    check_diag_gather_graphs(build_diag_gather_graphs(device), device)
    log("  unfused operators (B8, B9, B9b, diag_matvec) and aggregate on a "
        "float32 field:")
    results.update(check_unfused_kernels(graph, pg, device))
    log("  the int8 rank-1 form of B3 and B10 (B3r, B10r) on the RCM band:")
    t0 = time.perf_counter()
    rank1 = build_rank1_layout(device)
    log(f"  RCM-ordered L{LEVELS} int8 rank-1 layout built in "
        f"{time.perf_counter() - t0:.1f} s")
    results.update(check_rank1_kernels(rank1, device))
    del rank1
    torch.cuda.empty_cache()

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

    log(f"== phase 8: train through `train-mesh` on the bit-packed layouts "
        f"(batch {TRAIN_BATCH}), time")
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(train_packed(packed, device, Path(tmp)))

    log("== phase 9: the unfused attention backend; `train-mesh` on the "
        "ensemble tasks and the interaction processor")
    unfused = check_unfused_attention(graph, device)
    launches.update({k: unfused[k] for k in ("B8", "B9")})
    with tempfile.TemporaryDirectory() as tmp:
        ensemble_paths(graph, device, Path(tmp))

    log("== phase 10: the partitioned path on one rank: B11 and B12 against "
        "their plain versions, `train-mesh mesh.force_partition=true` on "
        "each partition layout")
    t0 = time.perf_counter()
    layouts = build_partition_layouts(device, perm)
    log(f"  RCM-ordered L{LEVELS} layouts built in {time.perf_counter() - t0:.1f} s")
    results.update(check_partition_kernels(layouts, device))
    del layouts
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(partitioned_paths(device, Path(tmp)))

    log("== phase 11: `aggregate` on the int8 rank-1 layout; B14 (block tiles) "
        "against its plain version; the EPD model on a BlockTileGraph and on the "
        "multimesh; `make-mesh-data` -> `train-mesh --data` -> `export`; "
        "`preprocess` -> `train-gnn` (under torch.distributed.run); `train-cnn` "
        "(from torch's TF32 defaults, and under torch.distributed.run)")
    t0 = time.perf_counter()
    layouts = build_tile_layouts(device, perm)
    log(f"  L{LEVELS} block-tile and rank-1 layouts built in "
        f"{time.perf_counter() - t0:.1f} s")
    launches["B3r"] = rank1_path(layouts, device)["B3r"]
    results.update(check_tile_kernels(layouts, device))
    tile_runs = tile_model_paths(layouts, device)
    launches["B14"] = tile_runs["served"]["B14"] + tile_runs["trained"]["B14"]
    del layouts
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        store_paths(device, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        member_graph_pipeline(device, Path(tmp))
        cnn_pipeline(device, Path(tmp))
    log("== phase 12: `python -m gwen_tpu_torch bench` at its defaults; the "
        "bench's aggregation, train step and attention on their kernels; B5 at "
        "f 256")
    t0 = time.perf_counter()
    launches["B5f256"], results["B5f256"] = bench_phase()
    log(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    log("== last: one device kernel per int8 rank-1 call and per B5, B6 and "
        "B7 call (child processes under torch.profiler); the 1-rank NCCL probe")
    one_kernel_per_call(RANK1_PROFILE, "spmm_sliding_rank1", {"(": "dense_row"})
    one_kernel_per_call(ATTN_PROFILE, "windowed attention",
                        {"B5": "attn_fwd_kernel", "B6": "attn_dq_kernel",
                         "B7": "attn_dkdv_kernel"})
    log("  nn.core.linear: the bias and ReLU in the product's epilogue at the "
        "cells' shapes (a child process):")
    linear_phase()
    log("  the segment sum of GraphCast's edge operators at the 0.25 deg shapes and "
        "one GraphCast train step (a child process):")
    results["SS"] = segment_phase()
    launches["SS"] = GC_LAUNCHES
    # Last: after this child process the profiler traces of this one lose
    # device events, and the checks above read them.
    nccl_one_rank_probe()

    spmm, ln = "gwen_tpu/ops/spmm_pallas.py", "gwen_tpu/ops/fused_ln.py"
    att = "gwen_tpu/ops/attention_pallas.py"
    cu, tr = "gwen_tpu_torch/csrc/window_spmm.cu", "gwen_tpu_torch/ops/fused_ln.py"
    acu = "gwen_tpu_torch/csrc/window_attention.cu"
    ucu = "gwen_tpu_torch/csrc/window_unfused.cu"
    one = "; one kernel for both forms, one count"
    sources = {"B1": ("diag-window SpMM with escape placement: the row "
                      "gather's batch-1 walk over S's nonzeros (listed, then "
                      "gathered eight at a time) with the escape rows added in "
                      "its epilogue (dense_row1_kernel)", "cuda", cu,
                      f"{spmm}:909"),
               "B3": ("banded SpMM on the esc2 contraction: the dense row "
                      "gather's batch-1 walk over S's nonzeros "
                      "(dense_row1_kernel)", "cuda", cu, f"{spmm}:476"),
               "B2": ("residual + LayerNorm forward", "triton", tr, f"{ln}:42"),
               "B4": ("batched diag-window SpMM: a row gather over S's "
                      "nonzeros with the escape rows added in its epilogue "
                      "(dense_rows_kernel, batch 4)", "cuda", cu, f"{spmm}:1138"),
               "B10": ("batched banded SpMM on the esc2 contraction: the row "
                       "gather over S's nonzeros (dense_rows_kernel; its int8 "
                       "S01 form is held in phase 11)", "cuda", cu, f"{spmm}:609"),
               "B2b": ("residual + LayerNorm backward", "triton", tr,
                       f"{ln}:59"),
               "B5": (f"windowed attention forward (nb = 1{one}): one pass "
                      "over the row's list, a 16-lane group a row with its 7 k "
                      "and 7 v gathers in flight, 64 rows a CTA "
                      "(attn_fwd_kernel)", "cuda", acu, f"{att}:522"),
               "B5b": (f"batched windowed attention forward (nb = 2{one}; the "
                       "items on the grid, attn_fwd_kernel)",
                       "cuda", acu, f"{att}:619"),
               "B6": (f"attention dQ and row stats (nb = 1{one}): one pass "
                      "over the row's list, a 16-lane group a row with its 7 k "
                      "and 7 v gathers in flight, 64 rows a CTA "
                      "(attn_dq_kernel)", "cuda", acu, f"{att}:771"),
               "B6b": (f"batched attention dQ and row stats (nb = 8{one}; the "
                       "items on the grid, attn_dq_kernel)",
                       "cuda", acu, f"{att}:875"),
               "B7": (f"attention dK and dV (nb = 1{one}): the transpose list "
                      "in chunks of 7, a chunk's q and g gathers and stats in "
                      "flight (attn_dkdv_kernel)", "cuda", acu, f"{att}:1053"),
               "B7b": (f"batched attention dK and dV (nb = 8{one}; the items "
                       "on the grid, attn_dkdv_kernel)", "cuda",
                       acu, f"{att}:1216"),
               "B1p": ("packed diag-window SpMM: S01 bits, rank-1 scales "
                       "(the packed branch of _diag_kernel): the bit-row "
                       "gather's batch-1 walk with the escape rows added "
                       "before the row scale (packed_row1_kernel)", "cuda", cu,
                       f"{spmm}:998"),
               "B4p": ("batched packed diag-window SpMM (the packed branch of "
                       "_diag_kernel_b): a row gather over the set bits with "
                       "the escape rows added before the row scale "
                       "(packed_rows_kernel, batch 4)", "cuda", cu, f"{spmm}:1224"),
               "B13": ("bit-packed banded SpMM, a row gather over the set "
                       "bits (batch 4, the train-mesh shape)", "cuda", cu,
                       f"{spmm}:1556"),
               "B13u": ("bit-packed banded SpMM (unbatched: the batch-1 walk, "
                        "packed_row1_kernel; one count with B13)", "cuda",
                        cu, f"{spmm}:1556"),
               "B8": ("SDDMM: window-relative score tile (one item, f 128): "
                      "the block's a rows once in shared memory, b's window "
                      "through a cp.async ring, mma.sync tiles, the scores "
                      "staged and stored as whole row segments "
                      "(sddmm_tc_kernel)", "cuda", ucu, f"{att}:78"),
               "B9": (f"transpose SpMM on a runtime S (nb = 1, f 128{one}): a "
                      "CTA a source block walks its covering blocks, s and g "
                      "tiles through a TMA ring with mbarriers, S^T by "
                      "ldmatrix.trans into mma.sync (spmm_t_tc_kernel)",
                      "cuda", ucu, f"{att}:171"),
               "B9b": (f"batched transpose SpMM (nb = 2, f 128{one}; the items "
                       "on the grid, spmm_t_tc_kernel)", "cuda", ucu,
                       f"{att}:1393"),
               "B11": ("windowed-dense SpMM, absolute starts: a row gather "
                       "over S's nonzeros (RCM order, F 256, unbatched: the "
                       "batch-1 walk, dense_row1_kernel)",
                       "cuda", cu, f"{spmm}:353"),
               "B12": ("blocked-ELL SpMM: gather, scale, sum (RCM order, F "
                       "256, unbatched)", "cuda", cu, f"{spmm}:46"),
               "B14": ("block-tile (BSR) SpMM: a warp a row walks the active "
                       "tiles' slots and gathers the live ones (RCM order, F "
                       "256, unbatched: tile_walk_kernel; a batch lists them "
                       "once and gathers the list per item, tile_list_kernel)",
                       "cuda", cu, f"{spmm}:194"),
               "B5f256": ("windowed attention forward at f 256 on the packed "
                          "L7 diag graph: the bench's attention aggregation "
                          "(attn_fwd_kernel; held on independent q, k and v; "
                          "its launches are the bench run's)",
                          "cuda", acu, f"{att}:522"),
               "B3r": ("int8 rank-1 banded SpMM a . K(a . x) on the RCM band "
                       "(unbatched): the dense row gather's batch-1 walk over "
                       "the int8 S01 with both scales inside "
                       "(dense_row1_kernel)", "cuda", cu, f"{spmm}:476"),
               "B10r": ("int8 rank-1 banded SpMM on the RCM band (batch 4): the "
                        "dense row gather over the int8 S01 with both scales "
                        "inside (dense_rows_kernel; one count with B3r)", "cuda",
                        cu, f"{spmm}:609"),
               "SS": ("segment sum of GraphCast's edge operators (mesh2grid's sender "
                      "side, bf16, L 512; launches a train step): a thread group a "
                      "row walks its span of the sorted edges, no atomics "
                      "(segment_sum_kernel)", "cuda", "gwen_tpu_torch/csrc/edge_sum.cu",
                      "none: the JAX package has no GraphCast")}
    counted_as = {"B5b": "B5", "B6b": "B6", "B7b": "B7", "B9b": "B9", "B13u": "B13",
                  "B10r": "B3r"}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": f"{key} {name}", "route": route, "source": src,
                "replaces": rep, "launches": launches[counted_as.get(key, key)],
                **{k: results[key][k] for k in keys}}
               for key, (name, route, src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
