"""The program's spans (``profiling.annotate``) and its kernel-load counter:
with no profiler running a span is one shared null context; under
``torch.profiler`` a train step and an ensemble request open exactly the
documented tree of ``gwen.*`` spans; numbers are bit-equal with the
profiler on and off; each kernel load is counted once."""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gwen_tpu_torch import ops, profiling
from gwen_tpu_torch.ensemble import generate_ensemble
from gwen_tpu_torch.graph import (
    apply_order,
    build_graph,
    icosphere_edges,
    kd_patch_order,
    to_diag_window,
)
from gwen_tpu_torch.nn import EncodeProcessDecode
from gwen_tpu_torch.ops import cuda_lib, fused_ln
from gwen_tpu_torch.train import Trainer, TrainState, make_optimizer, mesh_graph_loss_fn
from test_torch_cuda_lib import LoadedLib

STEPS, MLP, SMOOTHING, LEAD = 2, 2, 2, 3
PROCESSORS = ["gcn", "attention"]
ENTRIES = ["train_step", "ensemble"]


@pytest.fixture(scope="module")
def graphs():
    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    perm = kd_patch_order(np.asarray(verts), s, r, n)
    s2, r2, _ = apply_order(perm, s, r)
    coo = build_graph(s2, r2, n)
    return {p: to_diag_window(coo, window_size=384, block_size=128, superblock=8,
                              dtype=torch.bfloat16, transpose_tables=p == "attention")
            for p in PROCESSORS}


def model(processor):
    return EncodeProcessDecode(1, 1, device="cpu", latent_size=128, process_steps=STEPS,
                               mlp_layers=MLP, compute_dtype=torch.bfloat16,
                               processor=processor, attn_heads=2,
                               generator=torch.Generator().manual_seed(3))


def inputs(n):
    gen = torch.Generator().manual_seed(5)
    return [torch.randn(2, n, 1, generator=gen) for _ in range(2)] + [
        torch.randn(4, n, 1, generator=gen)]


def run(entry, processor, graph, traced):
    """One train step (loss and gradients) or one request (trajectory),
    under ``torch.profiler`` when ``traced``; returns the numbers and the
    profiler (or None)."""
    m = model(processor)
    x, y, noise = inputs(graph.num_nodes)
    ctx = profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()
    with ctx as prof:
        if entry == "train_step":
            trainer = Trainer(mesh_graph_loss_fn(m, "mse"), "cpu", context=graph)
            state = TrainState(m, make_optimizer(m.parameters(), 1e-4))
            grads = {}
            for name, p in m.named_parameters():
                p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
            out = {"loss": trainer.train_step(state, (x, y)), **grads,
                   **{f"after.{k}": v.detach().clone() for k, v in m.named_parameters()}}
        else:
            out = {"trajectory": generate_ensemble(m, graph, x[0], None, 4, LEAD,
                                                   smoothing_steps=SMOOTHING, noise=noise)}
    return out, prof


def span_tree(prof) -> list:
    """The ``gwen.*`` host spans as nested ``(name, [children])``."""
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("gwen.")),
                 key=lambda e: (e.start_ns(), -e.duration_ns()))
    root: list = []
    stack: list = []  # (end_ns, children)
    for e in evs:
        while stack and stack[-1][0] <= e.start_ns():
            stack.pop()
        node = (e.name(), [])
        (stack[-1][1] if stack else root).append(node)
        stack.append((e.start_ns() + e.duration_ns(), node[1]))
    return root


def leaf(name):
    return (name, [])


def forward_tree(processor) -> list:
    linear = leaf("gwen.op.linear")
    if processor == "gcn":
        step = [linear, leaf("gwen.op.aggregate"), linear, leaf("gwen.op.residual_ln")]
    else:
        step = [linear] * 3 + [leaf("gwen.op.attention"), linear,
                               leaf("gwen.op.residual_ln")]
    return ([("gwen.encoder", [linear] * MLP)] + [("gwen.process", step)] * STEPS
            + [("gwen.decoder", [linear] * MLP)])


def expected_tree(entry, processor) -> list:
    if entry == "ensemble":
        return [("gwen.ensemble", [("gwen.perturb", [leaf("gwen.op.aggregate")] * SMOOTHING)]
                 + [("gwen.lead_step", forward_tree(processor))] * LEAD)]
    op = "gwen.op.aggregate.bwd" if processor == "gcn" else "gwen.op.attention.bwd"
    backward = [leaf("gwen.op.residual_ln.bwd"), leaf(op)] * STEPS
    return [("gwen.train_step", [("gwen.forward", forward_tree(processor)),
                                 ("gwen.backward", backward), leaf("gwen.optimizer")])]


def test_annotate_without_a_profiler_is_one_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.annotate("gwen.train_step")
    assert first is profiling.annotate("gwen.op.linear")
    assert isinstance(first, contextlib.nullcontext)
    with first:
        with profiling.annotate("gwen.forward"):
            pass


def test_annotate_under_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = profiling.annotate("gwen.test")
        with span:
            torch.ones(4).sum()
    assert not isinstance(span, contextlib.nullcontext)
    assert span_tree(prof) == [leaf("gwen.test")]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("processor", PROCESSORS)
def test_spans_open_the_documented_tree(graphs, processor, entry):
    _, prof = run(entry, processor, graphs[processor], traced=True)
    assert span_tree(prof) == expected_tree(entry, processor)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("processor", PROCESSORS)
def test_numbers_are_bit_equal_with_the_profiler_on_and_off(graphs, processor, entry):
    off, _ = run(entry, processor, graphs[processor], traced=False)
    on, _ = run(entry, processor, graphs[processor], traced=True)
    assert off.keys() == on.keys()
    for name in off:
        assert torch.equal(off[name], on[name]), name


OWNERS = {"nvcc": cuda_lib.nvcc_build,
          **{lib.source.stem: lib for lib in cuda_lib.LIBRARIES},
          "ln_fwd": fused_ln.residual_layernorm_fwd, "ln_bwd": fused_ln.residual_layernorm_bwd}


def _load_twice(name, monkeypatch, tmp_path):
    """Make the load ``name`` twice through its real counting code, with
    the compiler or the library replaced by a stand-in; the counters are
    restored after the test."""
    owner = OWNERS[name]
    monkeypatch.setattr(owner, "loads", owner.loads)
    monkeypatch.setattr(owner, "load_seconds", owner.load_seconds)
    if name == "nvcc":
        nvcc = tmp_path / "nvcc"
        nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                        '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi; shift\ndone\n')
        nvcc.chmod(0o755)
        src = tmp_path / "k.cu"
        src.write_text("// a kernel\n")
        monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(nvcc))
        monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
        for _ in range(2):
            cuda_lib.nvcc_build(src)
        return
    if isinstance(owner, cuda_lib.CudaLib):
        monkeypatch.setattr(owner, "lib", None)
        monkeypatch.setattr(owner, "build", lambda: (Path("libfake.so"), ""))
        monkeypatch.setattr(cuda_lib.ctypes, "CDLL", LoadedLib)
        assert owner() is owner()
        return
    monkeypatch.setattr(owner, "specialisations", set())
    launched = []
    for _ in range(2):
        fused_ln._first_call(owner, ("a specialisation",), lambda: launched.append(1))
    assert len(launched) == 2


@pytest.mark.parametrize("name", sorted(OWNERS))
def test_a_kernel_load_is_counted_once(name, monkeypatch, tmp_path):
    before = ops.kernel_loads()
    _load_twice(name, monkeypatch, tmp_path)
    after = ops.kernel_loads()
    assert after[name]["count"] == before[name]["count"] + 1
    assert after[name]["seconds"] >= before[name]["seconds"]
    assert {k: v for k, v in after.items() if k != name} == {
        k: v for k, v in before.items() if k != name}
