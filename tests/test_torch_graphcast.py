"""GraphCast on the port (``gwen_tpu_torch.nn.graphcast``) against the
benchmark's plain reference (``portbench/reference/graphcast.py``) on the
CPU at a small size: a 10° grid (19 × 36), the multimesh M0–M2, latent 32,
2 processor layers, 6 inputs and 4 outputs, seeded weights. Also the
graph builders against the reference's own, the published graph sizes,
the segment tables and the edge sums (against numpy, float64 and the
``index_add_`` operators they replaced), the spans and the call counter,
the configuration and the trainer."""

import numpy as np
import pytest
import torch

from gwen_tpu_torch.config import GwenConfig
from gwen_tpu_torch.graph.graphcast import BipartiteGraph, build_graphcast_graphs, multimesh
from gwen_tpu_torch.nn import graphcast as gc
from gwen_tpu_torch.ops import edges
from gwen_tpu_torch.nn.gnn import parse_block_remat
from gwen_tpu_torch.train import Trainer, TrainState, graphcast_loss_fn, make_optimizer
from gwen_tpu_torch.train.tasks import graphcast_channel_weights
from portbench.reference import graphcast as ref
from portbench.reference.epd import bf16_cast, fp8_cast

GRID = {"grid_lat": 19, "grid_lon": 36, "refine": 2, "g2m_radius": 0.6}
MODEL = {"channels_in": 6, "channels_out": 4, "latent_size": 32, "process_steps": 2}
LOSS = {"levels_hpa": [500, 850], "atmospheric": 1, "surface_weights": [1.0, 0.1]}
OPT = {"lr": 1e-3, "betas": [0.9, 0.95], "weight_decay": 0.1, "eps": 1e-8}


@pytest.fixture(scope="module")
def small():
    graphs = build_graphcast_graphs(19, 36, 2)
    params = ref.init_params(MODEL, torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(2, graphs.num_grid, 6, generator=gen)
    y = torch.randn(2, graphs.num_grid, 4, generator=gen)
    dg = ref.DeviceGraphs(ref.build_graphs(GRID), "cpu", LOSS)
    return graphs, params, x, y, dg


def program(params, dtype=torch.float32, remat=False):
    model = gc.GraphCast(6, 4, device="cpu", latent_size=32, process_steps=2,
                         compute_dtype=dtype, remat=remat)
    model.load_state_dict(params)
    return model


def program_loss_and_grads(model, graphs, x, y):
    loss_fn = graphcast_loss_fn(model, 19, 36, graphcast_channel_weights(**{
        "levels": LOSS["levels_hpa"], "atmospheric": 1, "surface": LOSS["surface_weights"]}))
    loss, preds = loss_fn((x, y), graphs)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}, preds


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's ``‖got − want‖`` over the larger of ``‖want‖`` and the
    median leaf's norm."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return {k: float((got[k] - want[k]).norm()) / max(norms[k], med) for k in want}


# ------------------------------------------------------------------ graphs

@pytest.mark.parametrize("size", [(19, 36, 2), (37, 72, 3)])
def test_graphs_match_the_reference_builders(size):
    n_lat, n_lon, level = size
    want = ref.build_graphs({"grid_lat": n_lat, "grid_lon": n_lon, "refine": level,
                             "g2m_radius": 0.6})
    got = build_graphcast_graphs(n_lat, n_lon, level)
    for name in ("grid2mesh", "mesh", "mesh2grid"):
        g, (s, r, feats) = getattr(got, name), want[name]
        np.testing.assert_array_equal(g.senders.numpy(), s)
        np.testing.assert_array_equal(g.receivers.numpy(), r)
        np.testing.assert_allclose(g.edge_features.numpy(), feats, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.mesh_features.numpy(), want["mesh_features"], atol=1e-7)


def test_m6_multimesh_size():
    verts, s, r = multimesh(6)
    assert len(verts) == 40_962 and len(s) == len(r) == 327_660
    assert np.all(np.diff(r) >= 0)


@pytest.fixture(scope="module")
def published():
    return build_graphcast_graphs()


def test_published_grid_graphs(published):
    g = published
    assert g.num_grid == 1_038_240 and g.num_mesh == 40_962
    per_grid = np.bincount(g.mesh2grid.receivers.numpy(), minlength=g.num_grid)
    assert per_grid.min() == per_grid.max() == 3
    assert np.bincount(g.grid2mesh.receivers.numpy(), minlength=g.num_mesh).min() >= 1
    # Within 1 % of the published 1,618,746: the icosahedron here has a
    # vertex at each pole, GraphCast's is rotated.
    assert abs(g.grid2mesh.num_edges / 1_618_746 - 1) < 0.01
    assert g.mesh2grid.num_edges == 3_114_720 and g.mesh.num_edges == 327_660


BLOCKS = ("grid2mesh", "mesh", "mesh2grid")


@pytest.mark.parametrize("block", BLOCKS)
def test_segment_tables_match_numpy(small, block):
    g = getattr(small[0], block)
    s, r = g.senders.numpy(), g.receivers.numpy()
    for table in (g.receiver_offsets, g.sender_order, g.sender_offsets):
        assert table.dtype == torch.int32 and table.is_contiguous()
    np.testing.assert_array_equal(g.receiver_offsets.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(r, minlength=g.num_receivers))]))
    np.testing.assert_array_equal(g.sender_order.numpy(), np.argsort(s, kind="stable"))
    np.testing.assert_array_equal(g.sender_offsets.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(s, minlength=g.num_senders))]))


def test_empty_segments_and_unsorted_edges():
    """A node with no edge spans nothing (an offset step of 0) and sums to
    zero; edges out of receiver order are refused."""
    feats = np.zeros((4, 4), np.float32)
    g = BipartiteGraph.from_edges(np.array([0, 2, 2, 1]), np.array([1, 1, 3, 3]), 4, 5,
                                  feats).to("cpu")
    assert g.receiver_offsets.tolist() == [0, 0, 2, 2, 4, 4]
    assert g.sender_offsets.tolist() == [0, 1, 2, 4, 4]
    assert g.sender_order.tolist() == [0, 3, 1, 2]
    x = torch.arange(8.0).reshape(4, 2)
    assert edges.segment_sum(x, g.receiver_offsets).tolist() == [
        [0, 0], [2, 4], [0, 0], [10, 12], [0, 0]]
    assert edges.segment_sum(x, g.sender_offsets, g.sender_order).tolist() == [
        [0, 1], [6, 7], [6, 8], [0, 0]]
    with pytest.raises(ValueError):
        BipartiteGraph.from_edges(np.array([0, 1]), np.array([1, 0]), 2, 2, feats[:2])


def _operand(shape: tuple, layout: str, dtype=torch.float32, seed: int = 5) -> torch.Tensor:
    """Normal values of ``shape``; ``"strided"``: the middle third of a
    tensor three times as wide, as the join's cotangent is read."""
    gen = torch.Generator().manual_seed(seed)
    if layout == "contiguous":
        return torch.randn(*shape, generator=gen).to(dtype)
    f = shape[-1]
    return torch.randn(*shape[:-1], 3 * f, generator=gen).to(dtype)[..., f:2 * f]


@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("block", BLOCKS)
def test_plain_segment_sum_matches_float64(small, block, layout):
    """Each side of a block through its segment tables against a float64
    ``index_add_`` on the edges' own indices: float32 sums, so to 1e-5."""
    g = getattr(small[0], block)
    src = _operand((2, g.num_edges, 24), layout)
    for offsets, order, index, rows in (
            (g.receiver_offsets, None, g.receivers, g.num_receivers),
            (g.sender_offsets, g.sender_order, g.senders, g.num_senders)):
        got = edges.segment_sum_plain(src, offsets, order)
        want = torch.zeros(2, rows, 24, dtype=torch.float64).index_add_(
            1, index.long(), src.double())
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def _sum_into_before(src, index, num_rows):
    """The edge sums before the segment tables: ``index_add_`` on the
    edges' indices into float32, in chunks of 2**18 edges."""
    out = src.new_zeros(*src.shape[:-2], num_rows, src.shape[-1], dtype=torch.float32)
    for lo in range(0, index.shape[0], 1 << 18):
        out.index_add_(-2, index[lo:lo + (1 << 18)], src[..., lo:lo + (1 << 18), :].float())
    return out.to(src.dtype)


@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("block", BLOCKS)
def test_edge_operators_match_the_index_add_path(small, block, layout):
    """``edge_sum`` and ``gather_join`` forward and every gradient in bf16
    against the index_add_ path they replaced (its two operators as they
    were): the sums add in the same order, so bit for bit."""
    g = getattr(small[0], block)
    e = _operand((2, g.num_edges, 16), layout, torch.bfloat16, 1).requires_grad_()
    xs = _operand((2, g.num_senders, 16), layout, torch.bfloat16, 2).requires_grad_()
    xr = _operand((2, g.num_receivers, 16), layout, torch.bfloat16, 3).requires_grad_()
    cot = _operand((2, g.num_edges, 48), "contiguous", torch.bfloat16, 4)
    cot_sum = _operand((2, g.num_receivers, 16), "contiguous", torch.bfloat16, 6)

    def before(e, xs, xr):
        return (_GatherBefore.apply(e, xs, g.senders, xr, g.receivers),
                _SumBefore.apply(e, g.receivers, g.num_receivers))

    runs = []
    for fn in (lambda e, xs, xr: (edges.gather_join(e, xs, xr, g), edges.edge_sum(e, g)),
               before):
        leaves = [t.detach().requires_grad_() for t in (e, xs, xr)]
        joined, summed = fn(*leaves)
        torch.autograd.backward([joined, summed], [cot, cot_sum])
        runs.append([joined, summed] + [t.grad for t in leaves])
    for got, want in zip(*runs):
        assert torch.equal(got, want)


class _GatherBefore(torch.autograd.Function):
    """The gather and join before, with its float32 sums as the gradient."""

    @staticmethod
    def forward(ctx, e, xs, senders, xr, receivers):
        ctx.save_for_backward(senders, receivers)
        ctx.shapes = e.shape[-1], xs.shape[-2], xs.shape[-1], xr.shape[-2]
        return torch.cat([e, xs.index_select(-2, senders),
                          xr.index_select(-2, receivers)], dim=-1)

    @staticmethod
    def backward(ctx, grad):
        senders, receivers = ctx.saved_tensors
        fe, ns, fs, nr = ctx.shapes
        return (grad[..., :fe], _sum_into_before(grad[..., fe:fe + fs], senders, ns), None,
                _sum_into_before(grad[..., fe + fs:], receivers, nr), None)


class _SumBefore(torch.autograd.Function):
    """The edge sum before, with its gradient: the receiver's cotangent
    row for each edge."""

    @staticmethod
    def forward(ctx, e, receivers, num_rows):
        ctx.save_for_backward(receivers)
        return _sum_into_before(e, receivers, num_rows)

    @staticmethod
    def backward(ctx, grad):
        (receivers,) = ctx.saved_tensors
        return grad.index_select(-2, receivers), None, None


# ----------------------------------------------------- model and reference

def test_float32_matches_the_reference(small):
    """Forward, weighted loss and every parameter's gradient in float32:
    the same sums in another order, so to 1e-5 (loss, outputs) and 1e-4 of
    the leaf's norm (gradients)."""
    graphs, params, x, y, dg = small
    loss, grads, preds = program_loss_and_grads(program(params), graphs, x, y)
    want_loss, want_grads = ref.loss_and_grads(params, MODEL, dg, x, y)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    with torch.no_grad():
        want = ref.forward(params, MODEL, dg, x[0])
    torch.testing.assert_close(preds[0].detach(), want, rtol=1e-5, atol=1e-5)
    assert max(leaf_gaps(grads, want_grads).values()) < 1e-4


def test_bf16_path_matches_the_reference(small):
    """The bf16 program against the reference rounded where the program
    rounds (``bf16_cast``) and against float32, by the loss's relative gap
    and the median and worst leaf's gradient gap. Seeds 11, 21, 31 read at
    most 0.03 %, 0.19 % and 5.5 % against the rounded reference (the order
    of float32 sums differs, and a rounding that falls the other way moves
    later layers), 0.05 %, 0.61 % and 5.7 % against float32 (bf16's own
    error). The tolerances sit at 3–10 times those; the reference in
    float8 in the program's place reads 0.8–3 %, 5.5–7.5 % and 15–21 %,
    over the median's tolerance on every seed."""
    graphs, params, x, y, dg = small
    loss, grads, _ = program_loss_and_grads(program(params, torch.bfloat16), graphs, x, y)
    for cast, loss_tol, med_tol, worst_tol in ((bf16_cast, 0.002, 0.01, 0.12),
                                               (ref.identity, 0.005, 0.02, 0.12)):
        want_loss, want_grads = ref.loss_and_grads(params, MODEL, dg, x, y, cast)
        gaps = leaf_gaps(grads, want_grads)
        assert loss == pytest.approx(want_loss, rel=loss_tol)
        assert np.median(list(gaps.values())) < med_tol and max(gaps.values()) < worst_tol
    fp8_loss, fp8_grads = ref.loss_and_grads(params, MODEL, dg, x, y, fp8_cast)
    want_loss, want_grads = ref.loss_and_grads(params, MODEL, dg, x, y)
    assert np.median(list(leaf_gaps(fp8_grads, want_grads).values())) > 0.02


def test_recomputed_blocks_give_the_same_gradients(small):
    graphs, params, x, y, _ = small
    plain = program_loss_and_grads(program(params), graphs, x, y)
    gc.calls.clear()
    remat = program_loss_and_grads(program(params, remat=True), graphs, x, y)
    assert remat[0] == plain[0]
    assert max(leaf_gaps(remat[1], plain[1]).values()) < 1e-6
    assert gc.calls == {"g2m.gather": 1, "g2m.edge_sum": 1, "mesh.gather": 2,
                        "mesh.edge_sum": 2, "m2g.gather": 1, "m2g.edge_sum": 1,
                        "g2m.gather.recomputed": 1, "g2m.edge_sum.recomputed": 1,
                        "mesh.gather.recomputed": 2, "mesh.edge_sum.recomputed": 2,
                        "m2g.gather.recomputed": 1, "m2g.edge_sum.recomputed": 1}


def test_spans_open_and_the_counter_counts(small):
    graphs, params, x, y, _ = small
    model = program(params, remat="blocks:g2m+m2g")
    gc.calls.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        program_loss_and_grads(model, graphs, x, y)
    names = {ev.name for ev in prof.events()}
    for span in ("gwen.encoder", "gwen.process", "gwen.decoder", "gwen.graphcast.grid2mesh",
                 "gwen.graphcast.mesh2grid", "gwen.op.gather", "gwen.op.gather.bwd",
                 "gwen.op.edge_sum", "gwen.op.edge_sum.bwd", "gwen.op.linear",
                 "gwen.op.layer_norm", "gwen.op.residual_ln"):
        assert span in names, span
    assert gc.calls["mesh.gather"] == 2 and "mesh.gather.recomputed" not in gc.calls
    assert gc.calls["m2g.edge_sum.recomputed"] == 1


def test_block_remat_policy():
    assert parse_block_remat(False, gc.BLOCKS) == frozenset()
    assert parse_block_remat(True, gc.BLOCKS) == frozenset(gc.BLOCKS)
    assert parse_block_remat("blocks:g2m+m2g", gc.BLOCKS) == {"g2m", "m2g"}
    for bad in ("blocks:", "blocks:g2m+enc", "save_agg", "nested:2"):
        with pytest.raises(ValueError):
            parse_block_remat(bad, gc.BLOCKS)


# ----------------------------------------------------- configuration, train

def test_configuration_builds_and_trains_as_the_reference(small):
    """``model.architecture=graphcast`` through the port's configuration,
    two ``Trainer.train_step`` calls with AdamW (betas 0.9, 0.95) against
    the reference's AdamW steps in float32."""
    graphs, params, x, y, dg = small
    cfg = GwenConfig().apply_overrides([
        "model.architecture=graphcast", "model.channels_in=6", "model.channels_out=4",
        "model.latent_size=32", "model.process_steps=2", "model.compute_dtype=float32",
        "graph.grid_lat=19", "graph.grid_lon=36", "graph.refine=2", "train.remat=true"])
    built = gc.graphcast_graphs(cfg)
    np.testing.assert_array_equal(built.mesh2grid.senders.numpy(),
                                  graphs.mesh2grid.senders.numpy())
    model = gc.graphcast_from_config(cfg, "cpu")
    assert model._remat == frozenset(gc.BLOCKS)
    model.load_state_dict(params)
    opt = make_optimizer(model.parameters(), OPT["lr"], weight_decay=OPT["weight_decay"],
                         betas=tuple(OPT["betas"]))
    weights = graphcast_channel_weights([500, 850], 1, [1.0, 0.1])
    trainer = Trainer(graphcast_loss_fn(model, 19, 36, weights), "cpu", context=built)
    state = TrainState(model, opt)
    batches = [(x[:1], y[:1]), (x[1:], y[1:])]
    losses = [float(trainer.train_step(state, b)) for b in batches]
    want = ref.train_steps(params, MODEL, OPT, dg, batches)
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    after = {k: p.detach() for k, p in model.named_parameters()}
    change = {k: after[k] - params[k] for k in params}
    want_change = {k: want["params"][k] - params[k] for k in params}
    assert max(leaf_gaps(change, want_change).values()) < 1e-3


def test_other_architectures_are_refused():
    with pytest.raises(ValueError):
        gc.graphcast_from_config(GwenConfig(), "cpu")


def test_make_optimizer_default_betas_unchanged():
    """The default path is torch's Adam with its own betas, bit for bit;
    ``betas`` reaches AdamW."""
    torch.manual_seed(0)
    w = torch.randn(8, 4)
    a, b = w.clone().requires_grad_(), w.clone().requires_grad_()
    opt = make_optimizer([a], 1e-2)
    plain = torch.optim.Adam([b], lr=1e-2)
    for _ in range(3):
        for p in (a, b):
            (p ** 2).sum().backward()
        opt.step([a])
        plain.step()
        plain.zero_grad()
    assert torch.equal(a, b)
    assert opt.optim.defaults["betas"] == (0.9, 0.999)
    w2 = make_optimizer([a], 1e-3, weight_decay=0.1, betas=(0.9, 0.95))
    assert isinstance(w2.optim, torch.optim.AdamW) and w2.optim.defaults["betas"] == (0.9, 0.95)
