"""GenCast on the port (``gwen_tpu_torch.nn.gencast``) against the
benchmark's plain reference (``portbench/reference/gencast.py``) on the CPU
at a small size: a 10° grid (19 × 36), the mesh M2 with 2-hop lists (16 to
19 sources a row), latent 32, 2 transformer layers of 4 heads, FFN 64, 10
inputs and 4 outputs, seeded weights. Also the k-hop lists against a
breadth-first search, the attention operators on the neighbour-list graph
against the reference's attention, the conditional norm against its
equation, the remat, spans and pair counter, the configuration and the
trainer."""

import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gwen_tpu_torch.config import GwenConfig
from gwen_tpu_torch.graph.build import faces_to_edges, icosphere_edges
from gwen_tpu_torch.graph.gencast import build_gencast_graphs
from gwen_tpu_torch.graph.graph import khop_lists, neighbour_list_graph
from gwen_tpu_torch.graph.graphcast import icosphere_faces
from gwen_tpu_torch.nn import gencast as gn
from gwen_tpu_torch.nn.attention import graph_attention_apply, graph_attention_init
from gwen_tpu_torch.ops import attention_cuda as ac
from gwen_tpu_torch.ops.attention import windowed_attention
from gwen_tpu_torch.ops.fused_ln import cond_layernorm
from gwen_tpu_torch.train import Trainer, TrainState, gencast_denoising_loss_fn, make_optimizer
from gwen_tpu_torch.train.tasks import edm_scalings, graphcast_channel_weights
from portbench.checks import STILL_LEAF
from test_torch_cuda_lib import fake_lib  # noqa: F401 (fixture)
from portbench.reference import gencast as ref
from portbench.reference.epd import fp8_cast

GRID = {"grid_lat": 19, "grid_lon": 36, "refine": 2, "g2m_radius": 0.6, "k_hop": 2}
MODEL = {"channels_in": 10, "channels_out": 4, "latent_size": 32, "process_steps": 2,
         "attn_heads": 4, "ffn_size": 64}
LOSS = {"levels_hpa": [500, 850], "atmospheric": 1, "surface_weights": [1.0, 0.1]}
EDM = {"sigma_data": 1.0, "p_mean": -1.2, "p_std": 1.2}
OPT = {"lr": 1e-3, "betas": [0.9, 0.95], "weight_decay": 0.1, "eps": 1e-8}
WEIGHTS = graphcast_channel_weights([500, 850], 1, [1.0, 0.1])


@pytest.fixture(scope="module")
def small():
    graphs = build_gencast_graphs(19, 36, 2, 0.6, 2)
    params = ref.init_params(MODEL, torch.Generator().manual_seed(21))
    gen = torch.Generator().manual_seed(22)
    cond = torch.randn(2, graphs.num_grid, 6, generator=gen)
    y = torch.randn(2, graphs.num_grid, 4, generator=gen)
    dg = ref.DeviceGraphs(GRID, "cpu", LOSS)
    return graphs, params, cond, y, dg


def program(params, dtype=torch.float32, remat=False):
    model = gn.GenCast(10, 4, device="cpu", latent_size=32, process_steps=2, heads=4,
                       ffn_size=64, compute_dtype=dtype, remat=remat)
    model.load_state_dict(params)
    return model


def program_loss_and_grads(model, graphs, cond, y, seed):
    loss_fn = gencast_denoising_loss_fn(model, 19, 36, WEIGHTS)
    loss, denoised = loss_fn((cond, y, seed), graphs)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's ``‖got − want‖`` over the larger of ``‖want‖`` and the
    median leaf's norm."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return {k: float((got[k] - want[k]).norm()) / max(norms[k], med) for k in want}


# ------------------------------------------------------------------ graphs

def bfs_lists(s: np.ndarray, r: np.ndarray, n: int, hops: int) -> list[list[int]]:
    """Each node's nodes within ``hops`` edges (itself included), sorted:
    a breadth-first search from every node."""
    adj = collections.defaultdict(list)
    for a, b in zip(s.tolist(), r.tolist()):
        adj[b].append(a)
    out = []
    for i in range(n):
        dist = {i: 0}
        queue = collections.deque([i])
        while queue:
            u = queue.popleft()
            if dist[u] == hops:
                continue
            for w in adj[u]:
                if w not in dist:
                    dist[w] = dist[u] + 1
                    queue.append(w)
        out.append(sorted(dist))
    return out


def as_lists(nbr: torch.Tensor) -> list[list[int]]:
    return [[int(j) for j in row if j >= 0] for row in nbr]


def random_graph(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """An undirected random graph with an isolated node (the last)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n - 1, 3 * n)
    b = rng.integers(0, n - 1, 3 * n)
    keep = a != b
    e = np.unique(np.sort(np.stack([a[keep], b[keep]], 1), axis=1), axis=0)
    return np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]])


@pytest.mark.parametrize("hops", [0, 1, 2, 4])
@pytest.mark.parametrize("graph", ["icosphere", "random"])
def test_khop_lists_equal_a_breadth_first_search(graph, hops):
    if graph == "icosphere":
        verts, s, r = icosphere_edges(2)
        n = len(verts)
    else:
        n = 60
        s, r = random_graph(n, 5)
    got = khop_lists(s, r, n, hops)
    assert got.dtype == torch.int32 and got.shape[1] == max(map(len, bfs_lists(s, r, n, hops)))
    assert as_lists(got) == bfs_lists(s, r, n, hops)


def test_khop_sizes_and_symmetry():
    """1 + 3h(h + 1) nodes on the hexagonal mesh, fewer near the 12
    pentagons; the lists are their own transpose."""
    verts, faces = icosphere_faces(3)
    s, r = faces_to_edges(faces[-1])
    g = neighbour_list_graph(s, r, len(verts), 3)
    lens = (g.attn_nbr >= 0).sum(1)
    assert int(lens.max()) == 1 + 3 * 3 * 4 and int(lens.min()) < 37
    assert g.num_pairs == int(lens.sum()) and g.attn_nbr_t is g.attn_nbr
    pairs = {(i, j) for i, row in enumerate(as_lists(g.attn_nbr)) for j in row}
    assert all((j, i) in pairs for i, j in pairs)
    with pytest.raises(ValueError, match="undirected"):
        neighbour_list_graph(s[: len(s) // 2], r[: len(r) // 2], len(verts), 2)


def test_graphs_map_to_the_reference_through_the_mesh_order(small):
    """The program's mesh in its locality order: its lists, grid2mesh and
    mesh2grid are the reference's own, relabelled by ``mesh_perm``."""
    graphs, _, _, _, dg = small
    perm = graphs.mesh_perm.numpy()
    want = [set(dg.nbr_idx[i][dg.nbr_mask[i]].tolist()) for i in range(dg.n_mesh)]
    for i, row in enumerate(as_lists(graphs.mesh.attn_nbr)):
        assert {int(perm[j]) for j in row} == want[perm[i]]
    for name, mesh_side in (("grid2mesh", "receivers"), ("mesh2grid", "senders")):
        g = getattr(graphs, name)
        s, r = g.senders.numpy().copy(), g.receivers.numpy().copy()
        if mesh_side == "receivers":
            r = perm[r]
        else:
            s = perm[s]
        ws, wr, feats = (t.numpy() for t in dg.edges[name])
        order = np.lexsort((s, r))
        np.testing.assert_array_equal(s[order], ws)
        np.testing.assert_array_equal(r[order], wr)
        np.testing.assert_allclose(g.edge_features.numpy()[order], feats, atol=1e-7)


# --------------------------------------------------------------- operators

def reference_attention(q, k, v, dg, perm):
    """The reference's attention on ``(H, N, dh)`` operands in the
    program's mesh order, through its own lists in the natural order."""
    inv = np.argsort(perm)  # program row of each natural node
    qn, kn, vn = (t[:, inv].permute(1, 0, 2) for t in (q, k, v))  # natural (N, H, dh)
    out = ref.attend(qn, kn, vn, dg, q.shape[-1] ** -0.5, ref.identity)
    return out.permute(1, 0, 2)[:, perm]


@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_list_attention_against_the_reference(small, backend, monkeypatch):
    """Forward and the gradients of q, k and v on the list graph: the
    kernels' plain versions (``auto``: the Function over B5, B6, B7's plain
    versions, a few rows a pass) and autograd through the plain forward,
    against the reference's masked tiles over blocks of rows; float32 sums
    in another order, so to 1e-5."""
    graphs = small[0]
    monkeypatch.setattr(ac, "_LIST_PASS", 4 * 19 * 8 * 13)
    monkeypatch.setattr(ref, "ATTN_ROWS", 16)  # the reference's blocks: 16 of 10–11 rows
    dg = ref.DeviceGraphs(GRID, "cpu", LOSS)
    assert len(dg.blocks) == 16
    gen = torch.Generator().manual_seed(3)
    leaves = [torch.randn(4, graphs.num_mesh, 8, generator=gen, requires_grad=True)
              for _ in range(3)]
    cot = torch.randn(4, graphs.num_mesh, 8, generator=gen)
    out = windowed_attention(graphs.mesh, *leaves, backend=backend)
    grads = torch.autograd.grad(out, leaves, cot)
    perm = graphs.mesh_perm.numpy()
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    want = reference_attention(*ref_leaves, dg, perm)
    want_grads = torch.autograd.grad(want, ref_leaves, cot)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    for got, exp in zip(grads, want_grads):
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


def test_kernels_take_the_lists_and_the_products_rows(small, fake_lib):
    """GenCast's attention at 4 heads of 128 through the recording library:
    B5, B6 and B7 each launch once on the list graph, with its lists (and
    the same lists as B7's transpose lists) at their full width, q, k and v
    read in the products' rows (head stride dh, row stride 4·dh), and no
    operand copied."""
    graphs = small[0]
    mod = graph_attention_init(512, 4, torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros(1, graphs.num_mesh, 512, requires_grad=True)
    before = ac.operand_copies
    graph_attention_apply(mod, graphs.mesh, x, heads=4).sum().backward()
    assert ac.operand_copies == before
    (n5, a5), (n6, a6), (n7, a7) = fake_lib.calls
    assert (n5, n6, n7) == ("gwen_attn_fwd", "gwen_attn_dq", "gwen_attn_dkdv")
    nbr = graphs.mesh.attn_nbr
    assert a5[3] == a6[4] == a7[5] == nbr.data_ptr()
    assert list(a5[5]) == [128, graphs.num_mesh * 512, 512] * 2
    assert list(a5[6:11]) == [4, 1, graphs.num_mesh, graphs.num_mesh, nbr.shape[1]]


def test_list_graphs_refuse_the_unfused_backend(small):
    graphs = small[0]
    q = torch.randn(graphs.num_mesh, 8)
    with pytest.raises(ValueError, match="diag window"):
        windowed_attention(graphs.mesh, q, q, q, backend="unfused")


@pytest.mark.parametrize("width", [128, 48])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("residual", [False, True])
def test_cond_norm_is_its_equation(width, batch, residual):
    """``LN(m)·(1 + s) + o (+ h)`` in float32, forward and the gradients of
    m, s, o (and h): B2/B2b's plain versions at one sample, any width,
    plain torch over a batch; the same float32 arithmetic in another
    order, so to 1e-5."""
    gen = torch.Generator().manual_seed(width + batch)
    m = torch.randn(batch, 30, width, generator=gen, requires_grad=True)
    h = torch.randn(batch, 30, width, generator=gen, requires_grad=True) if residual else None
    s = torch.randn(batch, width, generator=gen, requires_grad=True)
    o = torch.randn(batch, width, generator=gen, requires_grad=True)
    got = cond_layernorm(m, 1 + s, o, h)
    want = (F.layer_norm(m, (width,), eps=1e-6) * (1 + s[:, None]) + o[:, None]
            + (h if residual else 0))
    cot = torch.randn(want.shape, generator=gen)
    leaves = [t for t in (m, s, o, h) if t is not None]
    for a, b in zip(torch.autograd.grad(got, leaves, cot), torch.autograd.grad(want, leaves, cot)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["batch", "residual"])
def test_cond_norm_on_the_card_takes_one_sample(case, monkeypatch):
    """On a CUDA tensor a scale row a sample over a batch of 2, or a
    residual of another shape than ``m``, raises before any launch (B2/B2b
    take one scale and offset row, and ``h`` shaped as ``m``); the CPU runs
    both in plain torch."""
    from gwen_tpu_torch.ops import cuda_lib, fused_ln

    b = 2 if case == "batch" else 1
    m, s = torch.randn(b, 8, 128), torch.randn(b, 128)
    h = torch.randn(8, 128) if case == "residual" else None
    want = cond_layernorm(m, 1 + s, s, h)
    launches = fused_ln.residual_layernorm.launches
    monkeypatch.setattr(cuda_lib, "on_cuda", lambda x, kernels: True)
    with pytest.raises(ValueError, match="takes one sample"):
        cond_layernorm(m, 1 + s, s, h)
    assert fused_ln.residual_layernorm.launches == launches
    assert want.shape == m.shape


def test_cond_norm_backward_span():
    """One sample at width 128 runs its backward as B2b, inside
    ``gwen.op.cond_norm.bwd``."""
    m = torch.randn(1, 8, 128, requires_grad=True)
    s, o = torch.zeros(128, requires_grad=True), torch.zeros(128, requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cond_layernorm(m, 1 + s, o).sum().backward()
    names = {ev.name for ev in prof.events()}
    assert {"gwen.op.cond_norm", "gwen.op.cond_norm.bwd"} <= names


# ------------------------------------------------------------------- model

def test_denoiser_loss_and_gradients_match_the_reference(small):
    """``F``, the EDM loss and every parameter's gradient in float32 (the
    draw is the same generator's): the same sums in other orders (edge
    sums, attention, the mesh order), so to 1e-5 (outputs, loss) and 1e-4
    of the leaf's norm (gradients)."""
    graphs, params, cond, y, dg = small
    loss, grads = program_loss_and_grads(program(params), graphs, cond, y, 2**40 + 7)
    want_loss, want_grads = ref.loss_and_grads(params, MODEL, dg, cond, y, 2**40 + 7, EDM)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert max(leaf_gaps(grads, want_grads).values()) < 1e-4
    x = torch.randn(graphs.num_grid, 10, generator=torch.Generator().manual_seed(4))
    sigma = torch.tensor(0.7)
    with torch.no_grad():
        got = program(params)(graphs, x, sigma.reshape(1))
        want = ref.forward(params, MODEL, dg, x, sigma)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_path_stays_near_the_reference(small):
    """The bf16 program against the float32 reference: bf16's own error on
    a 2-layer model, the loss within 1 % and the median leaf's gradient
    within 3 %, beside the float8 control's median, which is larger."""
    graphs, params, cond, y, dg = small
    loss, grads = program_loss_and_grads(program(params, torch.bfloat16), graphs, cond, y, 9)
    want_loss, want_grads = ref.loss_and_grads(params, MODEL, dg, cond, y, 9, EDM)
    assert loss == pytest.approx(want_loss, rel=0.01)
    gaps = np.median(list(leaf_gaps(grads, want_grads).values()))
    _, fp8 = ref.loss_and_grads(params, MODEL, dg, cond, y, 9, EDM, fp8_cast)
    assert gaps < 0.03 < np.median(list(leaf_gaps(fp8, want_grads).values()))


def test_recomputed_blocks_give_the_same_gradients(small):
    """Every block recomputed in its backward (the norms' scales and
    offsets an input of each) against none: the same sums again."""
    graphs, params, cond, y, _ = small
    plain = program_loss_and_grads(program(params), graphs, cond, y, 11)
    remat = program_loss_and_grads(program(params, remat=True), graphs, cond, y, 11)
    assert remat[0] == plain[0]
    assert max(leaf_gaps(remat[1], plain[1]).values()) < 1e-6
    assert float(plain[1]["noise.layer_0.w"].norm()) > 0


def test_spans_open_and_the_pair_counter_counts(small):
    graphs, params, cond, y, _ = small
    model = program(params, remat="blocks:g2m+m2g")
    before = gn.attn_pairs
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        program_loss_and_grads(model, graphs, cond, y, 12)
    names = {ev.name for ev in prof.events()}
    for span in ("gwen.gencast.condition", "gwen.gencast.noise", "gwen.encoder",
                 "gwen.process", "gwen.decoder", "gwen.graphcast.grid2mesh",
                 "gwen.graphcast.mesh2grid", "gwen.op.cond_norm", "gwen.op.attention", "gwen.op.attention.bwd", "gwen.op.gather",
                 "gwen.op.edge_sum", "gwen.op.linear"):
        assert span in names, span
    assert gn.attn_pairs - before == 2 * 2 * 4 * graphs.mesh.num_pairs  # 2 layers, 4 heads


def test_reference_loss_and_output_move_with_sigma(small):
    """The conditioning is live in the reference: ``F`` and the loss at one
    noise level differ from another's on the same inputs and noise."""
    _, params, cond, y, dg = small
    x = torch.randn(dg.n_grid, 10, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        lo = ref.forward(params, MODEL, dg, x, torch.tensor(0.5))
        hi = ref.forward(params, MODEL, dg, x, torch.tensor(2.0))
    assert float((lo - hi).norm()) > 0.05 * float(lo.norm())
    fixed = [{**EDM, "p_std": 0.0, "p_mean": float(np.log(s))} for s in (0.5, 2.0)]
    losses = [ref.loss_and_grads(params, MODEL, dg, cond[:1], y[:1], 3, f)[0] for f in fixed]
    assert abs(losses[0] - losses[1]) > 0.05 * losses[0]


def test_edm_scalings():
    sigma = torch.tensor([0.01, 1.0, 80.0], dtype=torch.float64)
    c_skip, c_out, c_in, lam = edm_scalings(sigma)
    torch.testing.assert_close(c_skip, 1 / (sigma ** 2 + 1))
    torch.testing.assert_close(c_out, sigma / torch.sqrt(sigma ** 2 + 1))
    torch.testing.assert_close(c_in, 1 / torch.sqrt(sigma ** 2 + 1))
    torch.testing.assert_close(lam * c_out ** 2, torch.ones(3, dtype=torch.float64))


# ----------------------------------------------------- configuration, train

def test_configuration_builds_and_trains_as_the_reference(small):
    """``model.architecture=gencast`` through the port's configuration, two
    ``Trainer.train_step`` calls with AdamW (betas 0.9, 0.95, decay 0.1)
    against the reference's AdamW steps in float32. The keys' biases are
    left out of the change: softmax takes no gradient from them (the
    reference's is ~1e-9 of the median leaf's, rounding), and Adam scales
    that rounding to a full step (``checks.STILL_LEAF``)."""
    graphs, params, cond, y, dg = small
    cfg = GwenConfig().apply_overrides([
        "model.architecture=gencast", "model.channels_in=10", "model.channels_out=4",
        "model.latent_size=32", "model.process_steps=2", "model.attn_heads=4",
        "model.ffn_size=64", "model.compute_dtype=float32", "graph.grid_lat=19",
        "graph.grid_lon=36", "graph.refine=2", "graph.k_hop=2", "train.remat=blocks:g2m+m2g"])
    built = gn.gencast_graphs(cfg)
    assert torch.equal(built.mesh.attn_nbr, graphs.mesh.attn_nbr)
    model = gn.gencast_from_config(cfg, "cpu")
    assert model._remat == {"g2m", "m2g"}
    model.load_state_dict(params)
    opt = make_optimizer(model.parameters(), OPT["lr"], weight_decay=OPT["weight_decay"],
                         betas=tuple(OPT["betas"]))
    trainer = Trainer(gencast_denoising_loss_fn(model, 19, 36, WEIGHTS), "cpu", context=built)
    state = TrainState(model, opt)
    batches = [(cond[:1], y[:1], 31), (cond[1:], y[1:], 32)]
    losses = [float(trainer.train_step(state, b)) for b in batches]
    want = ref.train_steps(params, MODEL, OPT, EDM, dg, batches)
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    after = {k: p.detach() for k, p in model.named_parameters()}
    med = float(np.median([float(g.norm()) for g in want["grads"].values()]))
    moved = [k for k, g in want["grads"].items() if float(g.norm()) >= STILL_LEAF * med]
    assert sorted(set(params) - set(moved)) == ["layer_0.attn.wk.b", "layer_1.attn.wk.b"]
    change = {k: after[k] - params[k] for k in moved}
    want_change = {k: want["params"][k] - params[k] for k in moved}
    assert max(leaf_gaps(change, want_change).values()) < 1e-3


def test_other_architectures_are_refused():
    with pytest.raises(ValueError):
        gn.gencast_from_config(GwenConfig(), "cpu")
