"""The port's ``bench`` entry point against the reference's ``bench.py``
(CPU).

The ordered mesh against the reference's graph calls, one EPD train step
of the bench from the reference's parameters against the reference's
``train_step`` (rebuilt here from the calls ``bench.py`` makes; its
``main`` is never called: it writes the repo's ``BENCH_EXTRA.json``), and
the subcommand's output contract on every layout at L3 with
``--device cpu``. float32 results are held to rtol = atol = 1e-4.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gwen_tpu.graph as J
import gwen_tpu_torch.bench as bench
from gwen_tpu.nn import EncodeProcessDecode as JaxEPD
from gwen_tpu.train import TrainState as JState
from gwen_tpu_torch.cli.main import main as cli
from gwen_tpu_torch.nn import params_from_jax
from test_torch_ops import same_rcm  # noqa: F401 (fixture)
from test_torch_train import _flat

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = Path(__file__).resolve().parents[1]
# The reference's output file: its keys are the extras' key set, and the
# port must leave it byte for byte as it is.
BENCH_EXTRA = REPO / "BENCH_EXTRA.json"
REFERENCE_EXTRA_KEYS = set(json.loads(BENCH_EXTRA.read_text()))
ATTN_KEYS = {"attn_agg_ms", "attn_agg_edges_per_s"}
HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline"]


@pytest.fixture(autouse=True)
def one_thread():
    """The bench chains hundreds of tiny calls: on one torch thread they do
    not stall on the thread pool's barriers when other test processes share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_bench(monkeypatch):
    """L3, F 16, two iterations, window 128. Yields the repo's
    ``BENCH_EXTRA.json`` bytes, checked unchanged after the test."""
    for key, val in (("LEVELS", "3"), ("FEATURES", "16"), ("ITERS", "2"),
                     ("WINDOW", "128")):
        monkeypatch.setenv(f"GWEN_BENCH_{key}", val)
    before = BENCH_EXTRA.read_bytes()
    yield before
    assert BENCH_EXTRA.read_bytes() == before


def _run(capsys, *args):
    assert cli(["bench", "--device", "cpu", *args]) == 0
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 1, captured.out
    headline = json.loads(lines[0])
    train = [ln for ln in captured.err.splitlines()
             if ln.startswith("# train-step: ")]
    extra = json.loads(train[0][len("# train-step: "):]) if train else None
    return headline, extra, captured.err


# --------------------------------------------------------------- the mesh


def _reference_mesh(levels: int, ordering: str):
    """``(s, r, n)`` of the icosphere under ``ordering`` from the
    reference's graph calls, as ``bench.py``'s ``_build`` makes them."""
    verts, s, r = J.icosphere_edges(levels)
    n = verts.shape[0]
    perm = (J.kd_patch_order(verts, s, r, n) if ordering == "kd"
            else J.rcm_order(s, r, n))
    s, r, _ = J.apply_order(perm, s, r)
    return s, r, n


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("ordering", ["kd", "rcm"])
def test_mesh_matches_reference_graph_calls(levels, ordering, monkeypatch,
                                            tmp_path, same_rcm):
    """The port's ``_build`` against the reference's ordered edges through
    ``build_graph``; it writes nothing to the temporary directory."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    ws, wr, n = _reference_mesh(levels, ordering)
    g, gn = bench._build(levels, ordering)
    assert not list(tmp_path.iterdir())
    want = J.build_graph(ws, wr, n)
    assert gn == n and g.num_edges == want.num_edges
    e = want.num_edges
    for got, ref in zip(g.host_edges(), (want.senders, want.receivers, want.weights)):
        np.testing.assert_allclose(got, np.asarray(ref)[:e], **TOL)


# --------------------------------------------------------- the train step


@pytest.mark.parametrize("kernel", ["diag_packed", "sdense"])
def test_train_step_matches_reference(kernel, same_rcm):
    """One step of the bench's train step from the reference's parameters
    against ``bench.py``'s ``train_step`` in float32: the loss and every
    updated parameter."""
    f, levels = 8, 2
    ordering = "kd" if kernel in bench.DIAG_KERNELS else "rcm"
    g, n = bench._build(levels, ordering)
    graph, _ = bench.aggregation_graph(g, kernel, torch.float32, 128)
    gj = J.build_graph(*_reference_mesh(levels, ordering))
    if kernel == "diag_packed":
        gj = J.to_diag_window(gj, window_size=128, dtype=jnp.float32, packed=True)
    else:
        gj = J.to_windowed_dense(gj, dtype=jnp.float32)
    x = np.random.default_rng(5).normal(size=(n, f)).astype(np.float32)
    y = x * np.float32(0.9)

    # bench.py's train step, from the same calls.
    model = JaxEPD(channels_in=f, channels_out=f, latent_size=bench.LATENT,
                   process_steps=bench.PROCESS_STEPS, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(0)))
    opt = optax.adam(bench.LR)
    st = JState.create(params, opt)

    def loss(p):
        return jnp.mean((model.apply(p, gj, jnp.asarray(x)) - jnp.asarray(y)) ** 2)

    lval, grads = jax.value_and_grad(loss)(st.params)
    updates, _ = opt.update(grads, st.opt_state, st.params)
    want = _flat(optax.apply_updates(st.params, updates))

    state = bench.epd_state(f, "cpu", torch.float32)
    state.model.load_state_dict(params_from_jax(params))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        got_loss = bench.epd_loss(state.model, graph, xt, yt).item()
    np.testing.assert_allclose(got_loss, float(lval), **TOL)
    assert bench.train_step(state, graph, xt, yt) is state and state.step == 1
    got = {k: p.detach().numpy() for k, p in state.model.named_parameters()}
    assert set(got) == set(want)
    # Adam's first step moves each parameter by lr·g/(|g| + eps): held where
    # the gradient is above its rounding noise.
    g_flat, held = _flat(grads), 0
    for k in got:
        sure = np.abs(g_flat[k]) > 1e-4
        held += sure.sum()
        np.testing.assert_allclose(got[k][sure], want[k][sure], **TOL, err_msg=k)
    assert held > 0.5 * sum(v.size for v in g_flat.values())


# ------------------------------------------------------------- the command


@pytest.mark.parametrize("kernel", ["diag", "diag_packed", "sliding", "sdense",
                                    "ell"])
def test_bench_prints_the_reference_lines(kernel, small_bench, monkeypatch, capsys):
    monkeypatch.setenv("GWEN_BENCH_KERNEL", kernel)
    headline, extra, err = _run(capsys)
    assert list(headline) == HEADLINE_KEYS
    assert headline["metric"] == "spmm_edges_per_sec_per_chip"
    assert headline["unit"] == "edges/s"
    assert np.isfinite(headline["value"]) and np.isfinite(headline["vs_baseline"])
    mesh = [ln for ln in err.splitlines() if ln.startswith("# mesh L3: 642 nodes")]
    assert len(mesh) == 1 and f"kernel={kernel}," in mesh[0]
    assert "device=cpu" in mesh[0] and "device time not measured" in mesh[0]
    keys = (REFERENCE_EXTRA_KEYS if kernel in bench.DIAG_KERNELS
            else REFERENCE_EXTRA_KEYS - ATTN_KEYS)
    assert set(extra) == keys
    assert extra["kernel"] == kernel and extra["backend"] == "cpu"
    assert (extra["level"], extra["nodes"], extra["latent"],
            extra["process_steps"]) == (3, 642, 256, 4)
    assert extra["agg_edges_per_s"] == headline["value"]
    assert extra["vs_segment_baseline"] == headline["vs_baseline"]
    assert all(np.isfinite(extra[k]) for k in ("value", "agg_ms",
                                               "train_edges_per_s"))


def test_bench_without_baseline_gives_null(small_bench, monkeypatch, capsys):
    monkeypatch.setenv("GWEN_BENCH_BASELINE", "0")
    monkeypatch.setenv("GWEN_BENCH_TRAIN", "0")
    headline, extra, err = _run(capsys)
    assert headline["vs_baseline"] is None and extra is None
    assert "index_add-segment-f32 nan ms/iter" in err


def test_bench_without_attention_drops_its_keys(small_bench, monkeypatch, capsys):
    monkeypatch.setenv("GWEN_BENCH_ATTN", "0")
    monkeypatch.setenv("GWEN_BENCH_BASELINE", "0")
    _, extra, _ = _run(capsys)
    assert set(extra) == REFERENCE_EXTRA_KEYS - ATTN_KEYS
    assert extra["vs_segment_baseline"] is None


def test_bench_writes_extras_only_where_told(small_bench, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "sub" / "extra.json"
    out.parent.mkdir()
    monkeypatch.setenv("GWEN_BENCH_KERNEL", "sdense")
    _, extra, _ = _run(capsys, "--extra-out", str(out))
    assert out.read_text().endswith("\n")
    assert json.loads(out.read_text()) == extra
    assert sorted(p.name for p in tmp_path.rglob("*.json")) == ["extra.json"]


def test_bench_needs_cuda_or_says_so(small_bench, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli(["bench"])
