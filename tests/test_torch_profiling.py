"""The port's profiling, version and logging modules and the reference's
last public names against the reference package on the CPU.

``gwen_tpu_torch`` re-exports the reference's ``__all__``; ``setup_logger``
is a singleton whose handlers live on rank 0 only (console and
``logfile.log``, with the reference's levels and format; a ``NullHandler``
with ``RANK=1``); ``suppress_warnings`` adds the reference's matplotlib
filters; ``count_params`` counts converted GCN, attention and UNet
parameters as the reference does; ``native.bandwidth`` agrees with the
reference's native and Python bandwidth; ``mesh_loss_fn`` gives the
reference's loss, predictions and gradients (float32, ``rtol = atol =
1e-4``) and, on a rank's partitioned apply, the partitioned task's; the
profiling functions return the reference's keys, ``trace`` writes its file
under the directory given and ``start_server`` refuses. The card's timers
run on the card only (``chip_smoke.py``); here their arithmetic is held
on stand-in device events.
"""

import logging
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu
import gwen_tpu.graph as J
import gwen_tpu.logging_utils as j_logging
import gwen_tpu.native as j_native
import gwen_tpu.profiling as j_profiling
import gwen_tpu_torch
import gwen_tpu_torch.graph as P
from gwen_tpu.nn import EncodeProcessDecode as JEPD
from gwen_tpu.nn import unet as j_unet
from gwen_tpu.nn.core import count_params as j_count_params
from gwen_tpu.train.tasks import mesh_loss_fn as j_mesh_loss_fn
from gwen_tpu_torch import logging_utils, native, profiling
from gwen_tpu_torch.nn import EncodeProcessDecode, params_from_jax
from gwen_tpu_torch.nn.core import count_params
from gwen_tpu_torch.nn.unet import UNet
from gwen_tpu_torch.parallel import make_partitioned_apply, partition_graph
from gwen_tpu_torch.train import (
    make_mesh,
    mesh_loss_fn,
    partitioned_mesh_loss_fn,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ version, names


def test_package_exports_the_references_names():
    assert gwen_tpu_torch.__all__ == gwen_tpu.__all__
    assert gwen_tpu_torch.__version__ == gwen_tpu.__version__
    assert gwen_tpu_torch.__author__ == gwen_tpu.__author__
    for name in gwen_tpu_torch.__all__:
        assert getattr(gwen_tpu_torch, name) is not None
    assert (gwen_tpu_torch.GwenConfig().train.batch_size
            == gwen_tpu.GwenConfig().train.batch_size)
    assert gwen_tpu_torch.get_logger().name == "gwen_tpu_torch"


# ------------------------------------------------------------------ logging


@pytest.fixture
def fresh_loggers(monkeypatch, tmp_path):
    """Both packages' loggers without handlers, in ``tmp_path``; their
    handlers as they were afterwards."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("RANK", raising=False)
    saved = {}
    for name in ("gwen_tpu", "gwen_tpu_torch"):
        logger = logging.getLogger(name)
        saved[name] = (list(logger.handlers), logger.level, logger.propagate)
        logger.handlers.clear()
    yield tmp_path
    for name, (handlers, level, propagate) in saved.items():
        logger = logging.getLogger(name)
        for handler in logger.handlers:
            handler.close()
        logger.handlers[:] = handlers
        logger.setLevel(level)
        logger.propagate = propagate


def _handlers(logger):
    return [(type(h).__name__, h.level, getattr(h.formatter, "_fmt", None))
            for h in logger.handlers]


def test_setup_logger_rank0_handlers_match_the_reference(fresh_loggers):
    log = logging_utils.setup_logger()
    j_log = j_logging.setup_logger()
    assert _handlers(log) == _handlers(j_log) == [
        ("StreamHandler", logging.DEBUG,
         "%(asctime)s %(levelname)-7s %(name)s: %(message)s"),
        ("FileHandler", logging.INFO,
         "%(asctime)s %(levelname)-7s %(name)s: %(message)s")]
    assert log.level == j_log.level == logging.DEBUG and not log.propagate
    # A singleton: a second call adds nothing; ``force`` rebuilds.
    assert logging_utils.setup_logger() is log and len(log.handlers) == 2
    assert logging_utils.get_logger() is log
    log.info("an info line")
    log.debug("a debug line")
    for h in log.handlers:
        h.flush()
    text = (fresh_loggers / "logfile.log").read_text()
    assert "an info line" in text and "a debug line" not in text
    other = fresh_loggers / "other.log"
    logging_utils.setup_logger(log_file=other, force=True)
    assert len(log.handlers) == 2
    log.info("elsewhere")
    log.handlers[1].flush()
    assert "elsewhere" in other.read_text()


def test_setup_logger_gives_other_ranks_a_null_handler(fresh_loggers, monkeypatch):
    monkeypatch.setenv("RANK", "1")
    log = logging_utils.setup_logger()
    assert _handlers(log) == [("NullHandler", logging.NOTSET, None)]
    assert not (fresh_loggers / "logfile.log").exists()
    # An unwritable log file leaves rank 0 its console.
    monkeypatch.setenv("RANK", "0")
    logging_utils.setup_logger(log_file=fresh_loggers / "no" / "such" / "dir.log",
                               force=True)
    assert [name for name, _, _ in _handlers(log)] == ["StreamHandler"]


def test_suppress_warnings_adds_the_references_matplotlib_filters():
    with warnings.catch_warnings():
        warnings.resetwarnings()
        logging_utils.suppress_warnings()
        ours = list(warnings.filters)
    with warnings.catch_warnings():
        warnings.resetwarnings()
        j_logging.suppress_warnings()
        theirs = [f for f in warnings.filters
                  if "jax" not in getattr(f[3], "pattern", "")]
    assert ours == theirs and len(ours) == 2
    assert {f[2] for f in ours} == {DeprecationWarning, UserWarning}


# ------------------------------------------------------------ count_params


@pytest.mark.parametrize("family", ["gcn", "attention", "unet"])
def test_count_params_matches_the_reference(family):
    if family == "unet":
        jm = j_unet.UNet(channels_in=5, channels_out=2, hidden=12, depth=3)
        pm = UNet(5, 2, device="cpu", hidden=12, depth=3)
    else:
        jm = JEPD(channels_in=3, channels_out=2, latent_size=16,
                  process_steps=2, processor=family, attn_heads=2)
        pm = EncodeProcessDecode(3, 2, device="cpu", latent_size=16,
                                 process_steps=2, processor=family, attn_heads=2)
    params = jm.init(jax.random.key(1))
    pm.load_state_dict(params_from_jax(_np_tree(params)))
    want = j_count_params(params)
    assert want > 0
    assert count_params(pm) == count_params(pm.state_dict()) == want


# --------------------------------------------------------------- bandwidth


def test_native_bandwidth_matches_the_reference():
    _, s, r = J.icosphere_edges(3)
    rng = np.random.default_rng(0)
    perm = rng.permutation(int(max(s.max(), r.max())) + 1)
    s, r = perm[s], perm[r]
    want = J.reorder.bandwidth(s, r)
    assert native.bandwidth(s, r) == j_native.bandwidth(s, r) == want
    assert P.reorder.bandwidth(s, r) == want
    empty = np.zeros(0, np.int64)
    assert native.bandwidth(empty, empty) == j_native.bandwidth(empty, empty) == 0
    with pytest.raises(ValueError, match="differ in length"):
        native.bandwidth(s, r[:-1])


def test_native_bandwidth_is_none_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.bandwidth(np.arange(3), np.arange(3)) is None


# ------------------------------------------------------------ mesh_loss_fn


@pytest.fixture(scope="module")
def mesh_task():
    verts, s, r = J.icosphere_edges(2)
    n = verts.shape[0]
    jm = JEPD(channels_in=2, channels_out=2, latent_size=16, process_steps=2,
              backend="segment")
    params = jm.init(jax.random.key(0))
    pm = EncodeProcessDecode(2, 2, device="cpu", latent_size=16, process_steps=2,
                             compute_dtype=torch.float32)
    pm.load_state_dict(params_from_jax(_np_tree(params)))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, n, 2)).astype(np.float32)
    y = (0.8 * x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    return dict(s=s, r=r, n=n, jg=J.build_graph(s, r, n), pg=P.build_graph(s, r, n),
                jm=jm, params=params, pm=pm, x=x, y=y)


@pytest.mark.parametrize("loss", ["mse", "l1"])
def test_mesh_loss_fn_matches_the_reference(mesh_task, loss):
    t = mesh_task
    j_fn = j_mesh_loss_fn(lambda p, x: t["jm"].apply(p, t["jg"], x), loss)
    (j_val, j_preds), j_grads = jax.value_and_grad(j_fn, has_aux=True)(
        t["params"], (jnp.asarray(t["x"]), jnp.asarray(t["y"])))
    pm = t["pm"]
    pm.zero_grad(set_to_none=True)
    val, preds = mesh_loss_fn(lambda x: pm(t["pg"], x), loss)(
        (torch.from_numpy(t["x"]), torch.from_numpy(t["y"])))
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), **TOL)
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(j_preds), **TOL)
    want = params_from_jax(_np_tree(j_grads))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-3,
                                   atol=1e-6, err_msg=name)


def test_mesh_loss_fn_refuses_an_unknown_loss(mesh_task):
    # The reference refuses when the task runs, the port when it is made.
    batch = (jnp.zeros((1, 2)), jnp.zeros((1, 2)))
    with pytest.raises(ValueError, match="unknown mesh loss"):
        j_mesh_loss_fn(lambda p, x: x, "crps")(None, batch)
    with pytest.raises(ValueError, match="unknown mesh loss"):
        mesh_loss_fn(lambda x: x, "crps")


def test_mesh_loss_fn_takes_the_partitioned_rule_on_a_partitioned_apply(mesh_task):
    t = mesh_task
    pg = partition_graph(t["s"], t["r"], t["n"], num_parts=1, reorder=False,
                         block_size=32, layout="sliding")
    apply_fn = make_partitioned_apply(t["pm"], pg, make_mesh(), "cpu")
    batch = tuple(torch.from_numpy(pg.pad_nodes(a)) for a in (t["x"], t["y"]))
    got, got_preds = mesh_loss_fn(apply_fn, "l1")(batch)
    want, want_preds = partitioned_mesh_loss_fn(apply_fn, "l1")(batch)
    assert torch.equal(got, want) and torch.equal(got_preds, want_preds)
    with pytest.raises(ValueError, match="padded node space"):
        mesh_loss_fn(apply_fn)((torch.from_numpy(t["x"]), torch.from_numpy(t["y"])))


# --------------------------------------------------------------- profiling


def test_timers_return_the_references_keys():
    f = jax.jit(lambda a: a * 2.0)
    a = jnp.ones(4)
    want = j_profiling.timeit(f, a, iters=2)
    got = profiling.timeit(lambda v: v * 2.0, torch.ones(4), iters=2)
    assert sorted(got) == sorted(want) == ["iters", "mean_s"]
    assert got["iters"] == 2 and got["mean_s"] >= 0
    chained = profiling.timeit(lambda v: v + 1.0, torch.zeros(1), iters=3,
                               chain=lambda out: (out,))
    assert chained["iters"] == 3
    want = j_profiling.scan_timeit(lambda c: c + 1.0, jnp.zeros(2), iters=2,
                                   repeats=1)
    calls = []

    def body(c, step):
        calls.append(1)
        return c + step

    got = profiling.scan_timeit(body, torch.zeros(2), torch.ones(2), iters=2,
                                repeats=1)
    assert sorted(got) == sorted(want) and got["iters"] == 2
    # Warm-up N and 2N, then one repeat of N and 2N, each call chained.
    assert len(calls) == 12


def test_step_timer_stats_match_the_reference():
    ours = profiling.StepTimer(window=3, edges_per_step=10, items_per_step=4)
    theirs = j_profiling.StepTimer(window=3, edges_per_step=10, items_per_step=4)
    assert np.isnan(ours.mean_step_s)
    for _ in range(5):
        with ours:
            pass
        with theirs:
            pass
    assert len(ours.durations) == 3
    assert sorted(ours.stats()) == sorted(theirs.stats()) == [
        "edges_per_s", "items_per_s", "step_time_s", "steps_per_s"]
    assert sorted(profiling.StepTimer().stats()) == sorted(
        j_profiling.StepTimer().stats())
    with pytest.raises(RuntimeError):
        ours.__exit__(None, None, None)


def test_memory_stats_trace_annotate_and_server(tmp_path):
    want = j_profiling.device_memory_stats()
    got = profiling.device_memory_stats()
    assert [sorted(d) for d in got] == [sorted(want[0])]
    assert got == [{"device": "cpu", "bytes_in_use": None, "bytes_limit": None}]
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("gwen-span"):
            torch.ones(8).sum()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1 and "gwen-span" in files[0].read_text()
    with pytest.raises(NotImplementedError, match="trace"):
        profiling.start_server()


class _Event:
    def __init__(self, name, start, end):
        self.name = name
        self.time_range = types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start)


def test_profile_step_and_device_ms_on_stand_in_events(monkeypatch):
    # Two kernels that overlap (500-700 and 600-800) are busy once.
    events = [_Event("gemm", 0.0, 300.0), _Event("relu", 500.0, 700.0),
              _Event("fft", 600.0, 800.0), _Event("gemm", 900.0, 1000.0)]
    monkeypatch.setattr(profiling, "device_events", lambda fn, iters=1: events)
    got = profiling.profile_step(lambda: None)
    assert got["kernels_us"] == {"gemm": 400.0, "relu": 200.0, "fft": 200.0}
    assert got["busy_ms"] == pytest.approx(0.7) and got["span_ms"] == 1.0
    assert got["busy_share"] == pytest.approx(0.7)
    assert profiling.kernel_us(lambda: None) == got["kernels_us"]
    assert profiling.device_ms(lambda: None, iters=4, warmup=0) == pytest.approx(0.2)
    monkeypatch.setattr(profiling, "device_events", lambda fn, iters=1: [])
    assert np.isnan(profiling.profile_step(lambda: None)["busy_share"])
    with pytest.raises(AssertionError, match="no device kernel"):
        profiling.device_ms(lambda: None, warmup=0)
