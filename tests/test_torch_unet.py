"""The UNet family of the port against the reference package on the CPU.

``UNet`` (forward and the parameter gradients of the L1 loss), its pieces
(``conv_apply`` with XLA's ``"SAME"`` padding, ``group_norm_apply`` with a
group count below 8, ``max_pool``), ``ConvEnsembleDataset``,
``cnn_loss_fn`` and three ``Trainer.fit`` steps run in both packages from
the same numpy inputs and the same (converted) parameters; float32 at
``rtol = atol = 1e-4``. The bfloat16 forward is held at ``1.5e-2 ·
max|reference|``: both packages round every conv, pool and upsampling
output to bfloat16 (8 bits of mantissa) in their own summation order, and
the two differ from the float32 forward by about as much as from each
other. ``train-cnn --device cpu`` runs end to end on a store the test
writes; its weights come from a ``torch.Generator``, so its ``test_loss``
is held finite and the registry round trip (``train.retrain=false`` loads
the best model through the template and reproduces the test loss) to
work.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gwen_tpu.train as j_train
from gwen_tpu.data.dataset import ConvEnsembleDataset as JConvDataset
from gwen_tpu.nn import unet as j_unet
from gwen_tpu_torch.cli.main import main as cli
from gwen_tpu_torch.data import zarrstore
from gwen_tpu_torch.data.dataset import ConvEnsembleDataset
from gwen_tpu_torch.nn import params_from_jax, params_to_tree
from gwen_tpu_torch.nn import unet as p_unet
from gwen_tpu_torch.nn.unet import UNet
from gwen_tpu_torch.registry import Registry
from gwen_tpu_torch.train import Trainer, TrainState, cnn_loss_fn, make_optimizer

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 1.5e-2

# (channels_in, channels_out, hidden, depth, height, width): sizes that are
# and are not multiples of 2**depth; hidden 12 gives a width of 12, whose
# GroupNorm takes 6 groups.
SHAPES = [(4, 2, 8, 3, 13, 21), (3, 1, 16, 2, 16, 16), (5, 3, 12, 4, 17, 33)]
IDS = ["odd-d3", "multiple-d2", "groups6-d4"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(cin, cout, hidden, depth, seed=0, dtype=torch.float32):
    jm = j_unet.UNet(channels_in=cin, channels_out=cout, hidden=hidden,
                     depth=depth)
    params = jm.init(jax.random.key(seed))
    pm = UNet(cin, cout, device="cpu", hidden=hidden, depth=depth,
              compute_dtype=dtype)
    pm.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    return jm, params, pm


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("cin,cout,hidden,depth,h,w", SHAPES, ids=IDS)
def test_unet_forward_and_gradients_match_reference(cin, cout, hidden, depth, h, w):
    jm, params, pm = _models(cin, cout, hidden, depth)
    x = _x((2, cin, h, w))
    y = _x((2, cout, h, w), 1)

    def j_loss(p):
        out = jm.apply(p, jnp.asarray(x))
        return jnp.mean(jnp.abs(out - jnp.asarray(y))), out

    (j_val, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(params)
    out = pm(torch.from_numpy(x))
    assert out.shape == (2, cout, h, w) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    val = torch.mean(torch.abs(out - torch.from_numpy(y)))
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5)
    want = params_from_jax(_np_tree(j_grads))
    assert sorted(want) == sorted(n for n, _ in pm.named_parameters())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("cin,cout,hidden,depth,h,w", SHAPES, ids=IDS)
def test_unet_bf16_forward_matches_reference(cin, cout, hidden, depth, h, w):
    jm, params, _ = _models(cin, cout, hidden, depth)
    jb = j_unet.UNet(channels_in=cin, channels_out=cout, hidden=hidden,
                     depth=depth, compute_dtype=jnp.bfloat16)
    pb = UNet(cin, cout, device="cpu", hidden=hidden, depth=depth,
              compute_dtype=torch.bfloat16)
    pb.load_state_dict(params_from_jax(_np_tree(params)))
    x = _x((2, cin, h, w))
    want = np.asarray(jb.apply(params, jnp.asarray(x)))
    got = pb(torch.from_numpy(x))
    assert got.dtype == torch.float32  # back in the input's dtype
    scale = np.abs(np.asarray(jm.apply(params, jnp.asarray(x)))).max()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=BF16_REL * scale)


def test_unet_parameters_and_seeded_init():
    jm = j_unet.UNet(channels_in=124, channels_out=1)
    tree = jax.eval_shape(jm.init, jax.random.key(0))
    pm = UNet(124, 1, device="cpu", generator=torch.Generator().manual_seed(3))
    want = params_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), tree))
    state = pm.state_dict()
    assert pm.widths == [64, 128, 256, 512]
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert sum(v.numel() for v in state.values()) == sum(
        v.numel() for v in want.values()) > 4.7e6
    again = UNet(124, 1, device="cpu",
                 generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(state[k], again[k]) for k in state)
    # He-normal convs, zero biases, unit norms.
    w = state["dec_0.conv.w"]
    assert abs(w.std().item() / (2.0 / (w.shape[1] * 9)) ** 0.5 - 1) < 0.01
    assert not state["enc_0.conv.b"].any() and (state["enc_3.norm.scale"] == 1).all()


@pytest.mark.parametrize("stride,k,c_in,c_out,h,w", [
    (1, 3, 3, 5, 7, 9), (2, 3, 3, 5, 7, 9), (2, 3, 2, 4, 8, 6), (1, 1, 4, 2, 5, 5)],
    ids=["s1k3", "s2k3-odd", "s2k3-even", "s1k1"])
def test_conv_apply_same_padding_matches_reference(stride, k, c_in, c_out, h, w):
    p = j_unet.conv_init(jax.random.key(1), c_in, c_out, k=k)
    p["b"] = jnp.arange(c_out, dtype=jnp.float32) * 0.1
    x = _x((2, c_in, h, w))
    want = np.asarray(j_unet.conv_apply(p, jnp.asarray(x), stride=stride))
    got = p_unet.conv_apply(params_from_jax(_np_tree(p)), torch.from_numpy(x),
                            stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c", [3, 6, 12, 16, 20])
def test_group_norm_and_max_pool_match_reference(c):
    # Groups: 3, 6, 6, 8, 5 (min(8, c) lowered until it divides c).
    rng = np.random.default_rng(c)
    p = {"scale": rng.normal(size=c).astype(np.float32),
         "bias": rng.normal(size=c).astype(np.float32)}
    x = (3 + 2 * _x((2, c, 6, 10), c)).astype(np.float32)
    want = np.asarray(j_unet.group_norm_apply(p, jnp.asarray(x)))
    got = p_unet.group_norm_apply(params_from_jax(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        p_unet.max_pool(torch.from_numpy(x)).numpy(),
        np.asarray(j_unet.max_pool(jnp.asarray(x))))


# ------------------------------------------------------------- dataset, loss

# 8 x 10 fields: depth 2 pads them to 8 x 12, a 2 x 3 bottleneck. At 4 x 10
# (a 1 x 3 bottleneck) whole channels die under the ReLU; their gradient
# is exactly 0 in one package and rounding noise (1e-9) in the other, and
# Adam's first step turns that noise into a full step of the learning rate,
# so three fit steps would hold the optimizer's conditioning, not the port.
T, M, H, C = 9, 6, 8, 10


@pytest.mark.parametrize("simplify", [False, True], ids=["split", "simplify"])
def test_conv_dataset_matches_reference(simplify):
    data = _x((T, M, H, C), 4)
    ds = ConvEnsembleDataset(data=data, member_split=4, seed=7, simplify=simplify)
    j_ds = JConvDataset(data=data, member_split=4, seed=7, simplify=simplify)
    np.testing.assert_array_equal(ds.input_indices, j_ds.input_indices)
    np.testing.assert_array_equal(ds.target_indices, j_ds.target_indices)
    assert len(ds) == len(j_ds) == T
    assert len(ds.input_indices) == (1 if simplify else 4)
    for a, b in zip(ds[3], j_ds[3]):
        np.testing.assert_array_equal(a, b)
    for shuffle in (False, True):
        got = list(ds.batches(2, shuffle=shuffle, seed=5))
        want = list(j_ds.batches(2, shuffle=shuffle, seed=5))
        assert len(got) == len(want) == 4  # the last partial batch dropped
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("loss,masked", [("l1", False), ("mse", False),
                                         ("l1", True), ("mse", True)],
                         ids=["l1", "mse", "l1-mask", "mse-mask"])
def test_cnn_loss_value_and_gradients_match_reference(loss, masked):
    jm, params, pm = _models(3, 2, 8, 2)
    mask = (np.random.default_rng(2).random((H, C)) > 0.4).astype(np.float32) \
        if masked else None
    x, y = _x((2, 3, H, C), 5), _x((2, 2, H, C), 6)
    j_fn = j_train.cnn_loss_fn(jm, loss=loss,
                               spatial_mask=None if mask is None else jnp.asarray(mask))
    (j_val, j_preds), j_grads = jax.value_and_grad(j_fn, has_aux=True)(
        params, (jnp.asarray(x), jnp.asarray(y)))
    val, preds = cnn_loss_fn(pm, loss=loss, spatial_mask=mask)(
        (torch.from_numpy(x), torch.from_numpy(y)))
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(j_preds), **TOL)
    want = params_from_jax(_np_tree(j_grads))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_cnn_loss_refuses_unknown_loss():
    with pytest.raises(ValueError, match="unknown CNN loss"):
        cnn_loss_fn(UNet(2, 1, device="cpu", hidden=4, depth=1), loss="crps")


def test_three_fit_steps_match_reference_trainer():
    jm, params, pm = _models(3, 1, 8, 2)
    data = _x((6, 4, H, C), 8)
    ds = ConvEnsembleDataset(data=data, member_split=3, seed=1)

    def batches(ep):
        return ds.batches(2, shuffle=True, seed=ep)

    opt = optax.adam(1e-2)
    j_tr = j_train.Trainer(loss_fn=j_train.cnn_loss_fn(jm), optimizer=opt,
                           log_every=0)
    # The reference's step donates its state: train on a copy.
    start = jax.tree_util.tree_map(jnp.array, params)
    j_state, j_best = j_tr.fit(j_train.TrainState.create(start, opt), batches,
                               epochs=1)
    tr = Trainer(cnn_loss_fn(pm), "cpu", log_every=0)
    state, best = tr.fit(TrainState(pm, make_optimizer(pm.parameters(), 1e-2)),
                         batches, epochs=1)
    assert state.step == int(j_state.step) == 3
    np.testing.assert_allclose(best, j_best, rtol=1e-4)
    # The decoders' conv biases feed a GroupNorm of one channel a group
    # (8 channels, 8 groups), which removes them: the loss does not depend
    # on them, their gradient is rounding noise in both packages, and Adam
    # moves them by up to the learning rate either way. Held: that their
    # gradient is noise, and that they move no more than the steps taken.
    free = {"dec_0.conv.b", "dec_1.conv.b"}
    x0, y0 = next(iter(batches(0)))
    g0 = jax.grad(lambda q: j_train.cnn_loss_fn(jm)(q, (x0, y0))[0])(params)
    g0 = params_from_jax(_np_tree(g0))
    assert all(g0[k].abs().max() < 1e-6 for k in free)
    want = params_from_jax(_np_tree(j_state.params))
    for name, p in pm.named_parameters():
        # Three Adam steps of 1e-2: an entry whose gradient is ~0 may move
        # the other way in one package, so hold the bulk tightly and every
        # entry to within the steps taken.
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 3.1e-2, name
        assert name in free or np.median(diff) <= 1e-5, name
    loss, preds = tr.evaluate(pm, ds.batches(1))
    j_loss, j_preds = j_tr.evaluate(
        jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()),
                               params_to_tree(dict(pm.named_parameters()))),
        ds.batches(1))
    assert preds.shape == j_preds.shape == (6, 1, H, C)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-4)
    np.testing.assert_allclose(preds, j_preds, **TOL)


# ----------------------------------------------------------------- train-cnn


@pytest.fixture
def preprocessed(tmp_path, capsys):
    """A raw (time, member, height, ncells) store of 5 members, written
    here, and the config that preprocesses it into train and test
    stores."""
    t_len, members = 12, 5
    tt = np.arange(t_len, dtype=np.float32)[:, None, None, None]
    mm = np.arange(members, dtype=np.float32)[None, :, None, None]
    hh = np.arange(H, dtype=np.float32)[None, None, :, None]
    cc = np.arange(C, dtype=np.float32)[None, None, None, :]
    raw = (280 + 5 * np.sin(0.3 * tt + 0.2 * mm) * np.cos(0.5 * hh + 0.1 * cc)
           ).astype(np.float32)
    arr = zarrstore.create(tmp_path / "raw.zarr", raw.shape,
                           ("time", "member", "height", "ncells"),
                           chunks=(4, 1, H, C),
                           meta={"members": [f"{-m}.0_3000.0_2000.0"
                                             for m in range(members)]})
    arr.write(..., raw)
    cfg = {"data": {"zarr_path": str(tmp_path / "raw.zarr"),
                    "data_train": str(tmp_path / "train.zarr"),
                    "data_test": str(tmp_path / "test.zarr"),
                    "scaling_path": str(tmp_path / "scaling.json"),
                    "boundary_cells": 0},
           "unet": {"hidden": 8, "depth": 2},
           "train": {"member_split": 4, "batch_size": 2, "epochs": 2,
                     "lr": 1e-4},
           "run": {"registry_root": str(tmp_path / "runs")}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    assert cli(["preprocess", "--config", str(tmp_path / "cfg.json")]) == 0
    capsys.readouterr()
    return tmp_path, str(tmp_path / "cfg.json")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_cnn_end_to_end_and_registry_round_trip(preprocessed, capsys):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    wd, cfg = preprocessed
    assert cli(["train-cnn", "--config", cfg, "--out-dir", str(wd / "output"),
                "--device", "cpu"]) == 0
    out = _last_json(capsys)
    assert np.isfinite(out["test_loss"]) and np.isfinite(out["best_train_loss"])
    assert out["device"] == "cpu" and len(out["animations"]) == 1
    run = Registry(wd / "runs").get_runs("GWEN_CNN")[0]
    assert run.run_id == out["run_id"] and run.meta["status"] == "FINISHED"
    assert len(run.metrics("loss")) == 2
    params, md = run.load_model()
    assert md == {"hidden": 8, "depth": 2, "channels_in": 4, "channels_out": 1}
    assert tuple(params["enc_0.conv.w"].shape) == (8, 4, 3, 3)
    assert run.environment()["packages"]["torch"] == torch.__version__
    # retrain=false: the registry's best model through the template,
    # evaluated, no training.
    assert cli(["train-cnn", "--config", cfg, "--no-animate", "--device", "cpu",
                "train.retrain=false"]) == 0
    again = _last_json(capsys)
    assert again["test_loss"] == out["test_loss"] and "animations" not in again
    # The variance-mask branch, streaming from the store; simplify.
    assert cli(["train-cnn", "--config", cfg, "--no-animate", "--device", "cpu",
                "train.mask_threshold=0.01", "data.lazy=true",
                "train.simplify=true", "run.experiment=MASKED"]) == 0
    assert np.isfinite(_last_json(capsys)["test_loss"])
    assert Registry(wd / "runs").get_runs("MASKED_CNN")[0].load_model()[1][
        "channels_in"] == 1
    # A template of other widths is refused, naming the key.
    with pytest.raises(ValueError, match="'enc_0.conv.[wb]' is stored with shape"):
        cli(["train-cnn", "--config", cfg, "--no-animate", "--device", "cpu",
             "train.retrain=false", "unet.hidden=4"])


def test_train_cnn_needs_cuda_or_says_so(preprocessed, monkeypatch):
    _, cfg = preprocessed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli(["train-cnn", "--config", cfg, "--no-animate"])
