"""Serving: the reference's artifact, served by the reference and by the
port (CPU).

The artifact is exported by ``gwen_tpu.serve.export_model`` the way
``gwen-tpu export`` does off-TPU (RCM order, segment graph, the run's
hyperparameters in ``metadata``). The port ignores the JAX program and the
stored graph, rebuilds the diag-window graph in its own KD order and loads
the weights. Same ``.npy`` input, 3 steps, tolerance 1e-3 (LayerNorm and
three steps amplify the different summation orders).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gwen_tpu.graph as J
from gwen_tpu.cli.export_cli import predict_main as jax_predict
from gwen_tpu.nn import EncodeProcessDecode as JaxEPD
from gwen_tpu.serve import export_model as jax_export
from gwen_tpu_torch.cli.export_cli import predict_main
from gwen_tpu_torch.cli.main import main as cli
from gwen_tpu_torch.nn import EncodeProcessDecode
from gwen_tpu_torch.serve import ServingModel, export_model, pack_tree, unpack_tree

LEVELS, LATENT, STEPS, CH = 3, 128, 2, 2


def _run_meta(compute_dtype="float32"):
    # The keys train-mesh stores with a run (train_mesh.py run.save_model).
    return {"latent_size": LATENT, "process_steps": STEPS, "channels": CH,
            "levels": LEVELS, "processor": "gcn", "attn_heads": 2,
            "attn_pack": "auto", "residual": True, "mlp_layers": 2,
            "diag_window": 384, "compute_dtype": compute_dtype,
            "nodes": 642, "data": ""}


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    verts, s, r = J.icosphere_edges(LEVELS)
    n = verts.shape[0]
    perm = J.rcm_order(s, r, n)
    s2, r2, _ = J.apply_order(perm, s, r)
    model = JaxEPD(channels_in=CH, channels_out=CH, latent_size=LATENT,
                   process_steps=STEPS, backend="segment")
    params = model.init(jax.random.key(0))
    art = tmp / "art"
    jax_export(model, params, J.build_graph(s2, r2, n),
               np.zeros((n, CH), np.float32), art,
               metadata={**_run_meta(), "node_order": "rcm"})
    np.save(art / "node_perm.npy", np.asarray(perm, np.int64))
    x0 = np.random.default_rng(0).normal(size=(n, CH)).astype(np.float32)
    np.save(tmp / "x0.npy", x0)
    return tmp, art, params, n


def test_port_serves_reference_artifact(jax_artifact):
    tmp, art, _, n = jax_artifact
    jax_predict(str(art), str(tmp / "x0.npy"), 3, str(tmp / "want.npy"))
    res = predict_main(str(art), str(tmp / "x0.npy"), 3, str(tmp / "got.npy"),
                       device="cpu")
    assert res["shape"] == [3, n, CH]
    want, got = np.load(tmp / "want.npy"), np.load(tmp / "got.npy")
    assert got.shape == want.shape == (3, n, CH)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_cli_predict_and_cuda_default(jax_artifact, capsys):
    tmp, art, _, n = jax_artifact
    assert cli(["predict", "--artifact", str(art), "--input",
                str(tmp / "x0.npy"), "--steps", "2", "--out",
                str(tmp / "cli.npy"), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["shape"] == [2, n, CH] and out["device"] == "cpu"
    assert np.isfinite(np.load(tmp / "cli.npy")).all()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli(["predict", "--artifact", str(art), "--input",
             str(tmp / "x0.npy"), "--out", str(tmp / "none.npy")])


def test_port_export_round_trip(jax_artifact, tmp_path):
    tmp, art, params, n = jax_artifact
    sm = ServingModel.load(art, "cpu")
    path = export_model(sm.model, np.zeros((n, CH), np.float32),
                        tmp_path / "port_art", metadata=_run_meta())
    sm2 = ServingModel.load(path, "cpu")
    for (k, a), (k2, b) in zip(sm.model.state_dict().items(),
                               sm2.model.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(
        sm.model.state_dict()["process_1.gcn.w"].numpy(),
        np.asarray(params["process_1"]["gcn"]["w"]))
    x = torch.from_numpy(np.load(tmp / "x0.npy")[sm.node_perm])
    torch.testing.assert_close(sm.rollout(x, 2), sm2.rollout(x, 2))


def test_pack_tree_bf16_and_struct_leaves():
    import ml_dtypes

    leaves: list = []
    bf = torch.linspace(-2, 2, 7, dtype=torch.bfloat16)
    spec = pack_tree({"w": bf, "t": (1, None, [2.5, "x"])}, leaves)
    spec = json.loads(json.dumps(spec))
    back = unpack_tree(spec, leaves)
    assert back["t"] == (1, None, [2.5, "x"])
    torch.testing.assert_close(back["w"], bf, rtol=0, atol=0)
    # The reference stores ml_dtypes bfloat16 leaves the same way.
    ref = np.asarray(jnp.asarray(bf.float().numpy(), jnp.bfloat16))
    assert ref.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(leaves[spec["v"]["w"]["i"]],
                                  ref.view(np.uint16))
    assert unpack_tree({"k": "struct", "c": "Graph", "v": {}}, leaves) is None


@pytest.mark.parametrize("key,val,match", [
    ("processor", "interaction", "slice 4"),
    ("data", "mesh.zarr", "icosphere graphs only"),
])
def test_load_rejects_what_the_port_cannot_serve(tmp_path, key, val, match):
    model = EncodeProcessDecode(CH, CH, device="cpu", latent_size=32,
                                process_steps=1)
    path = export_model(model, np.zeros((642, CH), np.float32), tmp_path,
                        metadata={**_run_meta(), key: val})
    with pytest.raises(ValueError, match=match):
        ServingModel.load(path, "cpu")
