"""The operations and bytes of the roofline functions, counted by hand at
L3 (642 nodes, 3,840 edges and 642 self loops), and the mesh size against
the reference's own icosphere."""

import json
from pathlib import Path

import pytest

from portbench.reference.mesh import build_mesh
from portbench.roofline import epd

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs" / "epd_gcn_l7.json").read_text())
GCN = CFG["model"]
ATTN = {**GCN, "processor": "attention"}
N, E = 642, 3840 + 642


def test_mesh_size_matches_the_reference_mesh():
    assert epd.mesh_size(3) == (N, E)
    mesh = build_mesh({**CFG["graph"], "refine": 3}, attention=False)
    assert (mesh.num_nodes, len(mesh.senders)) == (N, E)
    assert epd.mesh_size(7) == (163842, 1146882)


def families(ops):
    out = {}
    for op in ops:
        f = out.setdefault(op.family, [0, 0.0, 0.0])
        f[0] += 1
        f[1] += op.flops
        f[2] += op.bytes
    return out


def test_gcn_forward_at_l3():
    b = 2
    f = families(epd.forward_ops(GCN, 3, b))
    # encoder 1->256->256, 4 x (256x256), decoder 256->256->1
    assert f["matmul"][0] == 2 + 4 + 2
    assert f["matmul"][1] == 2 * N * b * (256 + 256 * 256 + 4 * 256 * 256 + 256 * 256 + 256)
    field = N * b * 256 * 2  # bf16
    assert f["agg"] == [4, 4 * 2 * E * b * 256, 4 * (2 * field + 6 * E)]
    assert f["ln_fwd"] == [4, 0.0, 4 * 3 * field]


def test_attention_train_at_l3():
    b = 3
    f = families(epd.train_ops(ATTN, 3, b))
    field = N * b * 256 * 2
    assert f["attn_fwd"] == [4, 4 * 4 * E * b * 256, 4 * (4 * field + 4 * E)]
    assert f["attn_bwd"] == [4, 4 * 8 * E * b * 256, 4 * (7 * field + 2 * 4 * E)]
    assert f["ln_bwd"] == [4, 0.0, 4 * 3 * field]
    fwd_mm = 2 * N * b * (256 + 256 * 256 + 4 * 4 * 256 * 256 + 256 * 256 + 256)
    assert f["matmul"][1] == pytest.approx(3 * fwd_mm)
    assert "agg" not in f


def test_ensemble_request_at_l3():
    k, t = 4, 2
    f = families(epd.request_ops(GCN, 3, k, t, smoothing=2))
    field = N * k * 256 * 2
    smooth = [2, 2 * 2 * E * k, 2 * (2 * N * k * 4 + 6 * E)]
    assert f["agg"][0] == smooth[0] + 4 * t
    assert f["agg"][1] == smooth[1] + 4 * t * 2 * E * k * 256
    assert f["agg"][2] == smooth[2] + 4 * t * (2 * field + 6 * E)
    assert epd.useful_flops(epd.request_ops(GCN, 3, k, t, 2)) == pytest.approx(
        f["matmul"][1] + f["agg"][1])


def test_l7_step_flops():
    """About 8.3 TFLOP a GCN train step and 24.7 an attention one at
    batch 21 (PERF.md)."""
    gcn = epd.useful_flops(epd.train_ops(GCN, 7, 21))
    attn = epd.useful_flops(epd.train_ops(ATTN, 7, 21))
    assert 8.0e12 < gcn < 8.4e12 and 24.0e12 < attn < 25.0e12
