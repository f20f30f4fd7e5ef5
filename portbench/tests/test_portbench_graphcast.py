"""The GraphCast cell on the CPU at a tiny size (a 10° grid, M0–M3, latent
32, 2 processor layers, 6 inputs, 4 outputs) in float32: the program
agrees with the plain reference and runs ``correct``, a planted fault is
not correct, the roofline counts the published model, and a run leaves
every file of the benchmark as it was. The cell's limits are set for bf16
at its own size (``limits/graphcast_train_b1.json``); at this size a
leaf holds few elements, its norm moves more with bf16's rounding, and
bf16 reads above them."""

import hashlib

import pytest
import torch

from portbench import faults
from portbench.harness import ROOT, run_cell
from portbench.reference import graphcast as ref
from portbench.roofline import graphcast as work
from portbench.roofline.epd import useful_flops
from portbench.spec import Spec

CPU = torch.device("cpu")
CELL = "graphcast_train_b1"
TINY = {"graph": {"grid_lat": 19, "grid_lon": 36, "refine": 3},
        "model": {"channels_in": 6, "channels_out": 4, "latent_size": 32, "process_steps": 2},
        "loss": {"levels_hpa": [500, 850], "atmospheric": 1, "surface_weights": [1.0, 0.1]}}


def tiny(**model) -> dict:
    return {**TINY, "model": {**TINY["model"], **model}}


def digest() -> dict:
    here = ROOT / "portbench"
    return {p.relative_to(here): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(here.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_float32_agrees_and_is_correct():
    before = digest()
    out, _ = run_cell(CELL, 2**31 + 9, 1.0, False, CPU,
                      config_overrides=tiny(compute_dtype="float32"))
    for name, c in out["checks"].items():
        assert c["value"] < 2e-5, (name, c)
    assert out["correct"] and out["metrics"]["train_samples_per_s"]["value"] > 0
    assert digest() == before


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_planted_fault_is_not_correct(fault):
    with faults.FAULTS[fault]():
        out, _ = run_cell(CELL, 17, 0.5, False, CPU,
                          config_overrides=tiny(compute_dtype="float32"))
    assert out["correct"] is False, out["checks"]


def test_published_counts():
    cfg = Spec.load(ROOT).config("graphcast_0p25")
    m = cfg["model"]
    shapes = ref.param_shapes(m)
    assert work.param_count(m) == sum(torch.Size(s).numel() for s in shapes.values()) == 35_580_643
    fwd = useful_flops(work.forward_ops(m, work.PUBLISHED, 1))
    assert fwd == pytest.approx(29.3e12, rel=0.01)
    assert useful_flops(work.train_ops(m, work.PUBLISHED, 1)) == pytest.approx(3 * fwd, rel=1e-3)


def test_full_size_refuses_the_cpu():
    with pytest.raises(ValueError, match="runs on the card"):
        run_cell(CELL, 1, 0.5, False, CPU)
