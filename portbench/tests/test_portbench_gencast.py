"""The GenCast cell on the CPU at a tiny size (a 10° grid, M2, 2 hops,
latent 32, 2 transformer layers of 4 heads, 10 inputs, 4 outputs) in
float32: the program agrees with the plain reference and runs
``correct``, a planted fault is not correct, the roofline counts the
published model and the program's pair counter, and a run leaves every
file of the benchmark as it was; so do cut neighbour lists and a noise
conditioning held fixed. The cell's limits are set for bf16 at its own
size (``limits/gencast_train_b1.json``)."""

import hashlib

import pytest
import torch

from portbench import faults, gencast_faults, gencast_port
from portbench.harness import ROOT, run_cell
from portbench.reference import gencast as ref
from portbench.roofline import gencast as work
from portbench.roofline.epd import useful_flops
from portbench.spec import Spec

CPU = torch.device("cpu")
CELL = "gencast_train_b1"
TINY = {"graph": {"grid_lat": 19, "grid_lon": 36, "refine": 2, "k_hop": 2},
        "model": {"channels_in": 10, "channels_out": 4, "latent_size": 32, "process_steps": 2,
                  "ffn_size": 64},
        "loss": {"levels_hpa": [500, 850], "atmospheric": 1, "surface_weights": [1.0, 0.1]}}


def tiny(**model) -> dict:
    return {**TINY, "model": {**TINY["model"], **model}}


def digest() -> dict:
    here = ROOT / "portbench"
    return {p.relative_to(here): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(here.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_float32_agrees_and_is_correct():
    """The gaps to 2e-5; ``grad_diff_ratio`` (the program's median leaf
    difference over the bf16 witness's) to 1e-3: float32 sums in another
    order, which the CPU's threads also vary from run to run (2.0e-5 to
    2.2e-5 read), against bf16's rounding."""
    before = digest()
    out, _ = run_cell(CELL, 2**31 + 11, 1.0, False, CPU,
                      config_overrides=tiny(compute_dtype="float32"))
    for name, c in out["checks"].items():
        assert c["value"] < (1e-3 if name == "grad_diff_ratio" else 2e-5), (name, c)
    assert out["correct"] and out["metrics"]["train_samples_per_s"]["value"] > 0
    assert digest() == before


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_planted_fault_is_not_correct(fault):
    with faults.FAULTS[fault]():
        out, _ = run_cell(CELL, 19, 0.5, False, CPU,
                          config_overrides=tiny(compute_dtype="float32"))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", ["truncated", "last_source", "sigma_fixed"])
def test_gencast_faults_are_not_correct(fault):
    """Neighbour lists cut (their outer ring, or one source a row) and the
    noise conditioning held at σ = 1 (``gencast_faults.py``)."""
    with gencast_faults.FAULTS[fault]():
        out, _ = run_cell(CELL, 23, 0.5, False, CPU,
                          config_overrides=tiny(compute_dtype="float32"))
    assert out["correct"] is False, out["checks"]


def test_the_pair_counter_is_the_roofline_count():
    spec = Spec.load(ROOT)
    cfg = spec.config("gencast_0p25", tiny(compute_dtype="float32"))
    mix = spec.traffic("gencast_train_b1")
    driver = spec.driver(mix["driver"])(cfg, mix, CPU)
    before = gencast_port.attn_pairs()
    driver.start(5, None)
    steps = max(mix["warmup_steps"], mix["checked_steps"])
    got = (gencast_port.attn_pairs() - before) / steps
    assert got == work.attn_pairs(cfg["model"], driver.sizes, mix["batch"]) > 0


def test_the_norm_count_is_the_programs(monkeypatch):
    """The roofline's ``ln_fwd`` and ``ln_bwd`` ops are the program's B2
    and B2b calls of a step, one for one, with their bytes: each call's
    operands' own (float32 at the tiny size, the grid blocks recomputed)."""
    from gwen_tpu_torch.ops import fused_ln

    spec = Spec.load(ROOT)
    cfg = spec.config("gencast_0p25", tiny(compute_dtype="float32"))
    mix = spec.traffic("gencast_train_b1")
    seen = {"ln_fwd": [], "ln_bwd": []}
    fwd, bwd = fused_ln.residual_layernorm_fwd, fused_ln.residual_layernorm_bwd

    def counted_fwd(m, h, scale, bias, eps=1e-6):
        seen["ln_fwd"].append((3 if h is not None else 2) * m.nbytes + scale.nbytes + bias.nbytes)
        return fwd(m, h, scale, bias, eps)

    def counted_bwd(m, g, scale, eps=1e-6):
        seen["ln_bwd"].append(3 * m.nbytes + scale.nbytes)
        return bwd(m, g, scale, eps)

    driver = spec.driver(mix["driver"])(cfg, mix, CPU)
    monkeypatch.setattr(fused_ln, "residual_layernorm_fwd", counted_fwd)
    monkeypatch.setattr(fused_ln, "residual_layernorm_bwd", counted_bwd)
    driver.start(5, None)
    steps = max(mix["warmup_steps"], mix["checked_steps"])
    ops = work.train_ops(cfg["model"], driver.sizes, mix["batch"])
    for family, got in seen.items():
        want = [op.bytes for op in ops if op.family == family]
        assert len(got) == steps * len(want) > 0
        assert sorted(got) == sorted(want * steps)


def test_published_counts():
    cfg = Spec.load(ROOT).config("gencast_0p25")
    m = cfg["model"]
    shapes = ref.param_shapes(m)
    total = sum(torch.Size(s).numel() for s in shapes.values())
    assert work.param_count(m) == total
    fwd = useful_flops(work.forward_ops(m, work.PROGRAM, 1))
    assert useful_flops(work.train_ops(m, work.PROGRAM, 1)) == pytest.approx(3 * fwd, rel=2e-3)
    attn = sum(op.flops for op in work.forward_ops(m, work.PROGRAM, 1) if op.family == "attn_fwd")
    assert attn == 16 * 4 * 33_280_722 * 512


def test_full_size_refuses_the_cpu():
    with pytest.raises(ValueError, match="runs on the card"):
        run_cell(CELL, 1, 0.5, False, CPU)
