"""Every cell at L3 on the card, with and without the trace: the kernels
run, the trace holds their launches and every per-layer metric reads.
Run there with ``python -m pytest portbench/tests -m card``."""

import pytest

from portbench.harness import ROOT, run_cell
from portbench.spec import Spec

SPEC = Spec.load(ROOT)
CELLS = [w["name"] for w in SPEC.bench["workloads"]]
SMALL = {"batch": 4, "members_cycle": [4], "sample_from": 2, "checked_requests": 1}


@pytest.mark.card
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_at_l3(card, cell, traced):
    out, notes = run_cell(cell, 2**33 + 1, 2.0, traced, card,
                          config_overrides={"graph": {"refine": 3}},
                          traffic_overrides=SMALL)
    assert out["correct"], (out["checks"], notes)
    want = SPEC.per_layer(cell) if traced else SPEC.end_to_end(cell)
    assert set(out["metrics"]) == {m["name"] for m in want}
    if traced:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
