"""The comparison that decides ``correct``, on the CPU at L3 with small
batches (the kernels' plain versions stand for the kernels there):

* in float32 the program and the plain reference agree to rounding, so
  the reference computes what the program does;
* the program in bf16, as the configurations state, reads inside each
  cell's limits, and the control (the reference computed in float8 in the
  program's place) fails one of them;
* a run with a fault planted under the timed path comes out not correct.
"""

import contextlib
import io

import pytest
import torch

from portbench import faults
from portbench.control import readings
from portbench.harness import ROOT, run_cell
from portbench.spec import Spec

CPU = torch.device("cpu")
L3 = {"graph": {"refine": 3}}
SMALL = {"batch": 4, "checked_steps": 3, "warmup_steps": 3, "members_cycle": [4],
         "sample_from": 3, "checked_requests": 2}
CELLS = [w["name"] for w in Spec.load(ROOT).bench["workloads"]]
GCN = ["gcn_train_b21", "gcn_ensemble_k4-16"]


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_computes_what_the_program_does(cell):
    out, _ = run_cell(cell, 2**31 + 7, 2.0, False, CPU,
                      config_overrides={**L3, "model": {"compute_dtype": "float32"}},
                      traffic_overrides={**SMALL, "batch": 2, "members_cycle": [2],
                                         "sample_from": 1, "checked_requests": 1})
    for name, c in out["checks"].items():
        assert c["value"] < 2e-5, (name, c)


@pytest.mark.parametrize("cell", GCN)
def test_program_passes_and_the_control_fails(cell):
    limits = Spec.load(ROOT).limits(cell)
    seeds = [3, 2**32 + 5]
    for row in quiet(readings, cell, seeds, "program", 2.0, CPU, L3, SMALL):
        assert all(row[k] <= limits[k] for k in limits), row
    for row in quiet(readings, cell, seeds, "control", 2.0, CPU, L3, SMALL):
        assert any(row[k] > limits[k] for k in limits), row


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", GCN)
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.FAULTS[fault]():
        out, _ = run_cell(cell, 11, 2.0, False, CPU, config_overrides=L3,
                          traffic_overrides=SMALL)
    assert out["correct"] is False, out["checks"]
