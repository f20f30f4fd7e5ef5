"""The readings a cell's limits are set from, on the card at the cell's own
size, several seeds in one process (the program's graph built once):

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --mode program|control|unchanged|half_batch|altered [--seconds 8]

``program`` reads the check's numbers from sound runs of the program (a
training cell's first steps; an ensemble cell's sampled requests of a
short window at the cell's own load), ``control`` from the reference
computed in float8 e4m3 in the program's place (the precision below the
configuration's bf16), and the others from the program with a fault of
``faults.py`` planted under the timed path. One JSON line a seed on
standard output, then one with each number's largest and smallest
reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from portbench import faults, port
from portbench.harness import ROOT
from portbench.reference.epd import fp8_cast
from portbench.spec import Spec
from portbench.window import Recorder


def readings(workload: str, seeds: list[int], mode: str, seconds: float,
             device: torch.device, config_overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> list[dict]:
    spec = Spec.load(ROOT)
    cell = spec.workload(workload)
    cfg = spec.config(cell["config"], config_overrides)
    mix = spec.traffic(cell["traffic"], traffic_overrides)
    program = port.build_graph(cfg, device)
    out = []
    for seed in seeds:
        driver = spec.driver(mix["driver"])(cfg, mix, device)
        with faults.FAULTS[mode]() if mode in faults.FAULTS else contextlib.nullcontext():
            driver.start(seed, program)
            if mix["driver"] != "train" and mode != "control":
                driver.window(seconds, Recorder(False))
        driver.release()
        numbers = driver.check(fp8_cast if mode == "control" else None)
        out.append({"seed": seed, "mode": mode, **numbers})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True,
                    choices=["program", "control", *faults.FAULTS])
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.mode, args.seconds, torch.device("cuda", 0))
    keys = [k for k in rows[0] if k not in ("seed", "mode")]
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "max": {k: max(r[k] for r in rows) for k in keys},
                      "min": {k: min(r[k] for r in rows) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
