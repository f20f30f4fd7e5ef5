"""Faults planted in the GenCast program, for the readings its limits are
set from (``limits/gencast_train_b1.json``), beside ``faults.py``'s:

* ``truncated``: every neighbour list loses its outermost ring (the lists
  of ``k_hop − 1`` hops stand for the ``k_hop`` lists);
* ``last_source``: every neighbour list loses its last source;
* ``sigma_fixed``: the model's noise conditioning sees σ = 1 whatever the
  task drew (the preconditioning and the loss keep the drawn σ).

    python3 -m portbench.gencast_faults --fault truncated --seeds 201,202

runs ``control.readings`` in its ``program`` mode with the fault planted,
on the card: one JSON line a seed, then one with each number's smallest
reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from portbench import control, gencast_port
from portbench.faults import _patch


@contextlib.contextmanager
def truncated():
    from gwen_tpu_torch.graph import graph

    lists = graph.khop_lists

    def fewer(senders, receivers, num_nodes, hops, device="cpu"):
        return lists(senders, receivers, num_nodes, hops - 1, device)

    gencast_port._GRAPHS.clear()
    with _patch(graph, "khop_lists", fewer):
        yield
    gencast_port._GRAPHS.clear()


@contextlib.contextmanager
def last_source():
    from gwen_tpu_torch.graph import graph

    lists = graph.khop_lists

    def short(senders, receivers, num_nodes, hops, device="cpu"):
        out = lists(senders, receivers, num_nodes, hops, device)
        last = (out >= 0).sum(1) - 1
        out[torch.arange(len(out), device=out.device), last] = -1
        return out

    gencast_port._GRAPHS.clear()
    with _patch(graph, "khop_lists", short):
        yield
    gencast_port._GRAPHS.clear()


@contextlib.contextmanager
def sigma_fixed():
    from gwen_tpu_torch.nn.gencast import GenCast

    condition = GenCast.condition

    def fixed(self, sigma):
        return condition(self, torch.ones_like(sigma))

    with _patch(GenCast, "condition", fixed):
        yield


FAULTS = {"truncated": truncated, "last_source": last_source, "sigma_fixed": sigma_fixed}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.gencast_faults")
    ap.add_argument("--fault", required=True, choices=list(FAULTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--workload", default="gencast_train_b1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.gencast_faults: no CUDA device", file=sys.stderr)
        return 2
    with FAULTS[args.fault]():
        rows = control.readings(args.workload, [int(s) for s in args.seeds.split(",")],
                                "program", 0.1, torch.device("cuda", 0))
    keys = [k for k in rows[0] if k not in ("seed", "mode")]
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "min": {k: min(r[k] for r in rows) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
