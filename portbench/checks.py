"""The comparison that decides ``correct``: the numbers compared, and
their limits (``limits/<workload>.json``, one file a cell).

A limit is set from two readings on the card at the cell's own size: the
largest that sound runs of the program give over a dozen seeds or more,
and the smallest that the control (the reference computed in a lower
precision, put in the program's place) or a planted fault gives. Each
file keeps those readings beside the limits.
"""

from __future__ import annotations

import math

import torch

# A leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone (a key's bias under softmax):
# its change is not compared.
STILL_LEAF = 1e-3


def _norms(tree: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_norm_gap(program: dict, reference: dict, moved: dict | None = None
                  ) -> float:
    """The worst leaf's ``|‖program‖ − ‖reference‖|`` over the larger of
    the reference's norm of that leaf and of the median leaf. With
    ``moved`` (the reference's first gradients), leaves whose gradient is
    under ``STILL_LEAF`` of the median leaf's are left out."""
    pn, rn = _norms(program), _norms(reference)
    keys = list(rn)
    if moved is not None:
        mn = _norms(moved)
        med = _median(list(mn.values()))
        keys = [k for k in keys if mn[k] >= STILL_LEAF * med]
    med = _median([rn[k] for k in keys])
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def median_leaf_diff(program: dict, reference: dict) -> float:
    """The median over leaves of ``‖program − reference‖`` over the larger
    of the reference's norm of that leaf and of the median leaf: steady
    from seed to seed, where the worst leaf swings with the rounding of
    one sensitive leaf."""
    rn = _norms(reference)
    med = _median(list(rn.values()))
    dn = _norms({k: program[k].double() - reference[k].double() for k in reference})
    return _median([dn[k] / max(rn[k], med, 1e-30) for k in rn])


def _median(values: list[float]) -> float:
    v = sorted(values)
    mid = len(v) // 2
    return v[mid] if len(v) % 2 else 0.5 * (v[mid - 1] + v[mid])


def judge(numbers: dict[str, float], lims: dict[str, float]) -> dict:
    """Each number beside its limit; a number that is not finite, or one
    the limits file lacks, fails."""
    out = {}
    for name, value in numbers.items():
        limit = lims.get(name)
        ok = limit is not None and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": ok}
    return out
