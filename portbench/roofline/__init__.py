"""The benchmark's yardstick for work: the card's published peaks
(``peaks.json``) and the operations and bytes each operator of a model
needs, computed from shapes (one module per model family)."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

_PEAKS = Path(__file__).with_name("peaks.json")


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (as
    ``torch.cuda.get_device_name`` gives it). Raises ``KeyError`` for a
    card the table lacks: no share of a peak is reported against a guess."""
    return json.loads(_PEAKS.read_text())[kind]


@dataclass(frozen=True)
class Op:
    """One call of an operator: its family (``matmul``, ``agg``,
    ``attn_fwd``, ``attn_bwd``, ``ln_fwd``, ``ln_bwd``), its useful
    operations and its bytes."""

    family: str
    flops: float
    bytes: float
