"""The inputs of every cell, drawn from ``--seed`` on the device in a few
large calls. Fields are in the icosphere's natural node order; a driver
hands the program its rows in the program's order.

Every seed gets the same sizes; only the values change. Amplitudes differ
from sample to sample, so a step that drops part of its batch changes its
loss by far more than rounding does.
"""

from __future__ import annotations

import math

import torch

MASK64 = (1 << 64) - 1


def mix(seed: int, *keys: int) -> int:
    """A 63-bit seed from ``seed`` and ``keys`` (splitmix64 rounds)."""
    z = seed & MASK64
    for k in keys:
        z = (z + 0x9E3779B97F4A7C15 + (k & MASK64)) & MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        z ^= z >> 31
    return z >> 1


def generator(seed: int, device: torch.device, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, 0x5EED, *keys))


def amplitudes(gen: torch.Generator, shape: tuple[int, ...], lo: float,
               hi: float) -> torch.Tensor:
    """Log-uniform in ``[lo, hi]``."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def train_pool(gen: torch.Generator, mix_cfg: dict, n: int, c: int
               ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``mix_cfg["pool"]`` distinct batches ``(x, y)``, each ``(B, N, C)``:
    ``x = a·z1`` and the next step ``y = a·(ρ z1 + sqrt(1 − ρ²) z2)`` with
    ``a`` per sample."""
    p, b = mix_cfg["pool"], mix_cfg["batch"]
    rho = mix_cfg["next_step_correlation"]
    z = torch.randn((p, 2, b, n, c), generator=gen, device=gen.device)
    a = amplitudes(gen, (p, b, 1, 1), *mix_cfg["amplitude"])
    x = a * z[:, 0]
    y = a * (rho * z[:, 0] + math.sqrt(1 - rho * rho) * z[:, 1])
    return [(x[i], y[i]) for i in range(p)]


def base_states(gen: torch.Generator, mix_cfg: dict, n: int, c: int
                ) -> torch.Tensor:
    """``(pool, N, C)`` base states of the ensemble requests."""
    p = mix_cfg["base_pool"]
    z = torch.randn((p, n, c), generator=gen, device=gen.device)
    return z * amplitudes(gen, (p, 1, 1), *mix_cfg["amplitude"])


def white_noise(gen: torch.Generator, seed: int, request: int, members: int,
                n: int, c: int) -> torch.Tensor:
    """The white noise of request ``request``: ``(members, N, C)``, drawn
    after reseeding ``gen`` from the seed and the request's index, so the
    check draws it again."""
    gen.manual_seed(mix(seed, 0x401E, request))
    return torch.randn((members, n, c), generator=gen, device=gen.device)
