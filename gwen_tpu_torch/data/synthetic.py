"""Synthetic weather-like ensemble data on mesh graphs (the same numpy code
as ``gwen_tpu.data.synthetic``: one seed gives both packages the same
fields).

Generates Straka-density-current-flavored dynamics for tests and benchmarks:
an advection-diffusion process integrated on the mesh graph (diffusion via
the normalized graph Laplacian, advection via a fixed velocity rotation of the
sphere), with ensemble members differing by perturbed initial conditions —
the same structure as the reference's ICON "atmcirc-straka" ensemble
(SURVEY §6 dataset row) without needing ICON output.
"""

from __future__ import annotations

import numpy as np

from gwen_tpu_torch.graph.build import icosphere_edges


def gaussian_bump(verts: np.ndarray, center: np.ndarray, width: float) -> np.ndarray:
    d2 = np.sum((verts - center[None, :]) ** 2, axis=1)
    return np.exp(-d2 / (2 * width**2))


def mesh_ensemble_dataset(
    levels: int = 3,
    members: int = 4,
    steps: int = 16,
    channels: int = 1,
    diffusion: float = 0.25,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns ``(fields, verts, senders, receivers)`` with fields shaped
    ``(time, member, nodes, channels)``.

    Dynamics: cold bumps diffused over the mesh and rotated about the z axis;
    members perturb bump position/amplitude (ensemble-of-initial-conditions,
    like the reference's temp/height/width perturbations).
    """
    rng = np.random.default_rng(seed)
    verts, s, r = icosphere_edges(levels)
    n = verts.shape[0]

    # Symmetric-normalized adjacency for diffusion steps.
    deg = np.bincount(r, minlength=n).astype(np.float64) + 1.0
    w = 1.0 / np.sqrt(deg[s] * deg[r])

    def smooth(x: np.ndarray) -> np.ndarray:
        out = x / deg[:, None]
        np.add.at(out, r, w[:, None] * x[s])
        return out

    # Rotation about z by a fixed small angle per step (advection).
    theta = 2 * np.pi / (steps * 2)
    rot = np.array(
        [[np.cos(theta), -np.sin(theta), 0],
         [np.sin(theta), np.cos(theta), 0],
         [0, 0, 1]]
    )

    fields = np.zeros((steps, members, n, channels), np.float32)
    for m in range(members):
        center = np.array([1.0, 0.0, 0.3]) + 0.1 * rng.normal(size=3)
        center /= np.linalg.norm(center)
        amp = 1.0 + 0.2 * rng.normal()
        width = 0.4 + 0.05 * rng.normal()
        x = np.zeros((n, channels))
        for c in range(channels):
            x[:, c] = amp * gaussian_bump(verts, center, width * (1 + 0.1 * c))
        vcur = verts.copy()
        for t in range(steps):
            fields[t, m] = x.astype(np.float32)
            # advect: move the bump by rotating the sampling frame
            vcur = vcur @ rot.T
            x = (1 - diffusion) * x + diffusion * smooth(x)
            for c in range(channels):
                x[:, c] += 0.05 * amp * gaussian_bump(vcur, center, width) - 0.05 * x[:, c]
    return fields, verts, s, r
