"""``python -m gwen_tpu_torch predict``: serve an exported artifact.

Counterpart of ``gwen_tpu.cli.export_cli.predict_main``. The input is a
``(nodes, channels)`` .npy in *original* node order; it is mapped through
the artifact's node permutation (``ServingModel.node_perm``) and the
trajectory mapped back.
"""

from __future__ import annotations

import numpy as np
import torch

from gwen_tpu_torch.logging_utils import get_logger

log = get_logger()


def predict_main(artifact: str, input_path: str, steps: int, out: str,
                 device: str = "cuda") -> dict:
    """Load a serving artifact on ``device`` and roll out ``steps`` steps
    from the initial state in ``input_path``; save the ``(steps, nodes,
    channels)`` trajectory to ``out``."""
    from gwen_tpu_torch.serve import ServingModel

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "predict: CUDA is not available; the port serves on an NVIDIA "
            "GPU (pass --device cpu to run the plain versions on the CPU)")
    sm = ServingModel.load(artifact, dev)
    x0 = np.load(input_path)
    if tuple(x0.shape) != sm.input_shape:
        raise ValueError(
            f"input shape {x0.shape} != artifact input {sm.input_shape}")
    perm = sm.node_perm
    x = torch.from_numpy(np.ascontiguousarray(x0[perm], np.float32)).to(dev)
    traj = sm.rollout(x, steps).cpu().numpy()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    traj = traj[:, inv]
    np.save(out, traj)
    result = {"out": out, "steps": steps, "shape": list(traj.shape),
              "device": str(dev)}
    log.info("predicted %s", result)
    return result
