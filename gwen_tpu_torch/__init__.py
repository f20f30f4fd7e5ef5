"""gwen_tpu_torch — the PyTorch/CUDA port of ``gwen_tpu`` for NVIDIA Hopper.

Imports torch and never jax: ``gwen_tpu`` stays the reference the port is
tested against. The port covers the reference's package: graph building
and the diag-window, packed, banded, block-tile and partition layouts;
aggregation and windowed attention on hand-written CUDA kernels and the
fused residual LayerNorm on Triton; the GCN, attention, interaction,
member-graph GCN and UNet models; losses, ensembles and skill scores;
training (one process, or one process per device under
``torch.distributed.run``: partitioned ``train-mesh``, data-parallel
``train-gnn`` and ``train-cnn``); checkpoints, the registry, serving,
stores, profiling and every CLI subcommand of the reference, ``bench``
included.
"""

from gwen_tpu_torch.version import __author__, __version__

from gwen_tpu_torch.config import GwenConfig, load_config
from gwen_tpu_torch.logging_utils import get_logger, setup_logger, suppress_warnings

__all__ = [
    "__author__",
    "__version__",
    "GwenConfig",
    "load_config",
    "get_logger",
    "setup_logger",
    "suppress_warnings",
]
