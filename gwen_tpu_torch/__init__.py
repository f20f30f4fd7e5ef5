"""gwen_tpu_torch — the PyTorch/CUDA port of ``gwen_tpu`` for NVIDIA Hopper.

Imports torch and never jax: ``gwen_tpu`` stays the reference the port is
tested against. Slice 1 is the serving path: graph building, the
diag-window aggregation (hand-written CUDA kernels), the fused residual
LayerNorm (a Triton kernel), ``EncodeProcessDecode`` with the GCN
processor, artifact loading and ``predict``.
"""

__version__ = "0.1.0"
