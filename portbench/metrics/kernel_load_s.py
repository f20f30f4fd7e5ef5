"""The program's kernel-load seconds at the window's start (its own
counter, ``gwen_tpu_torch.ops.kernel_loads``): nvcc's builds, the CUDA
libraries' loads and each Triton kernel's first call per
specialisation."""

from portbench import tap
from portbench.spans import kernel_load_s

tap.install()


def read(run):
    return kernel_load_s(tap.kernel_loads(run))
