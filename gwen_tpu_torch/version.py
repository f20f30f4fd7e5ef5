"""Version metadata for gwen_tpu_torch: counterpart of ``gwen_tpu.version``
(a plain module, so the package works without being installed)."""

__version__ = "0.1.0"
__author__ = "gwen-tpu developers"
