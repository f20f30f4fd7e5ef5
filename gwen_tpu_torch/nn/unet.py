"""UNet CNN baseline: counterpart of ``gwen_tpu.nn.unet``.

A ``depth``-scale UNet over member channels: the encoder is ``depth`` ×
(conv → max-pool → GroupNorm → ReLU), keeping each conv output (before the
pool) as the skip of its scale; the decoder is ``depth`` × (bilinear
upsample by 2 → concatenate the skip → conv → GroupNorm → ReLU); a 1×1
head maps ``hidden`` channels to ``channels_out``. Any spatial size is
taken: the input is edge-padded up to a multiple of ``2**depth`` and the
output cropped back.

Parameters are named as the reference's param tree (``enc_0.conv.w``,
``enc_0.norm.scale``, ..., ``dec_{i}``, ``head.w``), conv weights in OIHW,
which is torch's own layout, so a converted JAX tree
(:func:`~gwen_tpu_torch.nn.convert.params_from_jax`) loads with
``strict=True``. Seeded initialisation is He-normal for the conv weights,
zeros for the biases, ones and zeros for the norms, drawn on the CPU from
a ``torch.Generator`` and then placed on ``device``.

The convs are ``F.conv2d`` (cuDNN on the card) with no hand-written
kernel: the reference's convs are XLA convolutions, no Pallas kernel. On
the card a float32 conv runs in TF32 when
``torch.backends.cudnn.allow_tf32`` is set, which is torch's default; the
module sets no global flag, so a caller that wants float32 convs clears
it. A bfloat16 ``compute_dtype`` runs the convs, pools and upsampling in
bfloat16, with the GroupNorm statistics in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def conv_init(c_in: int, c_out: int, generator: torch.Generator, device,
              k: int = 3) -> nn.ParameterDict:
    """He-normal ``(c_out, c_in, k, k)`` weights and a zero bias."""
    fan_in = c_in * k * k
    w = torch.randn((c_out, c_in, k, k), generator=generator) * (2.0 / fan_in) ** 0.5
    return nn.ParameterDict({
        "w": nn.Parameter(w.to(device)),
        "b": nn.Parameter(torch.zeros(c_out, device=device)),
    })


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """Low and high padding of XLA's ``"SAME"`` along one axis."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_apply(p, x: Tensor, stride: int = 1) -> Tensor:
    """``"SAME"``-padded conv in ``x.dtype``, then the bias added in that
    dtype (as the reference: the conv's output is rounded before the
    bias)."""
    w = p["w"].to(x.dtype)
    k = w.shape[-1]
    ph = _same_pads(x.shape[-2], k, stride)
    pw = _same_pads(x.shape[-1], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        out = F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    else:
        out = F.conv2d(F.pad(x, (*pw, *ph)), w, stride=stride)
    return out + p["b"].to(x.dtype)[None, :, None, None]


def group_norm_init(channels: int, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        "scale": nn.Parameter(torch.ones(channels, device=device)),
        "bias": nn.Parameter(torch.zeros(channels, device=device)),
    })


def group_norm_apply(p, x: Tensor, groups: int = 8, eps: float = 1e-5) -> Tensor:
    """GroupNorm with ``min(groups, c)`` groups, lowered until it divides
    ``c``; float32 statistics (population variance), cast back to
    ``x.dtype``."""
    c = x.shape[1]
    g = min(groups, c)
    while c % g:
        g -= 1
    out = F.group_norm(x.float(), g, p["scale"].float(), p["bias"].float(), eps)
    return out.to(x.dtype)


def max_pool(x: Tensor, k: int = 2) -> Tensor:
    return F.max_pool2d(x, k, k)


class UNet(nn.Module):
    """``depth``-scale UNet: ``channels_in`` member channels →
    ``channels_out`` on ``(B, C, H, W)`` fields; the widths are ``hidden ·
    2**i`` for ``i < depth``."""

    def __init__(self, channels_in: int, channels_out: int, *, device,
                 hidden: int = 64, depth: int = 4,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels_in, self.channels_out = channels_in, channels_out
        self.hidden, self.depth = hidden, depth
        self.compute_dtype = compute_dtype
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        widths = self.widths
        c = channels_in
        for i, w in enumerate(widths):
            self.add_module(f"enc_{i}", nn.ModuleDict({
                "conv": conv_init(c, w, gen, device),
                "norm": group_norm_init(w, device)}))
            c = w
        for i in range(depth):
            # After the upsampling h sits at the scale of encoder skip
            # depth-1-i, which is concatenated to it.
            skip_ch = widths[depth - 1 - i]
            w_out = widths[depth - 2 - i] if i < depth - 1 else hidden
            self.add_module(f"dec_{i}", nn.ModuleDict({
                "conv": conv_init(c + skip_ch, w_out, gen, device),
                "norm": group_norm_init(w_out, device)}))
            c = w_out
        self.head = conv_init(hidden, channels_out, gen, device, k=1)

    @property
    def widths(self) -> list[int]:
        return [self.hidden * 2 ** i for i in range(self.depth)]

    def forward(self, x: Tensor) -> Tensor:
        h0, w0 = x.shape[-2:]
        m = 2 ** self.depth
        x = F.pad(x, (0, (-w0) % m, 0, (-h0) % m), mode="replicate")
        h = x.to(self.compute_dtype)

        skips = []
        for i in range(self.depth):
            p = getattr(self, f"enc_{i}")
            h = conv_apply(p["conv"], h)
            skips.append(h)
            h = torch.relu(group_norm_apply(p["norm"], max_pool(h)))

        for i in range(self.depth):
            p = getattr(self, f"dec_{i}")
            h = F.interpolate(h, scale_factor=2, mode="bilinear",
                              align_corners=False)
            h = torch.cat([h, skips[self.depth - 1 - i].to(h.dtype)], dim=1)
            h = torch.relu(group_norm_apply(p["norm"],
                                            conv_apply(p["conv"], h)))

        out = conv_apply(self.head, h)[..., :h0, :w0]
        return out.to(x.dtype)
