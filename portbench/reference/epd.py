"""The plain reference of the encode-process-decode mesh model: its
parameters, forward pass, next-step MSE training with Adam, and ensemble
generation with graph-correlated noise.

Plain torch in float32 with TF32 off, one sample or member at a time, on
the mesh of :mod:`portbench.reference.mesh` in natural node order. It
imports nothing of the program. What it computes, as the configuration
states it:

* encoder MLP ``C → L → L`` (ReLU between layers, none after the last);
* ``process_steps`` steps ``h ← h + LayerNorm(m)``, LayerNorm over the
  feature axis with float32 statistics, eps 1e-6, with ``m`` either the
  GCN message ``Â · (relu(h) W) + b`` over every edge, or windowed
  attention: ``q, k, v = relu(h) W_{q,k,v} + b``, per head (width
  ``L / heads``) softmax of ``q_i · k_j / sqrt(dh)`` over the in-window
  sources ``j`` of ``i``, the heads concatenated, then ``W_o``;
* decoder MLP ``L → L → C`` on ``relu(h)``.

``cast`` stands where the program keeps its compute precision: the
identity for the reference itself, a rounding to a lower precision for
the control (:func:`fp8_cast`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator

import torch

from portbench.reference.mesh import Mesh

Tensor = torch.Tensor
Cast = Callable[[Tensor], Tensor]
LN_EPS = 1e-6


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the block, then as it
    was."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def identity(t: Tensor) -> Tensor:
    return t


def bf16_cast(t: Tensor) -> Tensor:
    """Round to bfloat16, back in float32; the gradient passes straight
    through (a witness of what the configuration's own rounding gives)."""
    return t + (t.detach().to(torch.bfloat16).float() - t.detach())


def fp8_cast(t: Tensor) -> Tensor:
    """Round to float8 e4m3 with one scale per tensor (its largest
    magnitude onto 448), back in float32; the gradient passes straight
    through."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - t.detach())


def param_shapes(model_cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, named as the program's state dict
    names them."""
    c, lat = model_cfg["channels"], model_cfg["latent_size"]
    layers = model_cfg["mlp_layers"]
    out: dict[str, tuple[int, ...]] = {}

    def mlp(prefix, dims):
        for i in range(len(dims) - 1):
            out[f"{prefix}.layer_{i}.w"] = (dims[i], dims[i + 1])
            out[f"{prefix}.layer_{i}.b"] = (dims[i + 1],)

    mlp("encoder", [c] + [lat] * layers)
    for i in range(model_cfg["process_steps"]):
        if model_cfg["processor"] == "attention":
            for name in ("wq", "wk", "wv", "wo"):
                out[f"process_{i}.attn.{name}.w"] = (lat, lat)
                out[f"process_{i}.attn.{name}.b"] = (lat,)
        else:
            out[f"process_{i}.gcn.w"] = (lat, lat)
            out[f"process_{i}.gcn.b"] = (lat,)
        out[f"process_{i}.norm.scale"] = (lat,)
        out[f"process_{i}.norm.bias"] = (lat,)
    mlp("decoder", [lat] * layers + [c])
    return out


def init_params(model_cfg: dict, generator: torch.Generator
                ) -> dict[str, Tensor]:
    """Parameters drawn in one call on the generator's device: weights
    Glorot-uniform, biases and LayerNorm offsets uniform in ±0.1, LayerNorm
    scales uniform in 1 ± 0.1; float32."""
    shapes = param_shapes(model_cfg)
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=generator, device=generator.device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        v = u[at:at + k].reshape(shape)
        at += k
        if len(shape) == 2:
            v = v * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif name.endswith("norm.scale"):
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v.clone()
    return out


class DeviceMesh:
    """A :class:`Mesh`'s index and weight arrays on a device."""

    def __init__(self, mesh: Mesh, device):
        as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        self.n = mesh.num_nodes
        self.s, self.r = as_t(mesh.senders), as_t(mesh.receivers)
        self.w = as_t(mesh.weights).float()
        if mesh.attn_senders is not None:
            self.as_, self.ar = as_t(mesh.attn_senders), as_t(mesh.attn_receivers)


def aggregate(dm: DeviceMesh, x: Tensor) -> Tensor:
    """``out[r] = Σ w_e x[s]`` over every edge, on ``(..., N, F)``."""
    xm = x.movedim(-2, 0)
    msg = xm[dm.s] * dm.w.reshape((-1,) + (1,) * (xm.dim() - 1))
    return torch.zeros_like(xm).index_add(0, dm.r, msg).movedim(0, -2)


def _linear(p: dict, name: str, x: Tensor, cast: Cast) -> Tensor:
    return cast(cast(x) @ cast(p[f"{name}.w"]) + p[f"{name}.b"])


def _mlp(p: dict, prefix: str, layers: int, x: Tensor, cast: Cast) -> Tensor:
    for i in range(layers):
        x = _linear(p, f"{prefix}.layer_{i}", x, cast)
        if i < layers - 1:
            x = torch.relu(x)
    return x


def _layer_norm(p: dict, name: str, m: Tensor) -> Tensor:
    mu = m.mean(dim=-1, keepdim=True)
    var = ((m - mu) ** 2).mean(dim=-1, keepdim=True)
    return (m - mu) * torch.rsqrt(var + LN_EPS) * p[f"{name}.scale"] + p[f"{name}.bias"]


def _attention(p: dict, i: int, dm: DeviceMesh, x: Tensor, heads: int,
               cast: Cast) -> Tensor:
    """Windowed multi-head attention on one sample ``(N, L)``."""
    n, lat = x.shape
    dh = lat // heads
    pre = f"process_{i}.attn"
    q, k, v = (_linear(p, f"{pre}.{w}", x, cast).reshape(n, heads, dh)
               for w in ("wq", "wk", "wv"))
    src, dst = dm.as_, dm.ar
    outs = []
    for h in range(heads):
        score = (q[dst, h] * k[src, h]).sum(-1) / math.sqrt(dh)
        top = torch.full((n,), -math.inf, device=x.device).scatter_reduce(
            0, dst, score.detach(), "amax")
        e = torch.exp(score - top[dst])
        den = torch.zeros(n, device=x.device).index_add(0, dst, e)
        prob = cast(e / den[dst])
        outs.append(torch.zeros(n, dh, device=x.device).index_add(
            0, dst, prob[:, None] * v[src, h]))
    return _linear(p, f"{pre}.wo", cast(torch.cat(outs, dim=-1)), cast)


def forward(p: dict, model_cfg: dict, dm: DeviceMesh, x: Tensor,
            cast: Cast = identity) -> Tensor:
    """One sample: ``x`` ``(N, C)`` → ``(N, C)``."""
    layers = model_cfg["mlp_layers"]
    h = _mlp(p, "encoder", layers, cast(x), cast)
    for i in range(model_cfg["process_steps"]):
        a = torch.relu(h)
        if model_cfg["processor"] == "attention":
            m = _attention(p, i, dm, a, model_cfg["attn_heads"], cast)
        else:
            pre = cast(cast(a) @ cast(p[f"process_{i}.gcn.w"]))
            m = cast(cast(aggregate(dm, pre)) + p[f"process_{i}.gcn.b"])
        h = cast(h + _layer_norm(p, f"process_{i}.norm", m))
    return _mlp(p, "decoder", layers, torch.relu(h), cast)


def loss_and_grads(p: dict, model_cfg: dict, dm: DeviceMesh, x: Tensor,
                   y: Tensor, cast: Cast = identity
                   ) -> tuple[float, dict[str, Tensor]]:
    """The MSE over the whole batch ``(B, N, C)`` and its gradients,
    accumulated one sample at a time."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total = 0.0
    b = x.shape[0]
    for i in range(b):
        loss = torch.mean((forward(leaves, model_cfg, dm, x[i], cast) - y[i]) ** 2) / b
        for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                    allow_unused=True)):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
    return total, grads


class Adam:
    """Adam as the configuration states it (bias-corrected, no decay)."""

    def __init__(self, params: dict[str, Tensor], lr: float,
                 betas: tuple[float, float], eps: float):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict[str, Tensor], grads: dict[str, Tensor]
             ) -> dict[str, Tensor]:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            out[k] = params[k] - self.lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + self.eps)
        return out


def train_steps(p: dict, model_cfg: dict, opt_cfg: dict, dm: DeviceMesh,
                batches: list[tuple[Tensor, Tensor]], cast: Cast = identity
                ) -> dict:
    """Adam steps over ``batches``: each step's loss, the first step's
    gradients and the parameters after the last step."""
    adam = Adam(p, opt_cfg["lr"], tuple(opt_cfg["betas"]), opt_cfg["eps"])
    losses, first = [], None
    with no_tf32():
        for x, y in batches:
            loss, grads = loss_and_grads(p, model_cfg, dm, x, y, cast)
            losses.append(loss)
            first = grads if first is None else first
            p = adam.step(p, grads)
    return {"losses": losses, "grads": first, "params": p}


def members(p: dict, dm: DeviceMesh, base: Tensor, white: Tensor,
            sigma: float, smoothing: int, cast: Cast = identity) -> Tensor:
    """Perturbed initial states ``(K, N, C)``: white noise smoothed by
    ``smoothing`` aggregations over every edge, scaled to unit standard
    deviation per member, times ``sigma``, added to ``base``."""
    del p
    eps = white
    for _ in range(smoothing):
        eps = cast(aggregate(dm, cast(eps)))
    std = eps.std(dim=(-2, -1), keepdim=True, unbiased=False) + 1e-8
    return base.unsqueeze(0) + sigma * (eps / std)


@torch.no_grad()
def trajectory(p: dict, model_cfg: dict, dm: DeviceMesh, base: Tensor,
               white: Tensor, sigma: float, smoothing: int, steps: int,
               cast: Cast = identity) -> Iterator[Tensor]:
    """Each member's rollout ``(steps, N, C)``, one member at a time."""
    start = members(p, dm, base, white, sigma, smoothing, cast)
    for k in range(start.shape[0]):
        x, out = start[k], []
        with no_tf32():
            for _ in range(steps):
                x = forward(p, model_cfg, dm, x, cast)
                out.append(x)
        yield torch.stack(out)
