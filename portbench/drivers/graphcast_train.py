"""GraphCast's training driver: a closed loop of ``Trainer.train_step``
calls on a pool of distinct samples resident on the device, steps
dispatched ahead, the losses kept on the device and read after the
window, as ``drivers/train.py`` runs the EPD cells.

Set-up builds GraphCast's graphs through the program (``graphcast_port``;
the harness's icosphere build goes unused), one train state from the
seed, and drives it through the mix's first steps, which warm every shape
the window uses. A sample is one 6-hour step on the grid: ``channels_in``
inputs ``x = a·z1`` and the next state's normalised residual ``y =
a·(ρ z1[:channels_out] + sqrt(1 − ρ²) z2)``, the amplitude ``a`` drawn per
sample. The check holds the first steps against the plain reference
(``reference/graphcast.py``) by the numbers ``drivers/train.py`` reads.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import data, graphcast_port, port
from portbench.checks import leaf_norm_gap, median_leaf_diff
from portbench.reference import graphcast as ref
from portbench.reference.epd import bf16_cast
from portbench.roofline import graphcast as work
from portbench.window import Window, sync


def samples(gen: torch.Generator, mix: dict, n: int, c_in: int, c_out: int
            ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``mix["pool"]`` distinct batches ``(x, y)``, ``(B, n, c_in)`` and
    ``(B, n, c_out)``."""
    p, b, rho = mix["pool"], mix["batch"], mix["next_step_correlation"]
    out = []
    for a in data.amplitudes(gen, (p, b, 1, 1), *mix["amplitude"]):
        z = torch.randn((b, n, c_in), generator=gen, device=gen.device)
        x = a * z
        y = a * (rho * z[..., :c_out] + math.sqrt(1 - rho * rho)
                 * torch.randn((b, n, c_out), generator=gen, device=gen.device))
        out.append((x, y))
    return out


class Driver:
    def __init__(self, cfg: dict, mix: dict, device: torch.device):
        graphcast_port.require()
        if device.type == "cpu" and cfg["graph"]["grid_lat"] * cfg["graph"]["grid_lon"] > 1 << 16:
            raise ValueError("GraphCast at this grid runs on the card; give a CPU run "
                             "config_overrides that cut the grid")
        self.cfg, self.mix, self.device = cfg, mix, device
        self.state = self.trainer = None

    def start(self, seed: int, program: port.Program) -> None:
        del program  # the harness's icosphere: GraphCast builds its own graphs
        cfg, mix, dev, m = self.cfg, self.mix, self.device, self.cfg["model"]
        graphs = graphcast_port.build_graphs(cfg, dev)
        self.sizes = graphcast_port.sizes(graphs)
        gen = data.generator(seed, dev)
        self.params = ref.init_params(m, gen)
        self.pool = samples(gen, mix, graphs.num_grid, m["channels_in"], m["channels_out"])
        model = graphcast_port.build_model(cfg, self.params, dev)
        self.trainer, self.state = graphcast_port.build_trainer(cfg, mix, model, graphs, dev)
        checked = mix["checked_steps"]
        self.first_losses = []
        for k in range(max(mix["warmup_steps"], checked)):
            loss = self.trainer.train_step(self.state, self.pool[k % len(self.pool)])
            if k < checked:
                self.first_losses.append(loss)
            if k == 0:
                self.first_grads = port.first_gradients(self.state, mix["optimizer"]["betas"][0])
            if k == checked - 1:
                self.after = {n: p.detach().clone()
                              for n, p in self.state.model.named_parameters()}
        self.next = max(mix["warmup_steps"], checked)
        sync(dev)

    def window(self, seconds: float, rec) -> Window:
        batch, pool = self.mix["batch"], self.pool
        losses, dispatch = [], []
        with rec.range("window"):
            sync(self.device)
            t0 = time.perf_counter()
            while True:
                with rec.range("train_step"):
                    a = time.perf_counter()
                    losses.append(self.trainer.train_step(self.state, pool[self.next % len(pool)]))
                    dispatch.append(time.perf_counter() - a)
                self.next += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            with rec.range("sync"):
                sync(self.device)
            t1 = time.perf_counter()
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        return Window(seconds=t1 - t0, attempted=len(losses), failed=bad,
                      units=[{"samples": batch}] * len(losses), dispatch_s=dispatch)

    def ops(self, win: Window) -> list:
        return work.train_ops(self.cfg["model"], self.sizes, self.mix["batch"]) * len(win.units)

    def release(self) -> None:
        self.first_losses = [float(v) for v in self.first_losses]
        self.pool = self.pool[:self.mix["checked_steps"]]
        self.state = self.trainer = None

    def check(self, cast=None) -> dict[str, float]:
        """``loss_gap``, ``grad_gap``, ``change_gap`` and
        ``grad_diff_ratio`` of the checked steps against the reference, as
        ``drivers/train.py`` reads them; with ``cast``, the reference
        computed through it stands in the program's place (the
        control)."""
        cfg, mix = self.cfg, self.mix
        dg = ref.DeviceGraphs(ref.build_graphs(cfg["graph"]), self.device, cfg["loss"])
        batches = [self.pool[k % len(self.pool)] for k in range(mix["checked_steps"])]

        def steps(rounding=ref.identity):
            return ref.train_steps(self.params, cfg["model"], mix["optimizer"], dg, batches,
                                   rounding)

        out, witness = steps(), steps(bf16_cast)
        if cast is None:
            side = {"losses": self.first_losses, "grads": self.first_grads, "params": self.after}
        else:
            side = steps(cast)
        rg = out["grads"]
        change = {k: side["params"][k] - self.params[k] for k in self.params}
        ref_change = {k: out["params"][k] - self.params[k] for k in self.params}
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(side["losses"], out["losses"])),
                "grad_gap": leaf_norm_gap(side["grads"], rg),
                "change_gap": leaf_norm_gap(change, ref_change, moved=rg),
                "grad_diff_ratio": (median_leaf_diff(side["grads"], rg)
                                    / median_leaf_diff(witness["grads"], rg))}
