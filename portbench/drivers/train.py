"""The training driver: a closed loop of ``Trainer.train_step`` calls on a
pool of distinct batches resident on the device, steps dispatched ahead,
the losses kept on the device and read after the window, as
``Trainer.fit`` does.

Set-up builds one train state from the seed and drives it through the
mix's first steps, which warm every shape the window uses; the same
object then runs the window. The check holds those first steps against
the plain reference: each step's loss, each parameter's first gradient
(read back from Adam's first moment) and each parameter's change after
the checked steps, by the gap between the two sides' norms per leaf.
"""

from __future__ import annotations

import time

import torch

from portbench import data, port
from portbench.checks import leaf_norm_gap, median_leaf_diff
from portbench.reference import epd as ref
from portbench.reference.mesh import build_mesh
from portbench.roofline import epd as work
from portbench.window import Window, sync


class Driver:
    def __init__(self, cfg: dict, mix: dict, device: torch.device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.state = self.trainer = None

    def start(self, seed: int, program: port.Program) -> None:
        cfg, mix, dev = self.cfg, self.mix, self.device
        self.program = program
        gen = data.generator(seed, dev)
        self.params = ref.init_params(cfg["model"], gen)
        self.pool_nat = data.train_pool(gen, mix, program.num_nodes,
                                        cfg["model"]["channels"])
        self.pool = [(x[:, program.perm], y[:, program.perm]) for x, y in self.pool_nat]
        model = port.build_model(cfg, self.params, dev)
        self.trainer, self.state = port.build_trainer(mix, model, program.graph, dev)
        checked = mix["checked_steps"]
        self.first_losses = []
        for k in range(max(mix["warmup_steps"], checked)):
            loss = self.trainer.train_step(self.state, self.pool[k % len(self.pool)])
            if k < checked:
                self.first_losses.append(loss)
            if k == 0:
                self.first_grads = port.first_gradients(
                    self.state, mix["optimizer"]["betas"][0])
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
                    losses.append(self.trainer.train_step(
                        self.state, pool[self.next % len(pool)]))
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

    def ops(self, win: Window) -> list[work.Op]:
        step = work.train_ops(self.cfg["model"], self.cfg["graph"]["refine"],
                              self.mix["batch"])
        return step * len(win.units)

    def release(self) -> None:
        self.first_losses = [float(v) for v in self.first_losses]
        self.state = self.trainer = self.pool = None

    def check(self, cast=None) -> dict[str, float]:
        """``loss_gap``: the largest relative gap of a checked step's loss;
        ``grad_gap`` and ``change_gap``: the worst leaf's gap of norms
        (:func:`leaf_norm_gap`) of the first gradient and of the change
        after the checked steps; ``grad_diff_ratio``: the median leaf's
        difference of the first gradient from the reference's
        (:func:`median_leaf_diff`) over the same for the reference rounded
        to bf16 where the configuration computes in bf16. The last is the
        number a lower precision moves: gaps of norms hardly see rounding
        errors, and how far bf16 itself moves a gradient depends on the
        seed's weights, which the ratio divides out. With ``cast``, the
        reference computed through it stands in the program's place (the
        control)."""
        cfg, mix, dev = self.cfg, self.mix, self.device
        dm = ref.DeviceMesh(build_mesh(cfg["graph"], cfg["model"]["processor"] == "attention"), dev)
        batches = self.pool_nat[:mix["checked_steps"]]

        def steps(rounding=ref.identity):
            return ref.train_steps(self.params, cfg["model"], mix["optimizer"], dm, batches,
                                   rounding)

        out, witness = steps(), steps(ref.bf16_cast)
        if cast is None:
            side = {"losses": self.first_losses, "grads": self.first_grads, "params": self.after}
        else:
            side = steps(cast)
        numbers = compare(side["losses"], side["grads"], side["params"], self.params, out)
        numbers["grad_diff_ratio"] = (median_leaf_diff(side["grads"], out["grads"])
                                      / median_leaf_diff(witness["grads"], out["grads"]))
        return numbers


def compare(losses: list[float], grads: dict, after: dict, before: dict,
            ref_out: dict) -> dict[str, float]:
    """The gaps of a training check, the program's side against the
    reference's :func:`~portbench.reference.epd.train_steps`."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_out["losses"]))
    rg = ref_out["grads"]
    change = {k: after[k] - before[k] for k in before}
    ref_change = {k: ref_out["params"][k] - before[k] for k in before}
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_norm_gap(grads, rg),
            "change_gap": leaf_norm_gap(change, ref_change, moved=rg)}
