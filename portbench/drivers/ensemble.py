"""The ensemble driver: one client in a closed loop of ``generate_ensemble``
requests. Request ``i`` takes base state ``i mod pool`` and the mix's
member count ``cycle[i mod len(cycle)]``, the same cycle on every seed,
with white noise drawn from the seed and the request's index and passed
as ``noise=``. A request's latency runs from its call until the device's
synchronise after it.

Set-up warms one request of each member count. The check draws a sample
of the window's requests from the seed, with the largest member count in
it, keeps their trajectories and, after the window, holds every member's
every lead step against the plain reference:

* ``member_step_gap``: the worst RMS gap of one member's field at one lead
  step, over the RMS of the request's base state (the data's own scale:
  with some seeds' weights the model's output is a small remainder of
  activations of order 1, whose rounding then reads large against the
  output itself);
* ``spread_decorrelation``: one minus the cosine between the two sides'
  member deviations from the ensemble mean at the first lead step, where
  the ensemble is widest (with random weights the model draws its members
  together as it rolls forward). Rounding that is small against the
  spread leaves it near 0; a member lost or replaced moves it towards 1.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import data, port
from portbench.reference import epd as ref
from portbench.reference.mesh import build_mesh
from portbench.roofline import epd as work
from portbench.window import Window, sync


class Driver:
    def __init__(self, cfg: dict, mix: dict, device: torch.device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.model = None

    def start(self, seed: int, program: port.Program) -> None:
        cfg, mix, dev = self.cfg, self.mix, self.device
        self.seed, self.program = seed, program
        self.c = cfg["model"]["channels"]
        gen = data.generator(seed, dev)
        self.params = ref.init_params(cfg["model"], gen)
        self.base_nat = data.base_states(gen, mix, program.num_nodes, self.c)
        self.base = self.base_nat[:, program.perm]
        self.noise_gen = data.generator(seed, dev, 1)
        self.model = port.build_model(cfg, self.params, dev)
        self.model.eval()
        self.sample = self._sample(seed)
        self.kept: dict[int, torch.Tensor] = {}
        cycle = mix["members_cycle"]
        for i in range(len(cycle)):  # warm every member count
            self._request(-1 - i, cycle[i])
        sync(dev)
        self.next = 0

    def _sample(self, seed: int) -> list[int]:
        """Request indices to check: ``checked_requests`` drawn from the
        first ``sample_from``, and the first request of the largest member
        count at or after the first of them."""
        mix = self.mix
        rng = random.Random(data.mix(seed, 0xC4EC))
        picks = sorted(rng.sample(range(mix["sample_from"]), mix["checked_requests"]))
        cycle = mix["members_cycle"]
        big = cycle.index(max(cycle))
        first = picks[0] + (big - picks[0]) % len(cycle)
        return sorted(set(picks) | {first})

    def _members(self, i: int) -> int:
        cycle = self.mix["members_cycle"]
        return cycle[i % len(cycle)]

    def _request(self, i: int, members: int) -> torch.Tensor:
        mix = self.mix
        white = data.white_noise(self.noise_gen, self.seed, i, members,
                                 self.program.num_nodes, self.c)
        return port.generate(self.model, self.program.graph,
                             self.base[i % mix["base_pool"]], white,
                             mix["lead_steps"], mix["sigma"], mix["smoothing_steps"])

    def window(self, seconds: float, rec) -> Window:
        steps = self.mix["lead_steps"]
        units, dispatch = [], []
        with rec.range("window"):
            sync(self.device)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                i, k = self.next, self._members(self.next)
                self.next += 1
                with rec.range("draw_noise"):
                    white = data.white_noise(self.noise_gen, self.seed, i, k,
                                             self.program.num_nodes, self.c)
                a = time.perf_counter()
                with rec.range("generate"):
                    traj = port.generate(
                        self.model, self.program.graph,
                        self.base[i % self.mix["base_pool"]], white, steps,
                        self.mix["sigma"], self.mix["smoothing_steps"])
                dispatch.append(time.perf_counter() - a)
                with rec.range("sync"):
                    sync(self.device)
                units.append({"members": k, "steps": steps,
                              "latency_s": time.perf_counter() - a})
                if i in self.sample and i not in self.kept:
                    self.kept[i] = traj
            t1 = time.perf_counter()
        return Window(seconds=t1 - t0, attempted=len(units), failed=0,
                      units=units, dispatch_s=dispatch)

    def ops(self, win: Window) -> list[work.Op]:
        m, lv, mix = self.cfg["model"], self.cfg["graph"]["refine"], self.mix
        out = []
        for u in win.units:
            out += work.request_ops(m, lv, u["members"], u["steps"],
                                    mix["smoothing_steps"])
        return out

    def release(self) -> None:
        self.model = None

    def check(self, cast=None) -> dict[str, float]:
        """``member_step_gap`` over the kept requests (every sampled request
        the window completed; none kept reads as not a number). With
        ``cast``, the reference computed through it stands in the
        program's place (the control), on every sampled request."""
        cfg, mix, dev = self.cfg, self.mix, self.device
        dm = ref.DeviceMesh(build_mesh(cfg["graph"], cfg["model"]["processor"] == "attention"), dev)
        inv = torch.argsort(self.program.perm)
        gaps, spread = [], []
        for i in (self.sample if cast is not None else sorted(self.kept)):
            white = data.white_noise(self.noise_gen, self.seed, i, self._members(i),
                                     self.program.num_nodes, self.c)[:, inv]
            base = self.base_nat[i % mix["base_pool"]]
            args = (self.params, cfg["model"], dm, base, white, mix["sigma"],
                    mix["smoothing_steps"], mix["lead_steps"])
            prog = (self.kept[i][:, :, inv] if cast is None
                    else torch.stack(list(ref.trajectory(*args, cast=cast))))
            want = torch.stack(list(ref.trajectory(*args)))
            if prog.shape != want.shape:
                gaps.append(float("inf"))
                continue
            gaps.append(member_step_gap(prog.float(), want, base))
            spread.append(spread_decorrelation(prog.float(), want))
        nan = float("nan")
        return {"member_step_gap": max(gaps) if gaps else nan,
                "spread_decorrelation": max(spread) if spread else nan}


def member_step_gap(program: torch.Tensor, reference: torch.Tensor,
                    base: torch.Tensor) -> float:
    """The worst RMS of ``p − r`` over one member at one lead step, over the
    RMS of the base state; trajectories ``(K, T, N, C)``."""
    rms = (program - reference).pow(2).mean(dim=(2, 3)).sqrt().max()
    return float(rms / base.pow(2).mean().sqrt().clamp_min(1e-30))


def spread_decorrelation(program: torch.Tensor, reference: torch.Tensor) -> float:
    """``1 − cos(d_p, d_r)`` for the members' deviations ``d`` from their
    mean at the first lead step."""
    dp = program[:, 0] - program[:, 0].mean(0)
    dr = reference[:, 0] - reference[:, 0].mean(0)
    cos = (dp * dr).sum() / (dp.norm() * dr.norm()).clamp_min(1e-30)
    return float(1 - cos)
