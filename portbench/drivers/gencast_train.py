"""GenCast's training driver: a closed loop of ``Trainer.train_step`` calls
on the EDM denoising task over a pool of distinct samples resident on the
device, steps dispatched ahead, the losses kept on the device and read
after the window, as ``drivers/graphcast_train.py`` runs GraphCast.

Set-up builds GenCast's graphs through the program (``gencast_port``; the
k-hop lists on the card; the harness's icosphere build goes unused), one
train state from the seed, and drives it through the mix's first steps,
which warm every shape the window uses. A sample is one 12-hour step on
the grid: the conditioning ``cond = a·z1`` (the two input states, then the
forcings and static fields, ``channels_in − channels_out`` channels) and
the next state's normalised residual ``y = a·(ρ z1[:channels_out] +
sqrt(1 − ρ²) z2)``, the amplitude ``a`` drawn per sample (GraphCast's
``samples``, the conditioning in the place of its inputs). Step ``k`` draws
its noise level and noise on the card from the seed ``mix(seed, NOISE,
k)``. The check holds the first steps against the plain reference
(``reference/gencast.py``), which draws the same noise, by the numbers
``drivers/graphcast_train.py`` reads, the program's neighbour lists
against the reference's own k-hop neighbourhoods (``list_gap``), and what
the attention gave: the first checked step's first attention call (layer
0's forward) against the reference's attention over its own lists on the
same q, k and v (``attn_gap``).
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from portbench import data, gencast_port, port
from portbench.checks import leaf_norm_gap, median_leaf_diff
from portbench.drivers.graphcast_train import samples
from portbench.reference import gencast as ref
from portbench.reference.epd import bf16_cast
from portbench.roofline import gencast as work
from portbench.window import Window, sync

NOISE = 0x6E015E


class Driver:
    def __init__(self, cfg: dict, mix: dict, device: torch.device):
        gencast_port.require()
        if device.type == "cpu" and cfg["graph"]["grid_lat"] * cfg["graph"]["grid_lon"] > 1 << 16:
            raise ValueError("GenCast at this grid runs on the card; give a CPU run "
                             "config_overrides that cut the grid")
        self.cfg, self.mix, self.device = cfg, mix, device
        self.state = self.trainer = None

    def _batch(self, k: int) -> tuple:
        cond, y = self.pool[k % len(self.pool)]
        return cond, y, data.mix(self.seed, NOISE, k)

    def start(self, seed: int, program: port.Program) -> None:
        del program  # the harness's icosphere: GenCast builds its own graphs
        cfg, mix, dev, m = self.cfg, self.mix, self.device, self.cfg["model"]
        graphs = gencast_port.build_graphs(cfg, dev)
        self.sizes = gencast_port.sizes(graphs)
        self.lists = graphs.mesh.attn_nbr, graphs.mesh_perm
        self.seed = seed
        gen = data.generator(seed, dev)
        self.params = ref.init_params(m, gen)
        self.pool = samples(gen, mix, graphs.num_grid, m["channels_in"] - m["channels_out"],
                            m["channels_out"])
        model = gencast_port.build_model(cfg, self.params, dev)
        self.trainer, self.state = gencast_port.build_trainer(cfg, mix, model, graphs, dev)
        checked = mix["checked_steps"]
        self.first_losses, self.held = [], []
        for k in range(max(mix["warmup_steps"], checked)):
            with gencast_port.first_attention(self.held) if k == 0 else contextlib.nullcontext():
                loss = self.trainer.train_step(self.state, self._batch(k))
            if k < checked:
                self.first_losses.append(loss)
            if k == 0:  # the held attention call waits on the host: no window holds it
                self.held = [tuple(t.cpu() for t in self.held[0])]
                self.first_grads = port.first_gradients(self.state, mix["optimizer"]["betas"][0])
            if k == checked - 1:
                self.after = {n: p.detach().clone()
                              for n, p in self.state.model.named_parameters()}
        self.next = max(mix["warmup_steps"], checked)
        sync(dev)

    def window(self, seconds: float, rec) -> Window:
        losses, dispatch = [], []
        with rec.range("window"):
            sync(self.device)
            t0 = time.perf_counter()
            while True:
                with rec.range("train_step"):
                    a = time.perf_counter()
                    losses.append(self.trainer.train_step(self.state, self._batch(self.next)))
                    dispatch.append(time.perf_counter() - a)
                self.next += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            with rec.range("sync"):
                sync(self.device)
            t1 = time.perf_counter()
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        return Window(seconds=t1 - t0, attempted=len(losses), failed=bad,
                      units=[{"samples": self.mix["batch"]}] * len(losses), dispatch_s=dispatch)

    def ops(self, win: Window) -> list:
        return work.train_ops(self.cfg["model"], self.sizes, self.mix["batch"]) * len(win.units)

    def release(self) -> None:
        self.first_losses = [float(v) for v in self.first_losses]
        self.pool = self.pool[:self.mix["checked_steps"]]
        self.state = self.trainer = None

    def list_gap(self, dg) -> float:
        """The share of the reference's k-hop (row, source) pairs that the
        program's neighbour lists, taken to the icosphere's numbering, lack
        or add: 0 where the timed path attended every source and no other."""
        nbr, perm = self.lists
        n, perm = dg.n_mesh, perm.to(dg.nbr_idx.device).long()
        nbr = nbr.to(perm.device)
        keep = nbr >= 0
        got = perm.repeat_interleave(keep.sum(1)) * n + perm[nbr[keep].long()]
        rows = torch.arange(n, device=perm.device).repeat_interleave(dg.nbr_mask.sum(1))
        want = rows * n + dg.nbr_idx[dg.nbr_mask]
        _, count = torch.unique(torch.cat([got.unique(), want]), return_counts=True)
        return float((count == 1).sum()) / len(want)

    def attn_gap(self, dg, cast=None) -> float:
        """``‖out − want‖ / ‖want‖`` over the held attention call: ``want``
        the reference's attention (float32, its own k-hop lists) on the
        program's q, k and v taken to the icosphere's numbering, with the
        attention weights and the output rounded to the output's dtype
        where the program rounds them (the bf16 witness's rounding of the
        weights), ``out`` the program's output. Where every source was
        attended with its weight the two differ only where their float32
        values straddle a rounding boundary; one source of 817 left out
        moves every weight by a part of a bf16 step. With ``cast``, the
        reference computed on the cast q, k and v through ``cast`` stands
        in the program's place."""
        q, k, v, out = (t.to(dg.nbr_idx.device) for t in self.held[0])
        perm = self.lists[1].to(q.device).long()
        heads, dh = q.shape[0], q.shape[-1]

        def nodes(t):  # (H, 1, N, dh), mesh rows → (N, H, dh), icosphere rows
            t = t.reshape(heads, -1, dh).transpose(0, 1).float()
            back = torch.empty_like(t)
            back[perm] = t
            return back

        def rounded(t):
            return t.to(out.dtype).float()

        qn, kn, vn = nodes(q), nodes(k), nodes(v)
        with torch.no_grad(), ref.no_tf32():
            want = rounded(ref.attend(qn, kn, vn, dg, 1.0 / math.sqrt(dh), rounded))
            got = (nodes(out) if cast is None
                   else ref.attend(cast(qn), cast(kn), cast(vn), dg, 1.0 / math.sqrt(dh), cast))
        return float(torch.linalg.vector_norm((got - want).double())
                     / torch.linalg.vector_norm(want.double()))

    def check(self, cast=None) -> dict[str, float]:
        """``loss_gap``, ``grad_gap``, ``change_gap`` and
        ``grad_diff_ratio`` of the checked steps against the reference, as
        ``drivers/graphcast_train.py`` reads them, :meth:`list_gap` and
        :meth:`attn_gap` (no bf16 rounding at float32 moves a loss or a
        gradient as far as one source left out of 817 does, and the lists
        alone do not show what the kernels attended); with ``cast``, the
        reference computed through it stands in the program's place (the
        control), beside the program's lists."""
        cfg, mix = self.cfg, self.mix
        dg = ref.DeviceGraphs(cfg["graph"], self.device, cfg["loss"])
        batches = [self._batch(k) for k in range(mix["checked_steps"])]

        def steps(rounding=ref.identity):
            return ref.train_steps(self.params, cfg["model"], mix["optimizer"], cfg["edm"], dg,
                                   batches, rounding)

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
                                    / median_leaf_diff(witness["grads"], rg)),
                "list_gap": self.list_gap(dg),
                "attn_gap": self.attn_gap(dg, cast)}
