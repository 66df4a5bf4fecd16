"""The fit mixes: a closed loop of gradient steps of the fused path.

A fit mix (``traffic/<name>.json`` with ``"entry": "fit"``) holds:

- ``intensity_scale``: a factor on the configuration's source load;
- ``learning_rate``: Adam's (betas 0.9, 0.999, eps 1e-8, as the
  program's ``gradients.align``);
- ``trainable``: ``{optic: [leaf, ...]}``, the leaves Adam moves;
- ``target_offset``: ``{optic: {leaf: value or list}}``, added to the
  configuration's parameters to make the target images;
- ``check_steps``: the first steps, run in set-up, that the reference
  follows.

One object, built in set-up, holds the program's ``forward`` and ``vjp``
(``make_fused_differentiable``), the parameter vector, the target images
and Adam's state. A step is the forward on a fresh seed, the L2 loss
against the targets (the mean square of each image's difference, summed
over the images), its cotangent images, the vjp and Adam's update, ended
by a synchronise. Set-up makes the targets on a seed of their own and runs
the first ``check_steps`` steps; the window runs on from there on the same
object. The check follows the first steps from the configuration, and
works the window's last step out again at the parameters the program
traced it at.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from harness import traffic

# The parameter vector of ``make_fused_differentiable``: 24 slots an
# optic, in the configuration's order, its leaves at these offsets.
SLOTS_PER_OPTIC = 24
LEAF_SLOTS = {"origin": range(0, 3), "basis": range(3, 12), "radius": range(12, 13),
              "crystal_spacing": range(13, 14), "rocking_fwhm": range(14, 15),
              "reflectivity": range(15, 16), "radius_minor": range(16, 17)}
BETAS = (0.9, 0.999)


def leaves(config: dict, fit: dict) -> list:
    """``[(name, [slot, ...]), ...]`` of the trainable leaves."""
    optics = list(config["optics"])
    return [(f"{optic}.{leaf}", [optics.index(optic) * SLOTS_PER_OPTIC + k
                                 for k in LEAF_SLOTS[leaf]])
            for optic, names in fit["trainable"].items() for leaf in names]


def offset(config: dict, fit: dict, n_slots: int):
    """The target's offset from the configuration, slot by slot (float64)."""
    optics = list(config["optics"])
    out = np.zeros(n_slots)
    for optic, by_leaf in fit["target_offset"].items():
        for leaf, value in by_leaf.items():
            slots = [optics.index(optic) * SLOTS_PER_OPTIC + k for k in LEAF_SLOTS[leaf]]
            out[slots] = value
    return out


def grad_config(cell, seed: int) -> dict:
    """The configuration a fit builds on: the cell's, its load scaled by the
    mix (the steps' seeds key the rays; its ``random_seed`` is unused)."""
    return traffic.call_config(cell, seed, traffic.TARGET, 0)


def seeds(seed: int, n: int) -> tuple:
    """The target's seed and the first ``n`` steps' of the run ``seed``."""
    return (traffic.stream_seed(seed, traffic.TARGET, 0),
            [traffic.stream_seed(seed, traffic.WARMUP, k) for k in range(n)])


class Steps:
    """The fit loop of one run (see the module's docstring)."""

    def __init__(self, cell, seed: int, devices: list, plant=None):
        self.cell, self.seed = cell, seed
        self.device = "cuda" if devices[0].startswith("cuda") else devices[0]
        self.fit = cell.traffic
        self.plant = plant  # a test's or the control's fault, planted in set-up
        self.first = None   # the first steps' readings
        self.last = None    # the window's last step: (seed, loss, gradient vector)
        self.program = self.last_at = None  # what the check compares, kept by free()

    def warm(self) -> None:
        import torch

        import xicsrt_tpu_torch as program

        if self.plant is not None:
            self.plant()
        config = grad_config(self.cell, self.seed)
        forward, vjp, pack, pipeline = program.make_fused_differentiable(
            config, device=self.device)
        self.forward, self.vjp = forward, vjp
        pvec0 = pack(pipeline.params).detach()
        self.slots = [k for _, s in leaves(config, self.fit) for k in s]
        self.index = torch.as_tensor(self.slots, device=pvec0.device)
        target = pvec0 + torch.as_tensor(offset(config, self.fit, pvec0.numel()),
                                         dtype=pvec0.dtype, device=pvec0.device)
        target_seed, step_seeds = seeds(self.seed, int(self.fit["check_steps"]))
        self.targets = {k: v.detach() for k, v in forward(target, target_seed)["image"].items()}
        self.pvec = pvec0.clone()
        self.theta = pvec0[self.index].clone()
        theta0 = self.theta.clone()
        self.opt = torch.optim.Adam([self.theta], lr=float(self.fit["learning_rate"]),
                                    betas=BETAS, eps=1e-8)
        losses = []
        for k, step_seed in enumerate(step_seeds):
            losses.append(float(self.step(step_seed)))
            if k == 0:
                first_grad = self.opt.state[self.theta]["exp_avg"] / (1.0 - BETAS[0])
        self.first = {"losses": losses,
                      "grad": first_grad.double().cpu().numpy(),
                      "change": (self.theta - theta0).double().cpu().numpy()}
        self.n_rays = int(pipeline.source.num_rays) * int(pipeline.general["number_of_iter"])
        self.last = None

    def step(self, seed: int, spans=None):
        """One fit step on the rays of ``seed``; returns the loss (a tensor)."""
        import torch

        t0 = time.perf_counter()
        self.pvec[self.index] = self.theta.detach()
        images = self.forward(self.pvec, seed)["image"]
        t1 = time.perf_counter()
        loss, cotangents = 0.0, {}
        for name, target in self.targets.items():
            diff = images[name] - target
            loss = loss + torch.mean(diff * diff)
            cotangents[name] = diff * (2.0 / diff.numel())
        gvec = self.vjp(self.pvec, seed, cotangents)
        t2 = time.perf_counter()
        self.theta.grad = gvec[self.index].to(self.theta.dtype)
        self.opt.step()
        if self.theta.is_cuda:
            torch.cuda.synchronize(self.theta.device)
        if spans is not None:
            spans += [("forward", t0, t1), ("vjp", t1, t2), ("update", t2, time.perf_counter())]
        self.last = (seed, loss, gvec)
        return loss

    def window(self, seconds: float, spans=None) -> tuple:
        """Steps until one ends ``seconds`` or more after the first began:
        (steps, failed, (start, end)), each step's index, times and rays.
        ``self.pvec`` keeps the parameters the last step traced."""
        steps, failed, self.last = [], 0, None
        start = time.perf_counter()
        index = 0
        while True:
            t0 = time.perf_counter()
            try:
                self.step(traffic.stream_seed(self.seed, traffic.WINDOW, index), spans)
                ok = True
            except Exception:  # a failed step counts against the run and the loop goes on
                traceback.print_exc(file=sys.stderr)
                failed, ok, self.last = failed + 1, False, None
            t1 = time.perf_counter()
            if ok:
                steps.append({"index": index, "t0": t0, "t1": t1, "rays": self.n_rays})
            index += 1
            if t1 - start >= seconds:
                return steps, failed, (start, t1)

    def free(self) -> None:
        """Keep what the check reads, on the host, and drop the rest."""
        self.program = dict(self.first)
        if self.last is not None:
            seed, loss, gvec = self.last
            self.program["last"] = {"loss": float(loss),
                                    "grad": gvec[self.index].double().cpu().numpy()}
            self.last_at = (self.pvec.detach().cpu(), seed)
        self.forward = self.vjp = self.targets = self.opt = self.theta = self.last = None

    def check(self, devices: list) -> dict:
        """The first steps' and the last step's readings against the
        reference's, numbers only."""
        from harness import check

        config = grad_config(self.cell, self.seed)
        ref = self.cell.reference.follow(
            config, self.slots, offset(config, self.fit, self.pvec.numel()),
            float(self.fit["learning_rate"]), *seeds(self.seed, int(self.fit["check_steps"])),
            device=devices[0], last=self.last_at)
        return check.fit_numbers(self.program, ref, leaves(config, self.fit))
