"""Plain reference of a fit's steps on the fused gradient path.

From a config dict this module works out, in plain PyTorch, what the
port's ``make_fused_differentiable(config)`` gives and what a fit does
with it: the parameter vector (24 slots an optic: origin, basis, radius,
crystal spacing, rocking FWHM, reflectivity, minor radius), the
weight-mode bilinear images of ``forward(pvec, seed)`` (a frozen copy of
the plain twin of kernel K5f, cut to point sources through planes and
spheres with gaussian crystals), and the gradient of ``sum(g * images)``
by autograd through that forward, where the port has the hand adjoint of
kernel K5b. The rays are the kernels' Philox stream keyed by the seed's
two words, so both sides trace the same rays. The static constants
(bounds, pixels, apertures, the source's cone) come from
``raytrace.build``, read from the config again.

``follow`` runs a fit's first steps as the benchmark's fit loop does:
targets from the parameters plus an offset, then for each step the
forward, the L2 loss, its cotangent images, the gradient and Adam's
update of the trainable slots; and, given a later step's parameters as
the program held them, that step's loss and gradient. ``dtype`` computes the forward and the
gradient in another floating type (the lower-precision control); the
images are then summed, and the loss and the update taken, in float32.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from reference import raytrace as rt

SLOTS = 24
EPS = 1e-12
SIGMA_PER_FWHM = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))


def seed_words(seed: int) -> tuple:
    """The two 32-bit Philox key words of an int seed."""
    w = np.random.SeedSequence(int(seed)).generate_state(2, np.uint32)
    return int(w[0]), int(w[1])


def pack(config: dict) -> torch.Tensor:
    """The parameter vector of ``config`` (float32, padded to a multiple of
    8): each optic's pose in float64 from the config, rounded once."""
    vals = []
    for p in config["optics"].values():
        origin, basis = rt.frame(p)
        vals += list(origin) + list(basis.reshape(-1))
        vals += [float(p.get("radius", p.get("radius_major", 0.0))),
                 float(p.get("crystal_spacing", 0.0)), float(p.get("rocking_fwhm", 0.0)),
                 float(p.get("reflectivity", 1.0)), float(p.get("radius_minor", 0.0))]
        vals += [0.0] * (SLOTS - 17)
    vals += [0.0] * (-len(vals) % 8)
    return torch.tensor(np.asarray(vals, np.float64).astype(np.float32))


def static(config: dict) -> dict:
    """The run's packed constants (``raytrace.build`` of the config in mc
    mode: the same floats), its image specs and ray count; a weight-mode
    crystal draws nothing, so the draws are the source's."""
    config = copy.deepcopy(config)
    config.setdefault("general", {}).update(interact_mode="mc", image_mode="nearest")
    run = rt.build(config)
    if run["source"]["kind"] != 0:
        raise NotImplementedError("a fit reference of a plasma")
    run["n_draws"] = run["source"]["n_draws"]
    run["n_total"] = run["source"]["num_rays"] * run["num_iter"]
    return run


def _optic(F, I, e, P, lam, state):
    """Weight-mode forward of optic ``e``: the state leaving it and its
    image's (weight, fx, fy), or None."""
    px, py, pz, dx, dy, dz, w, alive = state
    o = F[rt.SRC_F + e * rt.OPT_F: rt.SRC_F + (e + 1) * rt.OPT_F]
    oi = I[18 + e * 16: 18 + (e + 1) * 16]
    b = e * SLOTS
    oxp, oyp, ozp = P[b], P[b + 1], P[b + 2]
    bxx, bxy, bxz = P[b + 3], P[b + 4], P[b + 5]
    byx, byy, byz = P[b + 6], P[b + 7], P[b + 8]
    bzx, bzy, bzz = P[b + 9], P[b + 10], P[b + 11]
    if oi[0] == rt.PLANE:
        D = dx * bzx + dy * bzy + dz * bzz
        D = torch.where(torch.abs(D) > 1e-30, D, 1e-30)
        N = (oxp - px) * bzx + (oyp - py) * bzy + (ozp - pz) * bzz
        t = N / D
        mask = alive & (t >= 0.0)
    elif oi[0] == rt.SPHERE:
        r = P[b + 12]
        sign = -1.0 if oi[1] else 1.0
        Cx, Cy, Cz = oxp + sign * r * bzx, oyp + sign * r * bzy, ozp + sign * r * bzz
        Lx, Ly, Lz = Cx - px, Cy - py, Cz - pz
        t_ca = Lx * dx + Ly * dy + Lz * dz
        d2 = Lx * Lx + Ly * Ly + Lz * Lz - t_ca * t_ca
        r2 = r * r
        mask = alive & (d2 <= r2)
        t_hc = torch.sqrt(torch.clamp_min(r2 - d2, EPS))
        t = t_ca - t_hc if oi[1] else t_ca + t_hc
    else:
        raise NotImplementedError("a fit reference of a torus")
    qx, qy, qz = px + t * dx, py + t * dy, pz + t * dz
    if oi[0] == rt.PLANE:
        nxv, nyv, nzv = bzx, bzy, bzz
    else:
        inv_r = 1.0 / torch.clamp_min(r, EPS)
        nxv, nyv, nzv = (Cx - qx) * inv_r, (Cy - qy) * inv_r, (Cz - qz) * inv_r
    rxq, ryq, rzq = qx - oxp, qy - oyp, qz - ozp
    lxv = rxq * bxx + ryq * bxy + rzq * bxz
    lyv = rxq * byx + ryq * byy + rzq * byz
    if oi[4] & 1:
        mask = mask & (torch.abs(lxv) < o[16])
    if oi[4] & 2:
        mask = mask & (torch.abs(lyv) < o[17])
    if oi[4] & 4:
        mask = mask & (torch.abs(rxq * bzx + ryq * bzy + rzq * bzz) < o[18])
    mask = rt._apertures(F, I, oi, lxv, lyv, mask)
    if oi[2] == rt.CRYSTAL:
        dot = dx * nxv + dy * nyv + dz * nzv
        d_s = P[b + 13]
        sin_b = torch.clamp(lam / (2.0 * torch.clamp_min(d_s, EPS)), 0.0, 1.0)
        cos_b = torch.sqrt(torch.clamp_min(1.0 - sin_b * sin_b, EPS))
        adot = torch.abs(dot)
        cosi = torch.sqrt(torch.clamp_min(1.0 - adot * adot, EPS))
        sd = adot * cos_b - cosi * sin_b
        delta = sd + sd * sd * sd * (1.0 / 6.0)
        sigma = torch.clamp_min(P[b + 14] * SIGMA_PER_FWHM, EPS)
        z = delta / sigma
        w = torch.where(mask, w * (P[b + 15] * torch.exp(-0.5 * z * z)), w)
        kk = 2.0 * dot
        dx = torch.where(mask, dx - kk * nxv, dx)
        dy = torch.where(mask, dy - kk * nyv, dy)
        dz = torch.where(mask, dz - kk * nzv, dz)
    image = None
    if oi[7] >= 0:
        image = (torch.where(mask, w, 0.0), lxv * o[23] + o[24], lyv * o[23] + o[25])
    return (qx, qy, qz, dx, dy, dz, w, mask), image


def _splat(flat, nx: int, ny: int, w, fx, fy):
    """Add the bilinear splat of the hits to ``flat`` (float32): each ray's
    weight over its four neighbouring pixels, coordinates clipped to
    [-2, n + 1]."""
    fx, fy = torch.clamp(fx, -2.0, nx + 1.0), torch.clamp(fy, -2.0, ny + 1.0)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    for cx, wx in ((x0, 1.0 - tx), (x0 + 1.0, tx)):
        for cy, wy in ((y0, 1.0 - ty), (y0 + 1.0, ty)):
            ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
            idx = cx[ok].long() * ny + cy[ok].long()
            flat = flat.index_put((idx,), (w * wx * wy)[ok].to(flat.dtype), accumulate=True)
    return flat


def forward_slices(run: dict, P: torch.Tensor, words: tuple, slice_rays: int):
    """Per slice of rays, the flat images ``{optic index: [nx * ny]}``
    (float32) of that slice, differentiable in ``P`` (computed in its dtype)."""
    F, I = run["F"], run["I"]
    lam = torch.tensor(run["source"]["wavelength"], dtype=P.dtype, device=P.device)
    for start in range(0, run["n_total"], slice_rays):
        rays = torch.arange(start, min(start + slice_rays, run["n_total"]), dtype=torch.int64,
                            device=P.device)
        draw = iter(rt.philox_uniforms(rays, run["n_draws"], words, P.dtype)).__next__

        def full(value, rays=rays):
            return torch.full(rays.shape, value, dtype=P.dtype, device=P.device)

        state = (*rt.point_source(F, I, draw, full), full(1.0),
                 torch.ones_like(rays, dtype=torch.bool))
        out = {}
        for e in range(I[0]):
            state, image = _optic(F, I, e, P, lam, state)
            if image is not None:
                nx, ny = I[18 + e * 16 + 8], I[18 + e * 16 + 9]
                zero = torch.zeros(nx * ny, dtype=torch.float32, device=P.device)
                out[e] = _splat(zero, nx, ny, *image)
        yield out


def forward(run: dict, pvec: torch.Tensor, words: tuple, dtype, slice_rays: int) -> dict:
    """The images ``{optic name: [nx, ny]}`` (float32) of ``pvec``."""
    P = pvec.detach().to(dtype)
    total = {}
    with torch.no_grad():
        for part in forward_slices(run, P, words, slice_rays):
            for e, flat in part.items():
                total[e] = total[e] + flat if e in total else flat
    names = run["names"][1:]
    return {names[e]: flat.reshape(run["I"][18 + e * 16 + 8], run["I"][18 + e * 16 + 9])
            for e, flat in total.items()}


def gradient(run: dict, pvec: torch.Tensor, words: tuple, cotangents: dict, dtype,
             slice_rays: int) -> torch.Tensor:
    """The gradient of ``sum(g * images)`` in ``pvec`` (float64), by
    autograd through the forward, slice by slice."""
    names = run["names"][1:]
    total = torch.zeros(pvec.numel(), dtype=torch.float64, device=pvec.device)
    P = pvec.detach().to(dtype).requires_grad_(True)
    for part in forward_slices(run, P, words, slice_rays):
        s = sum((cotangents[names[e]].reshape(-1) * flat).sum() for e, flat in part.items())
        (g,) = torch.autograd.grad(s, P)
        total += g.double()
    return total


def loss_and_gradient(run: dict, pvec: torch.Tensor, words: tuple, targets: dict, dtype,
                      slice_rays: int) -> tuple:
    """A step's L2 loss against ``targets`` (float32) and its gradient in
    ``pvec`` (float64), as the benchmark's fit loop takes them."""
    images = forward(run, pvec, words, dtype, slice_rays)
    loss, cotangents = 0.0, {}
    for name, t in targets.items():
        diff = images[name] - t
        loss = loss + torch.mean(diff * diff)
        cotangents[name] = (diff * (2.0 / diff.numel())).to(dtype)
    return float(loss), gradient(run, pvec, words, cotangents, dtype, slice_rays)


def follow(config: dict, slots: list, offset: np.ndarray, learning_rate: float,
           target_seed: int, step_seeds: list, device, dtype=torch.float32,
           slice_rays: int = 1 << 22, last=None) -> dict:
    """The fit's first steps: ``{"losses": [...], "grad": the first step's
    gradient of the trainable slots, "change": their change over the
    steps}`` (float64 numpy). ``last``, a later step's ``(pvec, seed)``
    (the parameters the program traced it at), adds ``"last": {"loss",
    "grad"}`` of that step."""
    run = static(config)
    pvec0 = pack(config).to(device)
    index = torch.as_tensor(slots, device=device)
    target = pvec0 + torch.as_tensor(offset, dtype=torch.float32, device=device)
    targets = forward(run, target, seed_words(target_seed), dtype, slice_rays)
    theta = pvec0[index].clone()
    theta0 = theta.clone()
    opt = torch.optim.Adam([theta], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    losses, first = [], None
    for k, seed in enumerate(step_seeds):
        pvec = pvec0.clone()
        pvec[index] = theta.detach()
        loss, g = loss_and_gradient(run, pvec, seed_words(seed), targets, dtype, slice_rays)
        theta.grad = g[index].to(theta.dtype)
        opt.step()
        losses.append(loss)
        if k == 0:
            first = (opt.state[theta]["exp_avg"] / 0.1).double().cpu().numpy()
    out = {"losses": losses, "grad": first,
           "change": (theta - theta0).detach().double().cpu().numpy()}
    if last is not None:
        pvec, seed = last
        loss, g = loss_and_gradient(run, torch.as_tensor(pvec, device=device), seed_words(seed),
                                    targets, dtype, slice_rays)
        out["last"] = {"loss": loss, "grad": g[index].cpu().numpy()}
    return out
