"""Angular emission samplers on explicit uniforms (``xicsrt_tpu/ops/spread.py``).

Each sampler maps uniforms ``u, v`` in [0, 1) to ``[n, 3]`` unit vectors
whose mean emission axis is +z. The JAX samplers draw the same uniforms from
a key (``spread.py:58-62, 103-105``); taking them as arguments lets the
tests hand both packages the same numbers.

Every JAX sampler is here: ``isotropic``, ``isotropic_xy`` (closed form for
symmetric y-bounds, bracket-clamped Newton otherwise), ``flat``,
``flat_xy`` and ``gaussian`` (``flat_gaussian``), whose ``u, v`` are two
standard normals instead of uniforms.

Spread parsing follows the reference: 1 value -> symmetric in x/y, 2 values
-> [x, y] half-angles, 4 values -> [xmin, xmax, ymin, ymax].
"""

from __future__ import annotations

import math

import numpy as np
import torch


def parse_spread_single(spread) -> float:
    arr = np.atleast_1d(np.asarray(spread, dtype=np.float64))
    if arr.size != 1:
        raise ValueError("This distribution requires a single spread value.")
    return float(arr[0])


def parse_spread_xy(spread) -> tuple:
    arr = np.atleast_1d(np.asarray(spread, dtype=np.float64))
    if arr.size == 1:
        return (-float(arr[0]), float(arr[0]), -float(arr[0]), float(arr[0]))
    if arr.size == 2:
        return (-float(arr[0]), float(arr[0]), -float(arr[1]), float(arr[1]))
    if arr.size == 4:
        return tuple(float(v) for v in arr)
    raise ValueError("Spread must have 1, 2 or 4 elements.")


def sample_isotropic(u: torch.Tensor, v: torch.Tensor, spread) -> torch.Tensor:
    """Uniform-sphere directions within a cone of half-angle ``spread``:
    z uniform in [cos(theta), 1] from ``u``, azimuth from ``v``."""
    # The mapping of jax.random.uniform(minval, maxval): the span is
    # rounded to the uniforms' dtype before it scales them.
    cos_t = torch.tensor(math.cos(parse_spread_single(spread)), dtype=u.dtype)
    z = torch.maximum(u * (1.0 - cos_t) + cos_t, cos_t)
    phi = v * torch.tensor(2.0 * math.pi, dtype=v.dtype)
    rho = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), z], dim=-1)


def solid_angle_isotropic(spread) -> float:
    """Solid angle of the isotropic cone: 4 pi sin^2(theta/2)."""
    theta = parse_spread_single(spread)
    return 4.0 * math.pi * math.sin(theta / 2.0) ** 2


def _isotropic_xy_marginal(sx, sb0, sb1):
    """G(sx) = arcsin(sx*sin(ty1)) - arcsin(sx*sin(ty0))."""
    return torch.arcsin(torch.clamp(sx * sb1, -1.0, 1.0)) - torch.arcsin(
        torch.clamp(sx * sb0, -1.0, 1.0)
    )


def sample_isotropic_xy(u: torch.Tensor, v: torch.Tensor, spread,
                        newton_iters: int = 12) -> torch.Tensor:
    """Uniform-sphere directions restricted to an xy-rectangular angular window.

    In gnomonic coordinates (tx, ty) = (v_x/v_z, v_y/v_z) the window is a
    rectangle with density (1+tx^2+ty^2)^(-3/2): the marginal CDF in
    sin(alpha) is a difference of arcsins (closed-form inverse for
    symmetric y-bounds, Newton otherwise) and the conditional in ty is
    inverted exactly.
    """
    tx0, tx1, ty0, ty1 = parse_spread_xy(spread)
    for b in (tx0, tx1, ty0, ty1):
        if abs(b) >= math.pi / 2:
            raise ValueError("isotropic_xy spreads must be within (-pi/2, pi/2).")
    sx0, sx1 = math.sin(tx0), math.sin(tx1)
    sb0, sb1 = math.sin(ty0), math.sin(ty1)

    if sb0 == -sb1 and sb1 > 0.0:
        g0 = 2.0 * math.asin(sx0 * sb1)
        g1 = 2.0 * math.asin(sx1 * sb1)
        target = g0 + u * (g1 - g0)
        sx = torch.sin(target * 0.5) / sb1
    else:
        g0 = _isotropic_xy_marginal(torch.tensor(sx0, dtype=u.dtype), sb0, sb1)
        g1 = _isotropic_xy_marginal(torch.tensor(sx1, dtype=u.dtype), sb0, sb1)
        target = g0 + u * (g1 - g0)
        sx = sx0 + u * (sx1 - sx0)
        for _ in range(newton_iters):
            g = _isotropic_xy_marginal(sx, sb0, sb1)
            dg = sb1 / torch.sqrt(
                torch.clamp_min(1.0 - (sx * sb1) ** 2, 1e-12)
            ) - sb0 / torch.sqrt(torch.clamp_min(1.0 - (sx * sb0) ** 2, 1e-12))
            sx = torch.clamp(sx - (g - target) / torch.clamp_min(dg, 1e-12),
                             sx0, sx1)

    tx = sx / torch.sqrt(torch.clamp_min(1.0 - sx * sx, 1e-12))
    k2 = 1.0 + tx * tx
    k = torch.sqrt(k2)
    tyl = math.tan(ty0)
    tyh = math.tan(ty1)
    h0 = tyl / torch.sqrt(k2 + tyl * tyl)
    h1 = tyh / torch.sqrt(k2 + tyh * tyh)
    h = h0 + v * (h1 - h0)
    ty = k * h / torch.sqrt(torch.clamp_min(1.0 - h * h, 1e-12))
    w = 1.0 / torch.sqrt(1.0 + tx * tx + ty * ty)
    return torch.stack([tx * w, ty * w, w], dim=-1)


def uniform_range(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` of uniforms ``u`` in
    [0, 1): the bounds rounded to the uniforms' dtype, ``u * (hi - lo) +
    lo``, clipped below at ``lo``."""
    lo_t = torch.tensor(lo, dtype=u.dtype, device=u.device)
    span = torch.tensor(hi, dtype=u.dtype, device=u.device) - lo_t
    return torch.maximum(u * span + lo_t, lo_t)


def sample_flat(u: torch.Tensor, v: torch.Tensor, spread) -> torch.Tensor:
    """Uniform density on the z = 1 plane inside radius tan(theta): r =
    tan(theta) sqrt(u), azimuth from ``v`` (JAX ``spread.py:157-182``, the
    documented half-angle, not the reference's sqrt(tan) radius)."""
    r = math.tan(parse_spread_single(spread)) * torch.sqrt(u)
    phi = uniform_range(v, 0.0, 2.0 * math.pi)
    angle0 = torch.arctan(r)
    return torch.stack([torch.cos(phi) * torch.sin(angle0),
                        torch.sin(phi) * torch.sin(angle0), torch.cos(angle0)], dim=-1)


def sample_flat_xy(u: torch.Tensor, v: torch.Tensor, spread) -> torch.Tensor:
    """Uniform density over an xy rectangle of the z = 1 plane: x in
    [tan tx0, tan tx1] from ``u``, y in [tan ty0, tan ty1] from ``v``."""
    t = parse_spread_xy(spread)
    x = uniform_range(u, math.tan(t[0]), math.tan(t[1]))
    y = uniform_range(v, math.tan(t[2]), math.tan(t[3]))
    angle0 = torch.arctan(torch.sqrt(x * x + y * y))
    angle1 = torch.arctan2(y, x)
    return torch.stack([torch.cos(angle1) * torch.sin(angle0),
                        torch.sin(angle1) * torch.sin(angle0), torch.cos(angle0)], dim=-1)


def sample_flat_gaussian(gx: torch.Tensor, gy: torch.Tensor, spread) -> torch.Tensor:
    """Gaussian density on the z = 1 plane from two standard normals;
    ``spread`` is the angular HWHM, sigma = sin(hwhm / sqrt(2 ln 2))."""
    sigma = math.sin(parse_spread_single(spread) / math.sqrt(2.0 * math.log(2.0)))
    v = torch.stack([sigma * gx, sigma * gy, torch.ones_like(gx)], dim=-1)
    return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True))


def solid_angle_isotropic_xy(spread) -> float:
    """Solid angle of the xy-rectangular window (corner arcsin formula)."""
    t = parse_spread_xy(spread)
    return (
        math.asin(abs(math.sin(t[0]) * math.sin(t[2])))
        + math.asin(abs(math.sin(t[0]) * math.sin(t[3])))
        + math.asin(abs(math.sin(t[1]) * math.sin(t[2])))
        + math.asin(abs(math.sin(t[1]) * math.sin(t[3])))
    )


_SAMPLERS = {
    "isotropic": sample_isotropic,
    "isotropic_xy": sample_isotropic_xy,
    "flat": sample_flat,
    "flat_xy": sample_flat_xy,
    # The reference's 'gaussian' names the flat-gaussian sampler
    # (JAX spread.py:226-231).
    "gaussian": sample_flat_gaussian,
    "flat_gaussian": sample_flat_gaussian,
}
# Distributions whose two inputs are standard normals, not uniforms.
NORMAL_INPUTS = ("gaussian", "flat_gaussian")


def sample_direction(u, v, spread, name: str = "isotropic") -> torch.Tensor:
    """Dispatch by distribution name (mirrors ``vector_distribution``)."""
    name = (name or "isotropic").lower()
    if name not in _SAMPLERS:
        raise ValueError(f'Angular distribution "{name}" is not known.')
    return _SAMPLERS[name](u, v, spread)


def solid_angle(spread, name: str = "isotropic") -> float:
    """Solid angle matching a named distribution (mirrors ``solid_angle``)."""
    name = (name or "isotropic").lower()
    if name == "isotropic":
        return solid_angle_isotropic(spread)
    if name == "isotropic_xy":
        return solid_angle_isotropic_xy(spread)
    raise ValueError(f'Solid angle for "{name}" is not available.')
