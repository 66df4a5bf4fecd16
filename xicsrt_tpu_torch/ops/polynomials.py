"""Closed-form polynomial solvers on tensors (``xicsrt_tpu/ops/polynomials.py``).

Real arithmetic with validity masks instead of complex dtypes, selections
instead of boolean indexing, and a final Newton polish of every quartic
root on the original polynomial so float32 reaches the accuracy of the
reference's float64 solver. Real roots come back in ascending order with
NaN (complex or missing roots) last.
"""

from __future__ import annotations

import torch

_TINY = 1e-30


def _guard(x: torch.Tensor, cond: torch.Tensor, value: float) -> torch.Tensor:
    return torch.where(cond, x, torch.full_like(x, value))


def solve_quadratic(a, b, c):
    """Roots of a x^2 + b x + c = 0, elementwise: (x0, x1, valid) with
    x0 <= x1, NaN where complex; the citardauq form avoids cancellation."""
    disc = b * b - 4.0 * a * c
    valid = disc >= 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    sgn = torch.where(b >= 0.0, 1.0, -1.0).to(b.dtype)
    q = -0.5 * (b + sgn * sq)
    x0 = q / _guard(a, torch.abs(a) > _TINY, _TINY)
    x1 = c / _guard(q, torch.abs(q) > _TINY, _TINY)
    x1 = torch.where(torch.abs(q) > _TINY, x1, x0)
    lo = torch.minimum(x0, x1)
    hi = torch.maximum(x0, x1)
    nan = torch.full_like(lo, float("nan"))
    return torch.where(valid, lo, nan), torch.where(valid, hi, nan), valid


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def cubic_largest_real_root(b, c, d):
    """Largest real root of x^3 + b x^2 + c x + d = 0, elementwise: Cardano
    for one real root, the trigonometric form for three, one Newton step."""
    b2 = b * b
    P = c - b2 / 3.0
    Q = d - b * c / 3.0 + 2.0 * b2 * b / 27.0

    half_q = 0.5 * Q
    third_p = P / 3.0
    disc = half_q * half_q + third_p * third_p * third_p

    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_one = _cbrt(-half_q + sq) + _cbrt(-half_q - sq)

    rho = torch.sqrt(torch.clamp_min(-third_p, _TINY))
    cos_arg = torch.clamp(-half_q / torch.clamp_min(rho**3, _TINY), -1.0, 1.0)
    t_three = 2.0 * rho * torch.cos(torch.arccos(cos_arg) / 3.0)

    x = torch.where(disc >= 0.0, t_one, t_three) - b / 3.0
    f = ((x + b) * x + c) * x + d
    df = (3.0 * x + 2.0 * b) * x + c
    return x - f / _guard(df, torch.abs(df) > _TINY, _TINY)


def _quartic_newton_polish(x, c0, c1, c2, c3, c4, iters=2):
    """Newton-polish roots of c0 x^4 + ... + c4, keeping NaN roots NaN."""
    for _ in range(iters):
        f = (((c0 * x + c1) * x + c2) * x + c3) * x + c4
        df = ((4.0 * c0 * x + 3.0 * c1) * x + 2.0 * c2) * x + c3
        xn = x - f / _guard(df, torch.abs(df) > _TINY, _TINY)
        x = torch.where(torch.isfinite(xn), xn, x)
    return x


def solve_quartic_unsorted(c0, c1, c2, c3, c4):
    """Real roots of c0 x^4 + ... + c4, elementwise: a list of 4 unsorted
    tensors, NaN where complex (Ferrari through the resolvent cubic)."""
    inv_c0 = 1.0 / _guard(c0, torch.abs(c0) > _TINY, _TINY)
    a = c1 * inv_c0
    b = c2 * inv_c0
    c = c3 * inv_c0
    d = c4 * inv_c0

    # Depress: x = y - a/4 -> y^4 + p y^2 + q y + r.
    a2 = a * a
    p = b - 3.0 * a2 / 8.0
    q = c - a * b / 2.0 + a2 * a / 8.0
    r = d - a * c / 4.0 + a2 * b / 16.0 - 3.0 * a2 * a2 / 256.0

    # Resolvent cubic: m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0.
    m = torch.clamp_min(cubic_largest_real_root(p, 0.25 * p * p - r, -q * q / 8.0), 0.0)
    s2 = 2.0 * m
    s = torch.sqrt(torch.clamp_min(s2, 0.0))
    use_biquad = s2 <= 1e-12 * (1.0 + torch.abs(p))

    # Ferrari factorization (y^2 + s y + A)(y^2 - s y + B).
    q_over_s = q / _guard(s, s > _TINY, _TINY)
    A = 0.5 * (p + s2 - q_over_s)
    B = 0.5 * (p + s2 + q_over_s)
    ones = torch.ones_like(s)
    y0a, y1a, _ = solve_quadratic(ones, s, A)
    y0b, y1b, _ = solve_quadratic(ones, -s, B)

    # Biquadratic fallback (q ~ 0): z^2 + p z + r = 0, y = +-sqrt(z).
    z0, z1, _ = solve_quadratic(ones, p, r)
    nan = torch.full_like(p, float("nan"))

    def sqrt_pair(z):
        ok = z >= 0.0
        sz = torch.sqrt(torch.clamp_min(z, 0.0))
        return torch.where(ok, -sz, nan), torch.where(ok, sz, nan)

    b0m, b0p = sqrt_pair(z0)
    b1m, b1p = sqrt_pair(z1)
    y_roots = [
        torch.where(use_biquad, b0m, y0a),
        torch.where(use_biquad, b0p, y1a),
        torch.where(use_biquad, b1m, y0b),
        torch.where(use_biquad, b1p, y1b),
    ]
    shift = a / 4.0
    return [_quartic_newton_polish(y - shift, c0, c1, c2, c3, c4) for y in y_roots]


def solve_quartic(c0, c1, c2, c3, c4):
    """Real roots of c0 x^4 + c1 x^3 + c2 x^2 + c3 x + c4 = 0, elementwise:
    ``[..., 4]`` ascending, NaN last (``torch.sort`` orders NaN last)."""
    roots = torch.stack(solve_quartic_unsorted(c0, c1, c2, c3, c4), dim=-1)
    return torch.sort(roots, dim=-1).values
