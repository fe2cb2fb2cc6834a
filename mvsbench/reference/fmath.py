"""Elementwise functions whose rounding depends on the math library, and
the small products of the geometry, in a form that rounds alike on every
host.

PyTorch built with MKL sends ``exp``, ``acos``, ``sqrt`` (float32 and
float64), ``log`` and ``tanh`` on CPU tensors to MKL's vector math library,
and ``einsum`` / ``@`` to its BLAS.  MKL picks a code path, and with it a
rounding, by CPU vendor and instruction set: the results on an Intel host
with AVX-512 differ in the last bits from those on an AMD host or under
``MKL_CBWR=COMPATIBLE`` (tests/test_torch_host.py holds the port to one
answer under both).  So on CPU float32 tensors this module computes with
plain IEEE arithmetic (``+ - * /``, comparisons and exact scalings, which
no library rounds its own way):

* ``sqrt`` is correctly rounded (as XLA's and CUDA's): float64's square
  root rounded to float32, then moved by one ulp where the exact squares
  of the neighbouring midpoints say so.  ``norm`` and ``hypot`` are built
  on it with the formulas ``jnp.linalg.norm`` and ``jnp.hypot`` use.
* ``exp`` and ``acos`` evaluate a polynomial in float64 (error ~1e-16)
  and round once to float32: correctly rounded but for inputs within
  ~1e-16 of a rounding boundary.

On the card they are PyTorch's.  ``exp``, ``sin``, ``cos``, ``acos``,
``rsqrt`` and ``sigmoid`` round differently in each library (JAX's are
XLA's polynomials); the port's plain versions call them through this
module, so that a test can put JAX's functions in their place and hold the
port's order of operations to JAX's bit for bit.

The 3x3 and 3-vector products of the geometry (``matvec``, ``rmatvec``,
``matmul``, ``matmul_bt``) are written as elementwise products and sums,
which call no BLAS and are not contracted into FMA, on the CPU and on the
card alike.  The order is XLA's on the CPU for the same ``jnp.einsum``
compiled without LLVM's optimiser (as the parity tests compile JAX): the
products in the order of the contracted index, summed left to right,
``(p0 + p1) + p2``.  XLA's default pipeline contracts the same sums into
an FMA chain ``fma(a2, b2, fma(a1, b1, a0 * b0))``, which no order of
separate ops equals.
"""

from __future__ import annotations

import math

import torch


def _cpu32(x: torch.Tensor) -> bool:
    return x.device.type == "cpu" and x.dtype == torch.float32


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root."""
    if not _cpu32(x):
        return torch.sqrt(x)
    s = torch.sqrt(x.double()).to(torch.float32)      # within one ulp
    xd, sd = x.double(), s.double()
    up = torch.nextafter(s, torch.full_like(s, math.inf))
    dn = torch.nextafter(s, torch.zeros_like(s))
    # the midpoints have 25 significant bits: their squares are exact
    hi = (sd + up.double()) * 0.5
    lo = (sd + dn.double()) * 0.5
    s = torch.where(xd > hi * hi, up, s)
    return torch.where(xd < lo * lo, dn, s)


def norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False
         ) -> torch.Tensor:
    """Euclidean norm as ``jnp.linalg.norm``: sqrt(sum(x * x))."""
    return sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """hypot by the formula ``jnp.hypot`` uses (max * sqrt(1 + (min/max)^2)),
    so that threshold tests on it round as in JAX."""
    a, b = torch.abs(a), torch.abs(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0
    q = lo / torch.where(zero, torch.ones_like(hi), hi)
    out = torch.where(zero, hi, hi * sqrt(1 + q * q))
    return torch.where(torch.isinf(a) | torch.isinf(b),
                       torch.full_like(out, float("inf")), out)


# fdlibm's split of ln 2: the high part has 32 significant bits, so k times
# it is exact for |k| < 2^21
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_EXP_TAYLOR = [1.0 / math.factorial(n) for n in range(14)]
# asin(s) = s + s z (c1 + c2 z + ...), z = s^2, c_n = (2n)! / (4^n n!^2 (2n+1))
_ASIN_TAYLOR = [math.comb(2 * n, n) / (4 ** n * (2 * n + 1))
                for n in range(1, 28)]


def _horner(coeffs, z: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(z, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        p = p * z + c
    return p


def exp(x: torch.Tensor) -> torch.Tensor:
    if not _cpu32(x):
        return torch.exp(x)
    # x = k ln2 + r, |r| <= ln2 / 2; degree-13 Taylor of exp(r) (remainder
    # < 4e-18); 2^k from its exponent bits (exact)
    xd = torch.clamp(x.double(), -200.0, 200.0)
    k = torch.round(xd * (1.0 / math.log(2.0)))
    r = (xd - k * _LN2_HI) - k * _LN2_LO
    kb = torch.nan_to_num(k).to(torch.int64)
    scale = ((kb + 1023) << 52).view(torch.float64)
    y = (_horner(_EXP_TAYLOR, r) * scale).to(torch.float32)
    return torch.where(torch.isnan(x), x, y)


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x)


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x)


def acos(x: torch.Tensor) -> torch.Tensor:
    if not _cpu32(x):
        return torch.acos(x)
    # |x| <= 1/2: pi/2 - asin(x); else 2 asin(sqrt((1 - |x|) / 2)) (the
    # argument is exact in float32; its root is refined from the correctly
    # rounded float32 root by two Newton steps in float64), mirrored for
    # x < 0; the asin series to z^27 <= 4^-27 (remainder < 1e-18)
    xd = x.double()
    a = torch.abs(xd)
    small = a <= 0.5
    zb = (1.0 - a) * 0.5
    sb = sqrt(zb.to(torch.float32)).double()
    for _ in range(2):
        sb = 0.5 * (sb + zb / sb)
    sb = torch.where(zb == 0, zb, sb)
    z = torch.where(small, xd * xd, zb)
    s = torch.where(small, xd, sb)
    asin = s + s * z * _horner(_ASIN_TAYLOR, z)
    big = 2.0 * asin
    big = torch.where(xd < 0, math.pi - big, big)
    return torch.where(small, math.pi / 2 - asin, big).to(torch.float32)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def _sum3(terms):
    p0, p1, p2 = terms
    return (p0 + p1) + p2


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("...ij,...j->...i", m, v)``: M v."""
    return _sum3([m[..., :, j] * v[..., None, j] for j in range(3)])


def rmatvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("...ji,...j->...i", m, v)``: M^T v."""
    return _sum3([m[..., j, :] * v[..., None, j] for j in range(3)])


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum("...ij,...jk->...ik", a, b)``: A B."""
    return _sum3([a[..., :, j, None] * b[..., None, j, :] for j in range(3)])


def matmul_bt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum("...ik,jk->...ij", a, b)``: A B^T."""
    return _sum3([a[..., :, k, None] * b[..., None, :, k] for k in range(3)])
