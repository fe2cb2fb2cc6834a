"""Elementwise functions whose rounding depends on the math library.

IEEE 754 fixes ``+ - * /`` and the square root to the correctly rounded
result.  XLA and CUDA give it for the square root; PyTorch's vectorized CPU
``sqrt`` does not: it is an ulp off at a share of inputs that depends on
the host and the build (0.66 % of float32 inputs on one AVX-512 host with
torch 2.11, 17 % on another with torch 2.13; tests/torch_host_agreement.py).
So ``sqrt`` here
is correctly rounded on every device (on the CPU through float64, whose
rounding to float32 is exact for a square root), and ``norm`` and
``hypot`` are built on it with the formulas ``jnp.linalg.norm`` and
``jnp.hypot`` use.

``exp``, ``sin``, ``cos``, ``acos``, ``rsqrt`` and ``sigmoid`` are
correctly rounded in neither library: each library's polynomial is its own,
and both move with the host.  The port's plain versions call them through
this module, so that a test can put JAX's functions in their place and hold
the port's order of operations to JAX's bit for bit.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


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


def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x)


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x)


def acos(x: torch.Tensor) -> torch.Tensor:
    return torch.acos(x)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)
