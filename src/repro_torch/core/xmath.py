"""XLA's float32 transcendental functions, as its CPU backend computes
them, on torch float32 tensors.

The reference draws programming noise as ``exp(log(g) - sigma**2/2 +
sigma * z)`` with ``z = sqrt(2) * erf_inv(u)``.  XLA evaluates ``log``,
``exp``, ``log1p`` and ``erf_inv`` with polynomials of its own (Cephes'
``logf`` / ``expf`` and log1p, Giles' ``erf_inv``), and its CPU backend
fuses every multiply that feeds one add into a fused multiply-add.
PyTorch's ``log`` / ``exp`` round differently, and since ``log(g)`` is
about -11.5, one ulp of it is a relative change of 1e-6 in a programmed
conductance; through the ADC and the quantisers of a training loop that
grows into different codes.  So the port evaluates the same polynomials
in the same order, with :func:`fma` where XLA fuses: the noise then
equals the reference's bit for bit on the CPU
(``tests/test_torch_prng.py``).  Inputs are finite float32 tensors in
each function's domain (the callers' are); no special-value handling
beyond what the callers need.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["fma", "log", "log1p", "exp", "erf_inv"]


def _f(v: float) -> float:
    """``v`` rounded to float32 (the constants are float32 literals)."""
    return float(np.float32(v))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once, as a fused multiply-add.

    float64 holds the product of two float32 values exactly, so the sum
    is rounded first to float64 and then to float32.  That second
    rounding goes wrong only where the first lands exactly halfway
    between two float32 values without being exact; there the float64
    sum is moved one float64 ulp towards the exact sum (its error by
    Knuth's two-sum), which then rounds correctly.  Results in the
    float32 normal range; the operands broadcast as ``torch.addcmul``'s."""
    dev = a.device
    a64 = a.double()
    b64 = torch.as_tensor(b, dtype=torch.float64, device=dev)
    c64 = torch.as_tensor(c, dtype=torch.float64, device=dev)
    s = torch.addcmul(c64, a64, b64)
    bits = s.view(torch.int64)
    tie = (bits & _LOW29) == _HALF29
    if bool(tie.any()):
        p = a64 * b64
        bb = s - p
        err = (p - (s - bb)) + (c64 - bb)
        step = torch.where((err > 0) == (s > 0), 1, -1)
        s = torch.where(tie & (err != 0), bits + step, bits).view(torch.float64)
    return s.float()


# the 29 low mantissa bits that float64 has and float32 has not, and
# their pattern halfway between two float32 values
_LOW29 = (1 << 29) - 1
_HALF29 = 1 << 28


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma(p, x, _f(c))
    return p


def log(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` (Cephes ``logf``): ``y = m * 2**e`` with
    ``m`` in ``[sqrt(1/2), sqrt(2))``, then ``log(1 + x)`` for ``x = m -
    1`` by a degree-9 polynomial.  Positive normal ``y``."""
    bits = y.view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _f(0.707106781186547524)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0 - small.to(torch.float32)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    y0 = fma(fma(x, _f(7.0376836292e-2), _f(-1.1514610310e-1)), x, _f(1.1676998740e-1))
    y1 = fma(fma(x, _f(-1.2420140846e-1), _f(1.4249322787e-1)), x, _f(-1.6668057665e-1))
    y2 = fma(fma(x, _f(2.0000714765e-1), _f(-2.4999993993e-1)), x, _f(3.3333331174e-1))
    p = fma(fma(y0, x3, y1), x3, y2)
    p = fma(p, x3, e * _f(-2.12194440e-4))
    x = fma(x2, -0.5, x) + p
    return fma(e, 0.693359375, x)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp`` (Cephes ``expf``): ``x = n ln2 + r``, a
    degree-5 polynomial in ``r``, times ``2**n``."""
    x = torch.clamp(x, _f(-87.80000305175781), _f(88.80000305175781))
    n = torch.floor(fma(x, _f(1.4426950216293335), 0.5)).clamp(-127.0, 127.0)
    r = fma(n, -0.693359375, x)
    r = fma(n, _f(2.12194440e-4), r)
    p = fma(r, _f(1.9875691214110702e-4), _f(1.398199936375022e-3))
    for c in (8.333452045917511e-3, 4.166579619050026e-2, 1.666666567325592e-1, 0.5):
        p = fma(p, r, _f(c))
    p = fma(p, r * r, r) + 1.0
    return p * ((n.to(torch.int32) + 127) << 23).view(torch.float32)


# log1p below |x| < sqrt(2) - 1 (Cephes), highest degree first
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1,
)
_LOG1P_DEN = (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1,
)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: ``log(1 + x)``, or for ``|x| < sqrt(2) -
    1`` the Cephes rational approximation.  ``x > -1``."""
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + fma(x2, -0.5, (x * x2) * r)
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))


# erf_inv (stablehlo's chlo legalisation, Giles' single-precision fit)
_ERFINV_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` for ``x`` in (-1, 1)."""
    w = -log1p(x * -x)
    lt = w < 5.0
    # float64 sqrt rounds to the correctly rounded float32 sqrt (the CPU
    # build of torch.sqrt on float32 is not correctly rounded)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    coef = lambda i: torch.where(  # noqa: E731
        lt, x.new_tensor(_ERFINV_LT5[i]), x.new_tensor(_ERFINV_GE5[i])
    )
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, coef(i))
    return p * x
