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

A trainer differentiates through the replays: each is a
``torch.autograd.Function`` whose backward is JAX's own rule for the
primitive as XLA's CPU backend compiles it, not the derivative of the
polynomial that evaluates it:

* ``exp``: ``g * y`` (flushed below the normal range); ``log``: ``g /
  x``; ``log1p``: ``g / (x + 1)``; ``sqrt``: ``g * (0.5 / y)``; ``rsqrt``: ``g * (-0.5 * (y / x))``;
* ``sum_last``: ``g`` broadcast over the axis;
* ``cumsum_last``: the reverse cumulative sum, in XLA's order for it
  (:func:`rcumsum_last`);
* ``tanh``: ``(g + g*y) * (1 - y)``, compiled as ``t = g * (1 - y)``
  then ``t + t*y`` in one fused multiply-add;
* ``ftz``: ``g`` where the value is kept (zero included), 0 where it is
  flushed;
* ``logistic``: ``g * (y * (1 - y))``; ``silu`` (``x * logistic(x)``):
  ``g*s + (x*g) * (s * (1 - s))`` with the first product fused into the
  sum;
* ``softmax`` (``jax.nn.softmax``'s ``custom_jvp``, ``y * (x_dot -
  sum(y * x_dot))``), as XLA simplifies its transpose: ``(g / s -
  sum((g * (1 / (s*s))) * e)) * e`` over the unnormalised ``e`` and its
  sum ``s``;
* ``fma``: ``g * b``, ``g * a`` and ``g``, each summed over the axes it
  broadcasts along (the last one in XLA's order);
* :func:`logsumexp`: ``exp(x - m) * (g / sum)``;
* ``softplus``: ``g * exp(x - y)`` (``+inf`` replaced by 0 in both,
  flushed);
* ``integer_pow``: ``g * (x**(n-1) * n)``.

``tanh``, ``cumsum_last``, ``ftz``, ``logistic``, ``silu``,
``softmax``, ``log1p``, ``softplus`` and ``integer_pow`` equal
``jax.vjp`` of the jitted primitive bit for bit (the last three with
XLA's CPU flush of float32 subnormals, in ``g`` and in every result:
subnormal gradients enter as zeros) (``tests/test_torch_rwkv6_train.py``,
``tests/test_torch_moe_train.py``, ``tests/test_torch_mamba_train.py``,
``tests/test_torch_encdec_train.py``).

RWKV6's decay replays XLA's CPU ``tanh`` (:func:`tanh`, Eigen's rational
approximation) and its flush of float32 subnormals to zero
(:func:`ftz`).

The optimisers' scalars replay XLA's CPU ``pow`` and ``cos``: calls of
the C library's ``powf`` / ``cosf`` with results below the float32
normal range flushed to zero, as XLA's CPU code runs (:func:`pow`,
:func:`cos`, on host scalars).  Whisper's sinusoidal positions take the
same ``sinf`` / ``cosf`` element by element on the host
(:func:`sin`, and :func:`cos` of a tensor; the callers cache the
table).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

__all__ = [
    "fma", "log", "log1p", "softplus", "integer_pow", "exp", "erf_inv", "tanh", "ftz",
    "logistic", "silu", "softmax",
    "sum_last", "cumsum_last", "rcumsum_last", "logsumexp", "sqrt", "rsqrt", "pow", "cos", "sin",
]


def _f(v: float) -> float:
    """``v`` rounded to float32 (the constants are float32 literals)."""
    return float(np.float32(v))


def fma(a: torch.Tensor, b, c, *, wait: bool = True) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once, as a fused multiply-add.

    float64 holds the product of two float32 values exactly, so the sum
    is rounded first to float64 and then to float32.  That second
    rounding goes wrong only where the first lands exactly halfway
    between two float32 values without being exact; there the float64
    sum is moved one float64 ulp towards the exact sum, which then rounds
    correctly.  On the CPU the correction is computed for the halfway
    elements of a tensor only.  On a card it is a ``torch.where`` over
    the whole tensor, which ``wait`` runs only when ``tie.any()`` (one
    wait for the device) finds a halfway sum: cheaper where they are rare
    (polynomials of measured values), dearer in a chain of small integer
    products, which land halfway, exactly, at most steps (the plain K1
    passes ``wait=False``).  ``b`` and ``c`` may be Python or numpy
    float32 scalars, which enter the float64 arithmetic as scalars: no
    copy to the device, which would wait for it.  Results in the float32
    normal range; the operands broadcast as ``torch.addcmul``'s.  Under
    autograd the gradient is ``g * b``, ``g * a`` and ``g``, each summed
    over the axes its operand broadcasts along."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in (a, b, c)):
        return _Fma.apply(a, b, c, wait)
    return _fma(a, b, c, wait)


def _shape(t):
    return t.shape if isinstance(t, torch.Tensor) else None


def _unbroadcast(t: torch.Tensor, shape) -> torch.Tensor | None:
    """``t`` summed down to ``shape`` (``None`` for a scalar operand):
    over the last axis in XLA's order (a broadcast's transpose is a sum),
    over others by torch."""
    if shape is None or t.shape == shape:
        return None if shape is None else t
    if len(shape) == t.dim() and shape[-1] == 1 and shape[:-1] == t.shape[:-1]:
        return sum_last(t)[..., None]
    return t.sum_to_size(shape)


class _Fma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c, wait):
        tensor_b = isinstance(b, torch.Tensor)
        ctx.save_for_backward(a, b if tensor_b else None)
        ctx.b, ctx.shapes = None if tensor_b else b, (_shape(a), _shape(b), _shape(c))
        return _fma(a, b, c, wait)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        b = ctx.b if b is None else b
        sa, sb, sc = ctx.shapes
        need = ctx.needs_input_grad
        return (_unbroadcast(g * b, sa) if need[0] else None,
                _unbroadcast(g * a, sb) if need[1] else None,
                _unbroadcast(g, sc) if need[2] else None, None)


def _fma(a: torch.Tensor, b, c, wait: bool = True) -> torch.Tensor:
    a64 = a.double()
    b64 = _as_f64(b, a.device)
    c64 = _as_f64(c, a.device)
    if isinstance(b64, torch.Tensor) and isinstance(c64, torch.Tensor):
        s = torch.addcmul(c64, a64, b64)
    else:  # the product is exact, so the sum is rounded once, as addcmul's
        s = a64 * b64 + c64
    tie = halfway(s)
    if a.device.type == "cpu" and s.dim():
        idx = tie.nonzero(as_tuple=True)
        if idx[0].numel():
            def pick(t):
                return t.expand_as(s)[idx] if isinstance(t, torch.Tensor) else t
            s[idx] = _towards_exact(s[idx], pick(a64), pick(b64), pick(c64))
        return s.float()
    if wait and not bool(tie.any()):
        return s.float()
    return torch.where(tie, _towards_exact(s, a64, b64, c64), s).float()


def _as_f64(v, device):
    """A float64 tensor on ``device`` for a tensor operand, a Python float
    for a scalar one."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float64)
    return float(v)


def _towards_exact(s, a, b, c):
    """``s = a*b + c`` rounded to float64, moved one ulp towards the
    exact sum where it is inexact (its error by Knuth's two-sum)."""
    p = a * b
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    away = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where(err != 0, torch.nextafter(s, away), s)


def halfway(s: torch.Tensor) -> torch.Tensor:
    """Where the float64 ``s`` lies exactly halfway between two float32
    values (its 29 low mantissa bits are ``1 << 28``)."""
    return (s.view(torch.int64) & _LOW29) == _HALF29


# the 29 low mantissa bits that float64 has and float32 has not, and
# their pattern halfway between two float32 values
_LOW29 = (1 << 29) - 1
_HALF29 = 1 << 28


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma(p, x, _f(c))
    return p


class _Log(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return _log(y)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g / y


class _Exp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _exp(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _ftz_t(g * y)


def log(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` (Cephes ``logf``): ``y = m * 2**e`` with
    ``m`` in ``[sqrt(1/2), sqrt(2))``, then ``log(1 + x)`` for ``x = m -
    1`` by a degree-9 polynomial.  Positive normal ``y``.  Gradient
    ``g / y``."""
    return _Log.apply(y)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp`` (Cephes ``expf``): ``x = n ln2 + r``, a
    degree-5 polynomial in ``r``, times ``2**n``.  Gradient ``g * exp(x)``
    (the output itself), flushed to zero below the normal range as XLA's
    CPU code flushes the product."""
    return _Exp.apply(x)


def _log(y: torch.Tensor) -> torch.Tensor:
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


def _exp(x: torch.Tensor) -> torch.Tensor:
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


def _log1p(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + fma(x2, -0.5, (x * x2) * r)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log(x + 1.0))


class _Log1p(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _ftz_t(_log1p(x))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _ftz_t(_ftz_t(g) / (x + 1.0))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: ``log(1 + x)``, or for ``|x| < sqrt(2) -
    1`` the Cephes rational approximation, results below the normal
    range flushed to zero.  ``x > -1``.  Gradient JAX's ``g / (x +
    1)``."""
    return _Log1p.apply(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    y = torch.clamp_min(x, 0.0) + _log1p(_ftz_t(_exp(-x.abs())))
    return _ftz_t(torch.where(torch.isnan(x), x, y))


class _Softplus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _softplus(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        inf = float("inf")
        xs = torch.where(x == inf, torch.zeros_like(x), x)
        ys = torch.where(y == inf, torch.zeros_like(y), y)
        return _ftz_t(_ftz_t(g) * _ftz_t(_exp(xs - ys)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) as XLA's CPU code computes
    it: ``max(x, 0) + log1p(exp(-|x|))`` (``x`` itself where it is NaN)
    with XLA's ``exp`` and ``log1p``, results below the float32 normal
    range flushed to zero.  Gradient as XLA compiles JAX's ``logaddexp``
    rule: ``g * exp(x - y)``, ``x`` and the output ``y`` each with ``+inf``
    replaced by 0, the ``exp`` and the product flushed."""
    return _Softplus.apply(x)


class _IntegerPow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.save_for_backward(x)
        ctx.n = n
        return _ipow(x, n)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _ftz_t(_ftz_t(g) * _ftz_t(_ipow(x, ctx.n - 1, flush=True) * float(ctx.n))), None


def _ipow(x: torch.Tensor, n: int, flush: bool = False) -> torch.Tensor:
    """``x ** n`` as XLA expands ``integer_pow``: ``((x * x) * x) ...``,
    with ``flush`` each product flushed below the normal range."""
    f = _ftz_t if flush else (lambda t: t)  # noqa: E731
    x = f(x)
    y = torch.ones_like(x) if n == 0 else x
    for _ in range(n - 1):
        y = f(y * x)
    return y


def integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for an integer ``n >= 1`` (``lax.integer_pow``) as XLA's
    CPU code computes it, ``((x * x) * x) ...`` in order.  Gradient JAX's
    ``g * (n * x ** (n - 1))``, compiled as ``g * (x**(n-1) * n)``."""
    return _IntegerPow.apply(x, n)


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
    w = -_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    coef = lambda i: torch.where(  # noqa: E731
        lt, x.new_tensor(_ERFINV_LT5[i]), x.new_tensor(_ERFINV_GE5[i])
    )
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, coef(i))
    return p * x


# tanh (Eigen's fast float tanh, as XLA's CPU backend emits it with
# FMA): an odd degree-13 numerator over an even degree-6 denominator
_TANH_CLAMP = 7.99881172180175781
_TANH_TINY = 0.0004
_TANH_NUM = (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03,
)
_TANH_DEN = (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03,
)


def _tanh(x: torch.Tensor) -> torch.Tensor:
    xc = torch.clamp(x, -_f(_TANH_CLAMP), _f(_TANH_CLAMP))
    x2 = xc * xc
    return torch.where(x.abs() < _f(_TANH_TINY), x,
                       (xc * _horner(x2, _TANH_NUM)) / _horner(x2, _TANH_DEN))


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        t = g * (1.0 - y)
        return fma(t, y, t)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``tanh``: ``x`` clamped to +-7.9988, ``x * p(x**2)
    / q(x**2)`` with both polynomials in fused multiply-adds, and ``x``
    itself where ``|x| < 0.0004``.  Finite inputs.  Gradient JAX's ``(g
    + g*y) * (1 - y)`` as XLA compiles it: ``t = g * (1 - y)``, then ``t
    + t*y`` in one fused multiply-add."""
    return _Tanh.apply(x)


def _ftz_t(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < float(_TINY), x * 0.0, x)


class _Ftz(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _ftz_t(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        flushed = (x.abs() < float(_TINY)) & (x != 0)
        return torch.where(flushed, torch.zeros_like(g), g)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """``x`` with values below the float32 normal range flushed to zero of
    the same sign, as XLA's CPU code computes every float32 operation
    (torch keeps subnormals, on the CPU and on a card).  Finite inputs.
    Gradient ``g`` where the value is kept (zero included), 0 where it is
    flushed (the flushed value is a constant zero)."""
    return _Ftz.apply(x)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return _ftz_t(torch.ones_like(x) / (1.0 + _ftz_t(_exp(-x))))


class _Logistic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _logistic(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


def logistic(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (``lax.logistic``) as XLA's CPU code computes
    it: ``1 / (1 + exp(-x))`` with XLA's ``exp``, each result flushed to
    zero below the normal range.  Gradient JAX's ``g * (y * (1 -
    y))``."""
    return _Logistic.apply(x)


class _Silu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = _logistic(x)
        ctx.save_for_backward(x, s)
        return _ftz_t(x * s)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return fma(g, s, (x * g) * (s * (1.0 - s)))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` (``x * sigmoid(x)``) as XLA's CPU code computes it,
    :func:`logistic` and the product flushed to zero below the normal
    range.  Gradient as XLA compiles JAX's: ``g*s + (x*g) * (s * (1 -
    s))`` with ``g*s`` fused into the sum."""
    return _Silu.apply(x)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        e = _exp(x - x.amax(dim=-1, keepdim=True))
        s = _sum_last(e)[..., None]
        ctx.save_for_backward(e, s)
        return e / s

    @staticmethod
    def backward(ctx, g):
        e, s = ctx.saved_tensors
        a = g * (torch.ones_like(s) / (s * s))
        if e.shape[-1] <= 32:  # one reduce, the product fused into each add
            s2 = torch.zeros_like(s)
            for j in range(e.shape[-1]):
                s2 = _fma(a[..., j:j + 1], e[..., j:j + 1], s2, wait=False)
        else:  # windowed sums of the rounded products
            s2 = _sum_last(a * e)[..., None]
        return (g / s + -s2) * e


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in float32: ``e = exp(x -
    max)`` with XLA's ``exp``, ``e / sum(e)`` with the sum in XLA's order.
    Gradient JAX's ``custom_jvp`` rule ``y * (x_dot - sum(y * x_dot))``,
    transposed and simplified as XLA compiles it: ``(g / s - sum((g * (1
    / (s*s))) * e)) * e``, the sum over at most 32 values one fused
    multiply-add a value, from zero, over more the rounded products in
    :func:`sum_last`'s order."""
    return _Softmax.apply(x)


def _seq_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, in order from 0.0."""
    s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        s = s + x[..., j]
    return s


class _SumLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return _sum_last(x)

    @staticmethod
    def backward(ctx, g):
        return g[..., None].expand(ctx.shape)


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``sum`` over the last axis: windows of 32 summed
    in order (the axis zero-padded to whole windows, half the padding in
    front), level by level until at most 32 partial sums are left, which
    are summed in order.  Gradient: ``g`` broadcast over the axis."""
    return _SumLast.apply(x)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    while x.shape[-1] > 32:
        n = x.shape[-1]
        m = -(-n // 32)
        pad = m * 32 - n
        x = _seq_last(torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(
            *x.shape[:-1], m, 32))
    return _seq_last(x)


def _scan16(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    for j in range(1, x.shape[-1]):
        out[..., j] = out[..., j - 1] + x[..., j]
    return out


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= 16:
        return _scan16(x)
    m = -(-n // 16)
    rows = _scan16(torch.nn.functional.pad(x, (0, m * 16 - n)).reshape(*x.shape[:-1], m, 16))
    excl = torch.nn.functional.pad(_cumsum_last(rows[..., 15])[..., :-1], (1, 0))
    return (rows + excl[..., None]).reshape(*x.shape[:-1], m * 16)[..., :n]


def _rscan16(x: torch.Tensor) -> torch.Tensor:
    """Each position's suffix sum, added from the position forwards."""
    out = x.clone()
    n = x.shape[-1]
    for t in range(1, n):
        out[..., :n - t] = out[..., :n - t] + x[..., t:]
    return out


def rcumsum_last(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 reverse ``cumsum`` over the last axis (the
    gradient of :func:`cumsum_last`): rows of 16 (the axis zero-padded
    at its end), each position's suffix within its row added from the
    position forwards, the rows' totals summed the same way, and each
    row's exclusive suffix of totals added to it."""
    n = x.shape[-1]
    if n <= 16:
        return _rscan16(x)
    m = -(-n // 16)
    rows = _rscan16(torch.nn.functional.pad(x, (0, m * 16 - n)).reshape(*x.shape[:-1], m, 16))
    excl = torch.nn.functional.pad(rcumsum_last(rows[..., 0])[..., 1:], (0, 1))
    return (rows + excl[..., None]).reshape(*x.shape[:-1], m * 16)[..., :n]


class _Cumsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _cumsum_last(x)

    @staticmethod
    def backward(ctx, g):
        return rcumsum_last(g)


def cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``cumsum`` over the last axis: rows of 16
    scanned in order (the axis zero-padded to whole rows), the rows'
    totals scanned the same way, and each row's exclusive prefix added to
    it; at most 16 values are scanned in order.  Gradient the reverse
    cumulative sum in XLA's order (:func:`rcumsum_last`)."""
    return _Cumsum.apply(x)


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.logsumexp`` over the last axis: the max held out of the
    gradient (0 where it is not finite), ``exp`` of the shifted values,
    their sum in XLA's order, ``log`` of its absolute value plus the
    max.  The gradient is JAX's: ``exp(x - m) * (g / sum)``."""
    m = x.detach().amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = exp(x - m[..., None])
    return log(sum_last(e).abs()) + m


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``sqrt`` (through float64, which rounds
    to the correctly rounded float32 value; the CPU build of
    ``torch.sqrt`` on float32 is not correctly rounded)."""
    return torch.sqrt(x.double()).float()


class _Sqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (torch.full_like(y, 0.5) / y)


class _Rsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x64 = x.double()
        y = (torch.ones_like(x64) / torch.sqrt(x64)).float()
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * ((y / x) * -0.5)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``sqrt`` (the correctly rounded root).  Gradient
    ``g * (0.5 / y)``."""
    return _Sqrt.apply(x)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 ``1 / sqrt(x)`` rounded once from float64 (the same bits on
    the CPU and a card).  XLA's CPU ``rsqrt`` refines a hardware estimate
    and lands within one ulp of this value, off by one ulp on about 14 %
    of inputs; it is not replayed.  Gradient JAX's ``g * (-0.5 * (y /
    x))``."""
    return _Rsqrt.apply(x)


@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name, n in (("powf", 2), ("cosf", 1), ("sinf", 1)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float] * n
    return lib


_TINY = np.finfo(np.float32).tiny


def _ftz(v) -> np.float32:
    """Flush a float32 value below the normal range to (signed) zero."""
    v = np.float32(v)
    return np.float32(np.copysign(0.0, v)) if abs(v) < _TINY else v


def pow(base, t) -> np.float32:  # noqa: A001 - the primitive's name
    """XLA's CPU float32 ``base ** t`` of two scalars: the C library's
    ``powf`` on the float32 operands, inputs and result below the normal
    range flushed to zero."""
    return _ftz(_libm().powf(float(_ftz(base)), float(_ftz(t))))


def cos(x):
    """XLA's CPU float32 ``cos``: the C library's ``cosf``.  A scalar
    (input and result below the normal range flushed to zero, as XLA's
    code for the optimisers' scalars runs) gives a float32 scalar; a
    tensor gives a tensor on its device, as :func:`sin`."""
    if isinstance(x, torch.Tensor):
        return _libm_map("cosf", x)
    return _ftz(_libm().cosf(float(_ftz(x))))


def _libm_map(name: str, x: torch.Tensor) -> torch.Tensor:
    """The C library's float32 ``name`` of every element of ``x``, on the
    host, returned on ``x``'s device.  No flush: XLA's ``sin`` of a
    tensor keeps a subnormal input (``sin(1e-40)`` is ``1e-40``)."""
    fn = getattr(_libm(), name)
    flat = x.detach().to("cpu", torch.float32).reshape(-1).numpy()
    out = np.fromiter(map(fn, flat.tolist()), dtype=np.float32, count=flat.size)
    return torch.from_numpy(out).reshape(x.shape).to(x.device)


def sin(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``sin`` of a tensor: ``sinf`` element by element
    on the host, returned on ``x``'s device (~1 us an element: for
    tables computed once)."""
    return _libm_map("sinf", x)
