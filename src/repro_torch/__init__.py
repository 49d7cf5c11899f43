"""PyTorch/CUDA port of the MemIntelli reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``core``, ``kernels``, ``models``, ``configs``, ``serve``)
so each port module sits at the same path as its counterpart.  It imports
``torch``, ``numpy`` and the standard library only — never ``jax`` and
nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CUDA tensor every kernel of the serving path launches a hand-written
CUDA C++ kernel (``csrc/``, built with ``nvcc`` for ``sm_90a`` at first
use); on a CPU tensor it runs the kernel's plain PyTorch version.
"""
