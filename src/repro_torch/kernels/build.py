"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` into an object with a plain C
interface; the objects are linked into ONE shared library that
:func:`library` loads with ``ctypes``.  Nothing but ``nvcc`` is needed
(no ninja, no PyTorch headers), so the first call builds everything in
seconds.  The build runs at first use into ``build/torch_kernels/<hash>/``
at the repository root, keyed on a hash of the sources and flags; a
finished library is moved into place atomically, so concurrent processes
never load a half-written file.

Compiler flags: ``-O3`` and no ``--use_fast_math`` (IEEE division and
square root stay on).  ``-fmad`` stays at nvcc's default (on): the dot
products use fused multiply-adds, and every epilogue operation whose
rounding the plain version pins (quantiser division, ADC step,
recombination, scale products, the K-block sum) is written with the
``__fmul_rn`` / ``__fadd_rn`` / ``__fdiv_rn`` intrinsics, which nvcc never
contracts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["LaunchCounter", "library", "build", "build_log", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
CFLAGS = ("-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class LaunchCounter:
    """Count of kernel launches made by one wrapper (a plain integer the
    wrapper bumps where it launches its kernel, and nowhere else)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _key() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this machine"
    )


def build() -> Path:
    """Compile ``csrc/*.cu`` (one nvcc per source, in parallel) and link
    the shared library, unless the library for these sources exists."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        cus = sorted(CSRC.glob("*.cu"))
        procs = [
            (
                src,
                subprocess.Popen(
                    [nvcc, *CFLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                     str(tmp / (src.stem + ".o"))],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ),
            )
            for src in cus
        ]
        log = []
        failed = []
        for src, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name} (rc={p.returncode})\n{text}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp / LIB_NAME)]
            + [str(tmp / (s.stem + ".o")) for s in cus],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / "build.log", out_dir / "build.log")
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log() -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) of the current build, or '' if none exists."""
    p = BUILD_ROOT / _key() / "build.log"
    return p.read_text() if p.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (a refused launch
    never runs, and a later synchronise would not report it)."""
    if rc != 0:
        msg = library().cuda_error_string
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({msg(rc).decode()})"
        )
