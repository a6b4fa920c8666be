"""Build and load the port's CUDA kernels.

All ``hvi_cidnet_torch/csrc/*.cu`` files compile with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``build/kernels/`` at the repository root
(git-ignored), under a name that hashes the sources and the flags, so a
changed source never loads a stale library. Nothing here runs at import.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false``. The last keeps
every multiply and add separately rounded, as PyTorch's elementwise ops
are, so the HVI kernels agree with their plain twins op for op (the hue
select chain compares floats for equality). ``--use_fast_math`` is never
used: it would replace IEEE division and ``sinf``/``cosf``/``powf``/
``atan2f`` with approximations.

Each kernel is a :class:`CudaKernel`: a C symbol plus a plain integer
``launches`` count that goes up by one for every successful launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

# dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhvi_cidnet_kernels_{h.hexdigest()[:16]}.so"


def build(*, verbose: bool = False) -> tuple[Path, float]:
    """Compile the kernels if the library is missing. Returns (path, seconds
    spent compiling; 0.0 when it was already built)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp,
           *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    path, _ = build()
    return ctypes.CDLL(str(path))


class CudaKernel:
    """One C entry point of the library, with its launch count.

    The C function launches on the stream it is given and returns
    ``cudaGetLastError()``; a nonzero code raises here, so a refused launch
    (bad configuration, no device) never passes silently.
    """

    def __init__(self, name: str, argtypes: Sequence):
        self.name = name
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + the stream
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream, with ``device`` current."""
        if self._fn is None:
            fn = getattr(library(), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: cudaError {err}")
        self.launches += 1


def check_input(t: torch.Tensor, name: str, ndim: int) -> None:
    """The kernels take contiguous fp32 or bf16 CUDA tensors only."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32 or bfloat16)")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def twin_backward(plain, inputs, grad_output, needs_grad):
    """Gradients of ``plain(*inputs)`` for an ``autograd.Function`` whose
    forward is a kernel: the backward runs the plain twin's autograd, as the
    JAX package's ``custom_vjp``s run their XLA twins' VJPs."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs_grad)]
        out = plain(*xs)
        wrt = [x for x, need in zip(xs, needs_grad) if need]
        grads = iter(torch.autograd.grad(out, wrt, grad_output) if wrt else ())
    return tuple(next(grads) if need else None for need in needs_grad)


def scalar_pointer(t: torch.Tensor, device: torch.device, name: str) -> int:
    """Device pointer of a one-element fp32 parameter (density_k, a PReLU
    slope): the kernel reads it on the card, no ``.item()`` host sync."""
    if t.numel() != 1 or t.dtype != torch.float32 or t.device != device:
        raise ValueError(
            f"{name}: expected one fp32 element on {device}, got {tuple(t.shape)} "
            f"{t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()
