"""Build and load the port's CUDA kernels.

All ``hvi_cidnet_torch/csrc/*.cu`` files compile with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``: one
``nvcc -c`` per source, all started together, then one link. The build
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
``launches`` count that goes up by one for every successful launch, under a
lock (data-parallel serving launches from one host thread per replica).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

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


def _check(cmd: list, code: int, log: str, verbose: bool) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{log}")
    if verbose:
        print(log, end="")


def build(*, verbose: bool = False) -> tuple[Path, float]:
    """Compile the kernels if the library is missing. Returns (path, seconds
    spent compiling; 0.0 when it was already built)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        ptxas = ["-Xptxas", "-v"] if verbose else []
        objects = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        compiles = [[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)]
                    for obj, src in zip(objects, _sources())]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        logs = [proc.communicate()[1] for proc in procs]  # waits for every compile
        for cmd, proc, log in zip(compiles, procs, logs):
            _check(cmd, proc.returncode, log, verbose)
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objects]
        proc = subprocess.run(link, capture_output=True, text=True)
        _check(link, proc.returncode, proc.stderr, verbose)
        os.replace(lib, path)  # atomic: a concurrent loader never sees half a file
    return path, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    path, _ = build()
    return ctypes.CDLL(str(path))


_GET_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # CUDA builds


def _raw_stream(index: int) -> int:
    """The current stream of device ``index`` as a raw handle (PyTorch's own
    accessor where the build has it, without making a Stream object)."""
    if _GET_RAW_STREAM is not None:
        return _GET_RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


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
        self._lock = threading.Lock()

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream, with ``device`` current.
        The stream is read as a raw handle and the device switched only when
        it is not current: at batch 1 this host work is most of a call."""
        if self._fn is None:
            fn = getattr(library(), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        index = device.index if device.index is not None else torch.cuda.current_device()
        if torch.cuda.current_device() == index:
            err = self._fn(*args, _raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = self._fn(*args, _raw_stream(index))
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: cudaError {err}")
        with self._lock:
            self.launches += 1


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors: the persistent kernels' grids."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def widest_vector(size: int, offset: int, itemsize: int) -> int:
    """The widest vector, in elements (a power of two, at most 16 bytes),
    that divides a row of ``size`` elements and a base ``offset`` bytes past
    a 16-byte boundary: then every row of the tensor starts aligned to it."""
    vec = 16 // itemsize
    while size % vec or offset % (vec * itemsize):
        vec //= 2
    return vec


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
