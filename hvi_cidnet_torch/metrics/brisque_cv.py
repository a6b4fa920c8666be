"""Native BRISQUE backend over the system OpenCV quality module.

The counterpart of ``hvi_cidnet_tpu/metrics/brisque_cv.py``. The reference
scores BRISQUE via ``imquality.brisque.score`` (measure_niqe_bris.py:4,26),
which bundles the LIVE-trained SVR. OpenCV's contrib quality library
(``libopencv_quality``, 4.x) implements the same algorithm and ships a
LIVE-R2-trained model and range file (``brisque_model_live.yml``,
``brisque_range_live.yml``); the cv2 Python wheel does not expose it, so
``native/brisque_shim.cpp`` (a copy of the JAX package's) binds it through
a small C ABI loaded with ctypes. The shim is built at first use with
``g++`` into ``build/brisque/`` at the repository root (git-ignored), under
a name that hashes the source, never into the package's own tree.

Exports:
* ``available()``     — True when the shim builds and loads (the system's
                        OpenCV quality library present) and the trained
                        model files exist; ``reason()`` says why not.
* ``score(img)``      — trained BRISQUE score of an RGB uint8/float image.
* ``features(img)``   — OpenCV's 36-dim unscaled feature vector; a parity
                        oracle for ``metrics/brisque.py``'s numpy features.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SHIM_SRC = Path(__file__).resolve().parents[1] / "native" / "brisque_shim.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "brisque"

MODEL_PATH = os.environ.get(
    "BRISQUE_CV_MODEL", "/usr/share/opencv4/quality/brisque_model_live.yml"
)
RANGE_PATH = os.environ.get(
    "BRISQUE_CV_RANGE", "/usr/share/opencv4/quality/brisque_range_live.yml"
)
_GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-I/usr/include/opencv4")
_LIBS = ("-lopencv_quality", "-lopencv_ml", "-lopencv_imgproc", "-lopencv_core")

_lib: Optional[ctypes.CDLL] = None
_lib_err: Optional[str] = None


def shim_path() -> Path:
    """Where the shim for the current source lives."""
    digest = hashlib.sha256(_SHIM_SRC.read_bytes() + " ".join(_GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libbrisque_shim_{digest[:16]}.so"


def _build_shim(path: Path) -> Optional[str]:
    """Compile the shim against the system OpenCV 4 headers and libraries
    into ``path`` (through a temporary name, so concurrent processes never
    load a half-written file). Returns None on success, else why not."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = ["g++", *_GXX_FLAGS, str(_SHIM_SRC), *_LIBS, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        return f"g++ did not run: {e}"
    if r.returncode != 0:
        os.unlink(tmp)
        tail = (r.stderr.strip().splitlines() or ["no output"])[-1]
        return f"g++ failed ({r.returncode}): {tail}"
    os.replace(tmp, path)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    path = shim_path()
    if not path.exists():
        _lib_err = _build_shim(path)
        if _lib_err is not None:
            return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:  # system OpenCV libs absent
        _lib_err = str(e)
        return None
    lib.brisque_score_u8.restype = ctypes.c_int
    lib.brisque_score_u8.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
    ]
    lib.brisque_features_u8.restype = ctypes.c_int
    lib.brisque_features_u8.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return _lib


def reason() -> Optional[str]:
    """None when the backend is available, else why it is not."""
    missing = [p for p in (MODEL_PATH, RANGE_PATH) if not os.path.exists(p)]
    if missing:
        return f"OpenCV's trained BRISQUE files are absent: {', '.join(missing)}"
    if _load() is None:
        return f"the OpenCV quality shim did not build or load: {_lib_err}"
    return None


def available() -> bool:
    return reason() is None


def _as_u8(img: np.ndarray) -> np.ndarray:
    x = np.asarray(img)
    if x.dtype != np.uint8:
        # [0,1] floats → [0,255]; already-[0,255] floats pass through.
        if np.issubdtype(x.dtype, np.floating) and x.max() <= 1.0 + 1e-6:
            x = x * 255.0
        x = np.clip(np.round(x), 0, 255).astype(np.uint8)
    if x.ndim == 2:
        x = x[:, :, None]
    return np.ascontiguousarray(x)


def score(img: np.ndarray) -> float:
    """Trained (LIVE-R2) BRISQUE score of an RGB/grayscale image."""
    lib = _load()
    if lib is None:
        raise FileNotFoundError(f"native BRISQUE backend unavailable: {_lib_err}")
    x = _as_u8(img)
    h, w, c = x.shape
    out = ctypes.c_double()
    rc = lib.brisque_score_u8(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, w, c,
        MODEL_PATH.encode(), RANGE_PATH.encode(), ctypes.byref(out),
    )
    if rc != 0:
        raise RuntimeError("OpenCV QualityBRISQUE::compute failed")
    return float(out.value)


def features(img: np.ndarray) -> np.ndarray:
    """OpenCV's unscaled 36-dim BRISQUE feature vector (parity oracle)."""
    lib = _load()
    if lib is None:
        raise FileNotFoundError(f"native BRISQUE backend unavailable: {_lib_err}")
    x = _as_u8(img)
    h, w, c = x.shape
    out = (ctypes.c_float * 36)()
    rc = lib.brisque_features_u8(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, w, c, out,
    )
    if rc != 0:
        raise RuntimeError("OpenCV QualityBRISQUE::computeFeatures failed")
    return np.asarray(out, dtype=np.float64)
