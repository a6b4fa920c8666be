"""Bilinear x0.5 / x2 with ``align_corners=True`` in plain PyTorch, with
the interpolation weights the CUDA kernels use, and the general resize
(any size, ``align_corners=False``) that TNSM's noise maps take.

Reference: ``nn.UpsamplingBilinear2d(scale_factor=0.5 / 2)`` inside
NormDownsample / NormUpsample (net/transformer_utils.py:38-40, 57-59), i.e.
``F.interpolate(..., mode="bilinear", align_corners=True)``. The plain forms
here are the JAX package's banded ones (``hvi_cidnet_tpu/ops/resize.py:
77-132``): per axis, two or three shifted taps with the exact rows of the
dense interpolation matrix. ``F.interpolate`` itself is not exact enough to
be the twin: it computes each source position as an fp32 scale times the
output index, so its tap weights are off by up to about size * 2**-24 (some
4e-5 at 600 px), far above the 1e-6 the kernels are held to.

``_interp_matrix`` and ``_band_weights`` are this package's own copies of
the JAX package's helpers (``hvi_cidnet_tpu/ops/resize.py:35-68``; that
package is not importable without jax). They compute the per-tap weights in
float64 and store fp32, and a test checks that they are bitwise equal to
the JAX ones: K3 and K4 (``ops/resize_cuda.py``) run with exactly these
weights.

``resize_bilinear`` is the JAX ``resize_bilinear_hwcb(..., align_corners=
False)`` (``hvi_cidnet_tpu/ops/resize.py:142-167``) on NCHW: the dense
matrix of each axis, H first,
applied as a product in the activation's dtype. It is plain PyTorch on every
device, as JAX runs it as plain XLA: no Pallas kernel computes it there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool = True) -> np.ndarray:
    """(out_size, in_size) row-stochastic bilinear interpolation matrix. The
    source position is a Python float; the matrix is stored in fp32."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            # torch's half-pixel convention, clamped to >= 0
            src = max((i + 0.5) * in_size / out_size - 0.5, 0.0)
        lo = min(int(np.floor(src)), in_size - 1)
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


def _band_weights(in_size: int, out_size: int, cols) -> list:
    """Per-output weights at the given column patterns, read off the dense
    matrix (0 where the column falls outside the input)."""
    m = _interp_matrix(in_size, out_size)
    out = []
    for col_fn in cols:
        w = np.zeros(out_size, np.float32)
        for i in range(out_size):
            c = col_fn(i)
            if c is not None and 0 <= c < in_size:
                w[i] = m[i, c]
        out.append(w)
    return out


@functools.lru_cache(maxsize=None)
def half_weights(size: int) -> np.ndarray:
    """x0.5 taps along one axis of ``size``: (3, size // 2) fp32, rows are the
    weights of source 2i, 2i+1, 2i+2."""
    return np.stack(
        _band_weights(size, size // 2, [lambda i: 2 * i, lambda i: 2 * i + 1, lambda i: 2 * i + 2])
    )


@functools.lru_cache(maxsize=None)
def double_weights(size: int) -> np.ndarray:
    """x2 taps along one axis of ``size``: (4, size) fp32 indexed by source j.
    Rows: even output 2j takes (j-1, j) with (ae, be); odd output 2j+1 takes
    (j, j+1) with (ao, bo)."""
    ae, be = _band_weights(size, 2 * size, [lambda i: i // 2 - 1, lambda i: i // 2])
    ao, bo = _band_weights(size, 2 * size, [lambda i: i // 2, lambda i: i // 2 + 1])
    return np.stack([ae[0::2], be[0::2], ao[1::2], bo[1::2]])


@functools.lru_cache(maxsize=None)
def axis_weights(kind: str, size: int, device: torch.device) -> torch.Tensor:
    """``half_weights`` (kind "half") or ``double_weights`` (kind "double")
    of one axis as an fp32 tensor on ``device``; uploaded once per size."""
    w = half_weights(size) if kind == "half" else double_weights(size)
    return torch.from_numpy(w.copy()).to(device)


def _taps(x: torch.Tensor, dim: int, index: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rows ``index`` of ``x`` along ``dim`` (-2 or -1), times per-row ``w``."""
    shape = (-1, 1) if dim == -2 else (-1,)
    return x.index_select(dim, index) * w.reshape(shape)


def _half_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x0.5 along ``dim``: output i = a*x[2i] + b*x[2i+1] + c*x[2i+2]. The
    last tap is clamped at the edge, where its weight is 0."""
    size = x.shape[dim]
    a, b, c = axis_weights("half", size, x.device)
    even = torch.arange(0, 2 * (size // 2), 2, device=x.device)
    return (_taps(x, dim, even, a) + _taps(x, dim, even + 1, b)
            + _taps(x, dim, (even + 2).clamp_max(size - 1), c))


def _double_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x2 along ``dim``: output 2j = ae*x[j-1] + be*x[j], output 2j+1 =
    ao*x[j] + bo*x[j+1], interleaved. Edge taps are clamped (weight 0)."""
    size = x.shape[dim]
    ae, be, ao, bo = axis_weights("double", size, x.device)
    j = torch.arange(size, device=x.device)
    even = _taps(x, dim, (j - 1).clamp_min(0), ae) + _taps(x, dim, j, be)
    odd = _taps(x, dim, j, ao) + _taps(x, dim, (j + 1).clamp_max(size - 1), bo)
    out = torch.stack([even, odd], dim=dim)  # (..., size, 2, ...) pairs
    shape = list(x.shape)
    shape[dim] = 2 * size
    return out.reshape(shape)


def scale_half_f32(x: torch.Tensor) -> torch.Tensor:
    """``UpsamplingBilinear2d(0.5)`` on NCHW ``x``, computed and returned in
    fp32: the H pass, then the W pass, in the Pallas kernel's and the CUDA
    kernel's order."""
    return _half_axis(_half_axis(x.float(), -2), -1)


def scale_double_f32(x: torch.Tensor) -> torch.Tensor:
    """``UpsamplingBilinear2d(2)`` on NCHW ``x``, in fp32, H pass first."""
    return _double_axis(_double_axis(x.float(), -2), -1)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to (out_h, out_w), ``align_corners=False``
    (the TNSM noise maps, net/CIDNet_TNSM.py:258): per axis, H first, a
    product with the fp32 interpolation matrix taken to ``x.dtype``; an axis
    already at its size is left alone."""
    if x.shape[-2] != out_h:
        m = torch.from_numpy(_interp_matrix(x.shape[-2], out_h, False))
        x = torch.einsum("oh,bchw->bcow", m.to(x.device, x.dtype), x)
    if x.shape[-1] != out_w:
        m = torch.from_numpy(_interp_matrix(x.shape[-1], out_w, False))
        x = torch.einsum("pw,bchw->bchp", m.to(x.device, x.dtype), x)
    return x
