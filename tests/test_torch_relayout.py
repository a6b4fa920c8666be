"""The relayouts P7-P9 and P11-P14 of the PyTorch port vs the JAX Pallas
kernels they replace (CPU).

The port's plain versions (``ops/relayout.py``), which the dispatchers of
``ops/relayout_cuda.py`` take on a CPU tensor, are held bit for bit
(``np.array_equal``: a relayout copies, it computes nothing) to the
experiments' Pallas functions run in interpret mode (each module loaded by
path as a fresh module object, its ``pl`` swapped for one whose
``pallas_call`` interprets): P7 ``transpose_kernel_r3.py:make_transpose``
at steps 0-3 (its block shapes read the module's ``C``, ``B`` and ``HW``,
set on the fresh module; the experiment is never edited), P8, P9, P11
``relayout_probe_r5h.py:pallas_t3``, ``pallas_t2``, ``pallas_t2_rev``, and
P12, P13, P14 ``mosaic_micro_r5h.py:t3_blocked``, ``t2_blocked``,
``pack_blocked``; in fp32 and bf16 (from one fp32 draw, rounded the same
way on both sides), at a shape cut into several blocks and at one of odd
extents. The dispatchers' checks (block sizes that do not divide, steps,
ranks) are held to the plain versions', and their backward is the inverse
permutation.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hvi_cidnet_torch.ops import relayout_cuda as rc
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# (N or HW, C, B, block): three blocks of 6 rows; odd extents in blocks of 7
SHAPES = [(24, 4, 8, 6), (21, 3, 5, 7)]


def _experiment(name: str):
    """An ``experiments/`` module, loaded by path (a fresh module object)."""
    path = os.path.join(REPO, "experiments", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_exp_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _InterpretPallas:
    """``jax.experimental.pallas`` with ``pallas_call`` in interpret mode."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call, interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture(scope="module")
def exp():
    mods = {n: _experiment(n) for n in ("transpose_kernel_r3", "relayout_probe_r5h",
                                        "mosaic_micro_r5h")}
    for mod in mods.values():
        mod.pl = _InterpretPallas()
    return mods


def _inputs(shape, dtype: str, seed: int):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t_dt, j_dt = DTYPES[dtype]
    return torch.from_numpy(x).to(t_dt), jnp.asarray(x).astype(j_dt)


def _equal(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("steps", [0, 1, 2, 3])
def test_p7_plain_matches_pallas(exp, steps, shape, dtype):
    hw, c, b, hwt = shape
    mod = exp["transpose_kernel_r3"]
    mod.C, mod.B, mod.HW = c, b, hw  # make_transpose's block shapes read these
    x, xj = _inputs((hw, c, b), dtype, seed=steps)
    ref = mod.make_transpose(hwt, steps, xj.dtype)(xj)
    _equal(rc.transpose_steps(x, hwt, steps), ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name, port, jax_fn", [
    ("P8", rc.relayout_t3, "pallas_t3"), ("P9", rc.relayout_t2, "pallas_t2"),
    ("P11", rc.relayout_t2_rev, "pallas_t2_rev")], ids=["P8", "P9", "P11"])
def test_p8_p9_p11_plain_match_pallas(exp, name, port, jax_fn, shape, dtype):
    n, c, b, n_blk = shape
    # P11 reads (B, C, N)
    x, xj = _inputs((b, c, n) if name == "P11" else (n, c, b), dtype, seed=len(name))
    ref = getattr(exp["relayout_probe_r5h"], jax_fn)(xj, n_blk)
    _equal(port(x, n_blk), ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name, port, jax_fn", [
    ("P12", rc.t3_blocked, "t3_blocked"), ("P13", rc.t2_blocked, "t2_blocked"),
    ("P14", rc.pack_blocked, "pack_blocked")], ids=["P12", "P13", "P14"])
def test_p12_p13_p14_plain_match_pallas(exp, name, port, jax_fn, shape, dtype):
    n, c, b, n_blk = shape
    x, xj = _inputs((n, c, b), dtype, seed=int(name[1:]))
    ref = getattr(exp["mosaic_micro_r5h"], jax_fn)(xj, n_blk)
    _equal(port(x, n_blk), ref)


def test_p14_one_block_is_the_hwcb_entry():
    """P14 with one block of all H W rows turns (H W, 3, B) into NHWC; P11
    turns NHWC, viewed as (B, 1, H W 3), back into (H, W, 3, B)."""
    h, w, b = 4, 6, 3
    nhwc = torch.from_numpy(np.random.default_rng(0).standard_normal((b, h, w, 3)))
    hwcb = nhwc.permute(1, 2, 3, 0).contiguous()
    entry = rc.pack_blocked(hwcb.view(h * w, 3, b), h * w).view(b, h, w, 3)
    assert torch.equal(entry, nhwc)
    assert torch.equal(rc.relayout_t2_rev(nhwc.view(b, 1, h * w * 3)).view(h, w, 3, b), hwcb)


@pytest.mark.parametrize("call, match", [
    (lambda x: rc.transpose_steps(x, 5, 3), "does not divide"),
    (lambda x: rc.transpose_steps(x, 6, 4), "steps must be"),
    (lambda x: rc.relayout_t3(x, 5), "does not divide"),
    (lambda x: rc.relayout_t2_rev(x, 5), "does not divide"),
    (lambda x: rc.t3_blocked(x, 0), "does not divide"),
    (lambda x: rc.pack_blocked(x, 7), "does not divide"),
    (lambda x: rc.relayout_t2(x[0], 2), "3-D"),
], ids=["p7_block", "p7_steps", "p8_block", "p11_block", "p12_block", "p14_block", "rank"])
def test_dispatchers_raise_as_the_plain_versions(call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.zeros(24, 4, 8))


@pytest.mark.parametrize("name", ["P7", "P8", "P9", "P11", "P12", "P13", "P14"])
def test_backward_is_the_inverse_permutation(name):
    fn = {"P7": lambda t: rc.transpose_steps(t, 6, 2), "P8": rc.relayout_t3,
          "P9": rc.relayout_t2, "P11": rc.relayout_t2_rev,
          "P12": lambda t: rc.t3_blocked(t, 6), "P13": lambda t: rc.t2_blocked(t, 6),
          "P14": lambda t: rc.pack_blocked(t, 6)}[name]
    x = torch.randn(24, 4, 8, generator=torch.Generator().manual_seed(1), requires_grad=True)
    out = fn(x)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    (gx,) = torch.autograd.grad(out, x, grad)
    # the gradient of a copy under a permutation is the gradient put back
    assert torch.equal(fn(gx), grad)


def test_p7_as_written_misshapes_its_output_when_hwt_equals_an_axis(exp):
    """``make_transpose`` widens every block axis equal to ``hwt`` to HW:
    with B == hwt its steps-1 output is (HW, HW, C), not (HW, B, C). The
    tests above take hwt apart from C and B; the port has no such case."""
    mod = exp["transpose_kernel_r3"]
    mod.C, mod.B, mod.HW = 4, 8, 24
    x, xj = _inputs((24, 4, 8), "fp32", seed=0)
    assert np.asarray(mod.make_transpose(8, 1, jnp.float32)(xj)).shape == (24, 24, 4)
    assert rc.transpose_steps(x, 8, 1).shape == (24, 8, 4)
