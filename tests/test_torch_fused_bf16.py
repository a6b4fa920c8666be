"""The fused block route's plain versions in bf16 vs the TPU kernels they
replace (CPU): the kernels' rounding points.

The TPU kernels round in bf16 at their matrix products' operands: P3
(``experiments/iel_pallas_nhcw.py``) stores the LayerNorm's output in the
activation dtype before the expansion (``:140``) and rounds the gates'
product before ``project_out`` (``:163``); P5 (``experiments/
fused_pallas_nhcw.py``) rounds the H pass's rows before the W pass (``:98``)
and takes its W taps in the activation dtype (``:153``). The port's plain
versions (``ops/ln_iel.py:ln_iel``, ``ops/conv3x3_cuda.py:
conv3x3_half_prelu_plain``) round at the same points, so in bf16 they
compute the TPU kernels' function; in fp32 every such cast is the identity
(the fp32 tests in ``test_torch_fused_route.py`` hold them at 1e-5).

Here both sides take the same bf16 inputs and bf16 weights (the model's
conv weights hold the compute dtype; the LayerNorm's weight and bias stay
fp32), the Pallas kernels run in interpret mode, and the bar is: equal,
but for one bf16 ulp at max(|got|, |ref|) on at most 0.5% of the elements
(fp32 sums in another order can flip one rounding; 0 to 0.06% where first
measured). The fp32-inside rule that the route followed before (every stage
fp32, one rounding at the end) fails that bar, and the experiments' P2
(``iel_fused_pallas.py``, which also rounds the expansion and the first
depthwise conv) is another function than P3 in bf16.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hvi_cidnet_torch.ops import conv3x3_cuda, ln_iel_cuda
from test_torch_fused_route import _experiment, _hwio, _InterpretPallas, _ln_iel_inputs
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

ULP_SHARE = 0.005  # elements allowed one bf16 ulp off


@pytest.fixture(scope="module")
def exp():
    mods = {n: _experiment(n) for n in ("iel_fused_pallas", "iel_pallas_nhcw",
                                        "fused_pallas_nhcw")}
    mods["iel_fused_pallas"].INTERPRET = True
    mods["fused_pallas_nhcw"].pl = _InterpretPallas()
    return mods


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).bfloat16()


def _jax_nhcw(t: torch.Tensor) -> jnp.ndarray:
    """A bf16 NCHW tensor as the experiments' bf16 NHCW array."""
    return jnp.asarray(t.float().permute(0, 2, 1, 3).contiguous().numpy()).astype(jnp.bfloat16)


def _torch_nchw(y) -> torch.Tensor:
    return torch.from_numpy(np.array(y.astype(jnp.float32))).permute(0, 2, 1, 3)


def _one_ulp_on_few(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(every element within one bf16 ulp at max(|got|, |ref|), the share of
    elements that differ)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    _, e = torch.frexp(torch.maximum(got.abs(), ref.abs()))
    ulp = torch.ldexp(torch.ones_like(got), e - 8)
    return bool((diff <= ulp).all()), float((diff > 0).float().mean())


def _passes(got, ref) -> bool:
    within, share = _one_ulp_on_few(got, ref)
    return within and share <= ULP_SHARE


def _ln_iel_case(exp, c: int, residual: bool, kernel: str = "p3"):
    """(the port's plain bf16 P2/P3, the fp32-inside rule, the Pallas
    kernel's output) on ``_ln_iel_inputs`` rounded to bf16."""
    x, weights = _ln_iel_inputs(c, c + residual)
    xb = _bf16(x)
    ln = [torch.from_numpy(w) for w in weights[:2]]
    conv = [_bf16(w) for w in weights[2:]]
    got = ln_iel_cuda.ln_iel(xb, *ln, *conv, residual)
    fp32_inside = ln_iel_cuda.ln_iel(xb.float(), *ln, *(w.float() for w in conv),
                                     residual).bfloat16()
    ln_j = [jnp.asarray(w.numpy()) for w in ln]
    conv_j = [_hwio(w.float().numpy()) for w in conv]
    if kernel == "p3":
        ref = exp["iel_pallas_nhcw"]._pallas_ln_iel(_jax_nhcw(xb), *ln_j, *conv_j, residual,
                                                   interpret=True)
    else:
        ref = exp["iel_fused_pallas"].fused_iel(_jax_nhcw(xb), *conv_j, *ln_j, residual)
    return got, fp32_inside, _torch_nchw(ref)


# (C_in, C_out, H, W, seed) of P5's cases: the fp32 test's, and a wider one
P5_CASES = [(12, 8, 20, 36, 5), (36, 36, 32, 48, 6)]


def _p5_case(exp, cin: int, cout: int, h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((1, cin, h, w)).astype(np.float32))
    wt = _bf16((rng.standard_normal((cout, cin, 3, 3)) / 6).astype(np.float32))
    alpha = torch.full((1,), 0.25)
    got = conv3x3_cuda.conv3x3_half_prelu(x, wt, alpha)
    fp32_inside = conv3x3_cuda.conv3x3_half_prelu(x.float(), wt.float(), alpha).bfloat16()
    ref = exp["fused_pallas_nhcw"]._pallas_down(_jax_nhcw(x), _hwio(wt.float().numpy()),
                                               jnp.float32(0.25))
    return got, fp32_inside, _torch_nchw(ref)


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
@pytest.mark.parametrize("c", [12, 36])
def test_bf16_ln_iel_matches_p3(exp, c, residual):
    got, _, ref = _ln_iel_case(exp, c, residual)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    within, share = _one_ulp_on_few(got, ref)
    assert within and share <= ULP_SHARE, (within, share)


@pytest.mark.parametrize("case", P5_CASES, ids=str)
def test_bf16_p5_matches_pallas(exp, case):
    got, _, ref = _p5_case(exp, *case)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    within, share = _one_ulp_on_few(got, ref)
    assert within and share <= ULP_SHARE, (within, share)


@pytest.mark.parametrize("kernel", ["P2/P3", "P5"])
def test_fp32_inside_rule_fails_the_bar(exp, kernel):
    """Every stage in fp32 and one rounding at the end, the route's rule
    before the rounding points were taken: a third or more of the outputs
    move (by up to 3e-2 and 6e-2 where first measured), so the bar above
    bites."""
    if kernel == "P2/P3":
        got, fp32_inside, ref = _ln_iel_case(exp, 12, True)
    else:
        got, fp32_inside, ref = _p5_case(exp, *P5_CASES[0])
    assert _passes(got, ref)
    assert not _passes(fp32_inside, ref)
    assert _one_ulp_on_few(fp32_inside, ref)[1] > 0.2


def test_p2_and_p3_are_two_functions_in_bf16(exp):
    """A fact about the reference: P2 also rounds the expansion and the first
    depthwise conv to the activation dtype (``iel_fused_pallas.py:127``,
    ``:152``), P3 does not, so in bf16 they disagree (at C = 36 by max 4.7e-2,
    mean 4.1e-3 where first measured) and the port follows P3, whose
    rounding points are exactly its two products' operands."""
    got, _, p2 = _ln_iel_case(exp, 36, True, kernel="p2")
    _, _, p3 = _ln_iel_case(exp, 36, True)
    assert _passes(got, p3)
    assert not _passes(p2, p3)
    diff = (p2.float() - p3.float()).abs()
    assert diff.max().item() > 1e-2 and diff.mean().item() > 1e-3
