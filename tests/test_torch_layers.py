"""CIDNet layers of the PyTorch port vs the JAX package (CPU, fp32 unless
stated).

Parameters: one tiny-config (8, 8, 16, 32) draw, the same values on both
sides (HWIO for JAX, OIHW for the port); inputs are made with numpy from a
seed. JAX activations are HWCB, the port's NCHW.
Tolerance for single layers: 1e-5 (fp32; conv and attention sums in
another order, through a softmax and a LayerNorm).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hvi_cidnet_tpu.models import layers as jl
from hvi_cidnet_tpu.ops.attention import channel_attention_xla
from hvi_cidnet_tpu.ops.conv import layer_norm_channels as jax_ln
from hvi_cidnet_tpu.ops.pallas_gate import kernel_flags
from hvi_cidnet_torch.compat.jax_params import jax_params_to_torch
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
from hvi_cidnet_torch.ops.attention import channel_attention
from hvi_cidnet_torch.ops.conv import layer_norm_channels
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """(JAX params, port model) with equal values. Drawn on the port side
    (a JAX init runs op by op here and takes tens of seconds); the JAX
    init -> ``jax_params_to_torch`` direction is tested in
    test_torch_cidnet.py. LN weights/biases and temperatures are perturbed
    away from their ones/zeros init so the affine terms are exercised."""
    model = CIDNet(CIDNetConfig(**TINY), generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("norm.weight", "norm.bias", "temperature")):
                v += torch.from_numpy(rng.uniform(-0.5, 0.5, tuple(v.shape)).astype(np.float32))
    p = {
        k: jnp.asarray(v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4 else v.numpy())
        for k, v in model.state_dict().items()
    }
    # the bridge the parity tests rely on maps these back exactly
    back = jax_params_to_torch({k: np.asarray(v) for k, v in p.items()})
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    return p, model


def _act(b, c, h, w, seed, scale=1.0):
    """(HWCB jax array, NCHW torch tensor) of the same values."""
    x = (np.random.default_rng(seed).standard_normal((b, c, h, w)) * scale).astype(np.float32)
    return jnp.asarray(x.transpose(2, 3, 1, 0)), torch.from_numpy(x)


def _close(got: torch.Tensor, ref_hwcb, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(ref_hwcb, np.float32).transpose(3, 2, 0, 1),
        atol=atol, rtol=0,
    )


def test_layer_norm_fp32():
    xj, xt = _act(2, 16, 6, 5, 0, scale=3.0)
    w = np.random.default_rng(1).uniform(0.5, 1.5, 16).astype(np.float32)
    b = np.random.default_rng(2).uniform(-0.5, 0.5, 16).astype(np.float32)
    ref = jax_ln(xj + 1.5, jnp.asarray(w), jnp.asarray(b))
    got = layer_norm_channels(xt + 1.5, torch.from_numpy(w), torch.from_numpy(b))
    _close(got, ref)


def test_layer_norm_bf16():
    """bf16: fp32 statistics, bf16 apply in both. XLA's CPU backend may keep
    a bf16 elementwise chain in fp32 and round once where torch rounds each
    op, so the two differ by a few bf16 ulps: 4 ulps at |y| < 4 (2**-5)."""
    xj, xt = _act(2, 16, 6, 5, 3, scale=2.0)
    w = np.random.default_rng(4).uniform(0.5, 1.5, 16).astype(np.float32)
    b = np.random.default_rng(5).uniform(-0.5, 0.5, 16).astype(np.float32)
    xb = xt.to(torch.bfloat16)
    ref = jax_ln(jnp.asarray(xj).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
    got = layer_norm_channels(xb, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _close(got, ref.astype(jnp.float32), atol=2**-5)


@pytest.mark.parametrize("heads,normalize_qk,fold", [(4, True, True), (1, True, False), (2, False, True)])
def test_channel_attention(heads, normalize_qk, fold):
    c = 16
    qj, qt = _act(2, c, 5, 7, 10)
    kj, kt = _act(2, c, 5, 7, 11)
    vj, vt = _act(2, c, 5, 7, 12)
    rng = np.random.default_rng(13)
    temp = rng.uniform(0.5, 2.0, (heads, 1, 1)).astype(np.float32)
    w_oihw = rng.uniform(-0.3, 0.3, (c, c, 1, 1)).astype(np.float32)
    w_hwio = jnp.asarray(w_oihw.transpose(2, 3, 1, 0))
    ref = channel_attention_xla(
        qj, kj, vj, jnp.asarray(temp), heads, normalize_qk=normalize_qk,
        w_proj=w_hwio if fold else None,
    )
    got = channel_attention(
        qt, kt, vt, torch.from_numpy(temp), heads, normalize_qk=normalize_qk,
        w_proj=torch.from_numpy(w_oihw) if fold else None,
    )
    _close(got, ref)


def test_iel(models):
    p, model = models
    xj, xt = _act(2, 16, 8, 6, 20)
    _close(model.HV_LCA2.gdfn(xt), jax.jit(lambda p, x: jl.iel(p, "HV_LCA2.gdfn", x))(p, xj))


def test_cab(models):
    p, model = models
    xj, xt = _act(2, 16, 8, 6, 21)
    yj, yt = _act(2, 16, 8, 6, 22)
    ref = jax.jit(lambda p, x, y: jl.cab(p, "I_LCA2.ffn", x, y, 4))(p, xj, yj)
    _close(model.I_LCA2.ffn(xt, yt), ref)


def test_norm_downsample(models):
    p, model = models
    xj, xt = _act(2, 8, 12, 10, 23)
    got = model.IE_block2(xt)
    assert got.shape == (2, 16, 6, 5)
    _close(got, jax.jit(lambda p, x: jl.norm_downsample(p, "IE_block2", x))(p, xj))


@pytest.mark.parametrize("fold", [True, False])
def test_norm_upsample_vs_both_fold_arms(models, fold):
    """The port always folds; JAX's unfolded arm is the plain graph, so the
    fold is held against both."""
    p, model = models
    xj, xt = _act(2, 16, 6, 5, 24)
    yj, yt = _act(2, 8, 12, 10, 25)
    with kernel_flags(upsample_fold=fold):
        ref = jax.jit(lambda p, x, y: jl.norm_upsample(p, "HVD_block2", x, y))(p, xj, yj)
    _close(model.HVD_block2(xt, yt), ref)


def test_hv_lca(models):
    p, model = models
    xj, xt = _act(2, 32, 4, 6, 26)
    yj, yt = _act(2, 32, 4, 6, 27)
    ref = jax.jit(lambda p, x, y: jl.hv_lca(p, "HV_LCA3", x, y, 8))(p, xj, yj)
    _close(model.HV_LCA3(xt, yt), ref)


def test_i_lca(models):
    p, model = models
    xj, xt = _act(2, 8, 8, 6, 28)
    yj, yt = _act(2, 8, 8, 6, 29)
    ref = jax.jit(lambda p, x, y: jl.i_lca(p, "I_LCA6", x, y, 2))(p, xj, yj)
    _close(model.I_LCA6(xt, yt), ref)
