"""The HWCB serving contract of the PyTorch port vs the JAX package (CPU,
fp32).

``cidnet_forward(..., input_layout="hwcb")`` takes (H, W, 3, B) and returns
(H, W, 3, B), TNSM's fused noise map too (``hvi_cidnet_tpu/models/
cidnet.py:cidnet_forward``). The tiny base, MSSA and TNSM forwards (TNSM
serving and ``training=True``) are held to the JAX package's at its bar
against torch, 2e-5, on parameters carried across by
``jax_params_to_torch``, at batch 2 (so the entry and exit relayouts
transpose; at batch 1 they are copies); the port's HWCB output is its
NHWC output permuted, bit for bit; the layout and x8 errors have the JAX
package's text. The JAX forwards run once, in one module-scoped fixture.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import cidnet_forward as jax_forward
from hvi_cidnet_torch.compat.jax_params import jax_params_to_torch, load_weights
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cidnet_forward
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
ATOL = 2e-5
VARIANTS = ("base", "mssa", "tnsm")


def _jax_layout(model: CIDNet) -> dict:
    """The port's parameters as a JAX parameter dict (HWIO convs)."""
    return {
        k: np.ascontiguousarray(v.numpy().transpose(2, 3, 1, 0)) if v.dim() == 4 else v.numpy().copy()
        for k, v in model.state_dict().items()
    }


@pytest.fixture(scope="module")
def run():
    """Per variant: the port's model (its weights through the bridge), the
    HWCB input and the JAX outputs the tests read."""
    x = np.random.default_rng(0).uniform(0, 1, (16, 24, 3, 2)).astype(np.float32)
    out = {}
    for i, variant in enumerate(VARIANTS):
        drawn = CIDNet(CIDNetConfig(variant=variant, **TINY),
                       generator=torch.Generator().manual_seed(21 + i))
        params = _jax_layout(drawn)
        port = load_weights(CIDNet(CIDNetConfig(variant=variant, **TINY)),
                            jax_params_to_torch(params)).eval()
        cfg = JaxConfig(variant=variant, **TINY)
        p = {k: jnp.asarray(v) for k, v in params.items()}
        fwd = jax.jit(lambda p, x, training: jax_forward(p, x, cfg, training=training,
                                                         input_layout="hwcb"),
                      static_argnums=2)
        ref = {"serve": fwd(p, jnp.asarray(x), False)}
        if variant == "tnsm":
            ref["training"] = fwd(p, jnp.asarray(x), True)
        out[variant] = (port, p, jax.tree_util.tree_map(np.asarray, ref))
    return torch.from_numpy(x), out


def _port(model, x, **kw):
    with torch.no_grad():
        return cidnet_forward(model, x, input_layout="hwcb", **kw)


@pytest.mark.parametrize("variant", VARIANTS)
def test_hwcb_forward_matches_jax(run, variant):
    x, out = run
    model, _, ref = out[variant]
    got = _port(model, x)
    if variant == "tnsm":
        got, noise = got
        assert noise is None
        ref_rgb, ref_noise = ref["serve"]
        assert ref_noise is None
    else:
        ref_rgb = ref["serve"]
    assert got.shape == (16, 24, 3, 2) == ref_rgb.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref_rgb, atol=ATOL, rtol=0)


def test_hwcb_tnsm_training_matches_jax(run):
    """rgb and the fused noise map, both (H, W, 3, B)."""
    x, out = run
    model, _, ref = out["tnsm"]
    rgb, noise = _port(model, x, training=True)
    ref_rgb, ref_noise = ref["training"]
    assert noise.shape == (16, 24, 3, 2) == ref_noise.shape
    np.testing.assert_allclose(rgb.numpy(), ref_rgb, atol=ATOL, rtol=0)
    np.testing.assert_allclose(noise.numpy(), ref_noise, atol=ATOL, rtol=0)


@pytest.mark.parametrize("training", [False, True], ids=["serve", "training"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_hwcb_is_nhwc_permuted_bitwise(run, variant, training):
    x, out = run
    model = out[variant][0]
    nhwc = x.permute(3, 0, 1, 2).contiguous()
    with torch.no_grad():
        ref = cidnet_forward(model, nhwc, training=training)
    got = _port(model, x, training=training)
    if variant != "tnsm":
        got, ref = (got, None), (ref, None)
    assert torch.equal(got[0], ref[0].permute(1, 2, 3, 0))
    assert (got[1] is None) == (ref[1] is None) == (variant != "tnsm" or not training)
    if got[1] is not None:
        assert torch.equal(got[1], ref[1].permute(1, 2, 3, 0))


@pytest.mark.parametrize("layout, shape", [("hwcb", (12, 16, 3, 1)), ("hwcb", (16, 20, 3, 2)),
                                           ("nchw", (16, 16, 3, 1))], ids=str)
def test_errors_match_jax(run, layout, shape):
    """An unknown layout, and H or W not a multiple of 8 read from
    ``x.shape[0:2]`` under "hwcb": the JAX package's ValueError text."""
    _, out = run
    model, p, _ = out["base"]
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as port_err:
        _port(model, torch.from_numpy(x)) if layout == "hwcb" else cidnet_forward(
            model, torch.from_numpy(x), input_layout=layout)
    with pytest.raises(ValueError) as jax_err:
        jax_forward(p, jnp.asarray(x), JaxConfig(**TINY), input_layout=layout)
    assert str(port_err.value) == str(jax_err.value)


def test_hwcb_takes_only_a_contiguous_input(run):
    """The forward makes its input contiguous once at the entry (before P14),
    so a strided HWCB input gives, bit for bit, what its ``.contiguous()``
    copy gives. (The name is older than this contract: the forward used to
    raise on a strided HWCB input.)"""
    x, out = run
    model = out["base"][0]
    strided = x.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous() and torch.equal(strided, x)
    assert torch.equal(_port(model, strided), _port(model, strided.contiguous()))


def _strided(x: torch.Tensor, case: str) -> torch.Tensor:
    """NHWC ``x`` as a view with other strides: the permute of an NCHW
    copy, or a crop of a larger tensor."""
    if case == "permuted":
        return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    big = torch.rand(x.shape[0], x.shape[1] + 8, x.shape[2] + 16, 3,
                     generator=torch.Generator().manual_seed(5))
    big[:, : x.shape[1], : x.shape[2]] = x
    return big[:, : x.shape[1], : x.shape[2]]


@pytest.mark.parametrize("case", ["permuted", "cropped", "fp16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_strided_and_fp16_nhwc_inputs_give_the_contiguous_fp32_forward(run, variant, case):
    """A strided NHWC input gives, bit for bit, the forward of its contiguous
    copy; an fp16 input the forward of its fp32 cast (the JAX ``rgb_to_hvi``
    casts any dtype to fp32, ``hvi_cidnet_tpu/ops/hvi.py:57``)."""
    x, out = run
    model = out[variant][0]
    nhwc = x.permute(3, 0, 1, 2).contiguous()
    if case == "fp16":
        x_in, x_ref = nhwc.half(), nhwc.half().float()
    else:
        x_in = _strided(nhwc, case)
        assert not x_in.is_contiguous() and torch.equal(x_in, nhwc)
        x_ref = x_in.contiguous()
    with torch.no_grad():
        got, ref = cidnet_forward(model, x_in), cidnet_forward(model, x_ref)
    if variant == "tnsm":
        (got, _), (ref, _) = got, ref
    assert got.dtype == torch.float32 and torch.equal(got, ref)
