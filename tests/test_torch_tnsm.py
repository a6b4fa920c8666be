"""TNSM CIDNet of the PyTorch port vs the JAX package (CPU, fp32).

The tiny TNSM forward (channels 8/8/16/32), serving and ``training=True``
(the fused noise map), and the ``use_tnsm=False`` graph are held to the JAX
package's bar against torch, 2e-5 (docs/DESIGN.md, "Numerics policy"). The
JAX forwards run once, in one module-scoped fixture. Parameters are drawn
on the port side and handed to JAX in its HWIO layout. The liveness pins
fix which blocks serving computes: ``I_LCA5`` feeds ``HV_TNSM5``, while
``I_TNSM5`` and ``noise_fusion`` reach nothing unless ``training``. The
general bilinear resize the noise maps take is held to the JAX one.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import HVIGates as JaxGates
from hvi_cidnet_tpu.models.cidnet import cidnet_forward as jax_forward
from hvi_cidnet_tpu.models.cidnet import init_cidnet
from hvi_cidnet_tpu.ops.resize import _interp_matrix as jax_interp_matrix
from hvi_cidnet_tpu.ops.resize import resize_bilinear_hwcb
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates, cidnet_forward
from hvi_cidnet_torch.ops.resize import _interp_matrix as port_interp_matrix
from hvi_cidnet_torch.ops.resize import resize_bilinear
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
GATED = dict(gated=True, alpha_s=1.3)
ATOL = 2e-5


def _jax_layout(model: CIDNet) -> dict:
    return {
        k: jnp.asarray(v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4 else v.numpy())
        for k, v in model.state_dict().items()
    }


def _port(**kw) -> CIDNet:
    cfg = CIDNetConfig(variant="tnsm", **TINY, **kw)
    return CIDNet(cfg, generator=torch.Generator().manual_seed(17)).eval()


@pytest.fixture(scope="module")
def run():
    """The port's models, the input, and every JAX output the tests read."""
    model, plain = _port(), _port(use_tnsm=False)
    x = np.random.default_rng(0).uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    cfg = JaxConfig(variant="tnsm", **TINY)
    p = _jax_layout(model)
    ref = {
        "default": jax.jit(lambda p, x: jax_forward(p, x, cfg)[0])(p, xj),
        "gated": jax.jit(lambda p, x: jax_forward(p, x, cfg, JaxGates(**GATED))[0])(p, xj),
        "training": jax.jit(lambda p, x: jax_forward(p, x, cfg, training=True))(p, xj),
        "no_tnsm": jax.jit(lambda p, x: jax_forward(
            p, x, JaxConfig(variant="tnsm", use_tnsm=False, **TINY))[0])(_jax_layout(plain), xj),
    }
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return model, plain, torch.from_numpy(x), ref


def _serve(model, x, gates=HVIGates()):
    with torch.no_grad():
        rgb, noise = cidnet_forward(model, x, gates)
    assert noise is None
    return rgb


@pytest.mark.parametrize("case", ["default", "gated"])
def test_tiny_tnsm_forward_matches_jax(run, case):
    model, _, x, ref = run
    got = _serve(model, x, HVIGates(**(GATED if case == "gated" else {})))
    assert got.shape == (2, 16, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref[case], atol=ATOL, rtol=0)


def test_tiny_tnsm_training_forward_matches_jax(run):
    """rgb and the fused noise map: the twelve maps resized to 16 x 24 with
    ``align_corners=False``, ``noise_fusion`` and a sigmoid, NHWC."""
    model, _, x, ref = run
    with torch.no_grad():
        rgb, noise = cidnet_forward(model, x, training=True)
    ref_rgb, ref_noise = ref["training"]
    assert noise.shape == (2, 16, 24, 3) == ref_noise.shape
    np.testing.assert_allclose(rgb.numpy(), ref_rgb, atol=ATOL, rtol=0)
    np.testing.assert_allclose(noise.numpy(), ref_noise, atol=ATOL, rtol=0)
    # training adds the noise output and changes nothing else
    assert torch.equal(rgb, _serve(model, x))


def test_use_tnsm_false_matches_jax(run):
    _, plain, x, ref = run
    assert not any("TNSM" in k or "noise_fusion" in k for k in plain.state_dict())
    np.testing.assert_allclose(_serve(plain, x).numpy(), ref["no_tnsm"], atol=ATOL, rtol=0)
    with torch.no_grad():
        assert cidnet_forward(plain, x, training=True)[1] is None


def test_full_width_tnsm_param_count():
    assert CIDNet(CIDNetConfig(variant="tnsm")).count_params() == 3_072_653


@pytest.mark.parametrize("config", ["tiny", "full", "no_tnsm"])
def test_tnsm_state_dict_keys_and_shapes_equal_jax(config):
    kw = {"tiny": TINY, "full": {}, "no_tnsm": {"use_tnsm": False}}[config]
    cfg = dict(variant="tnsm", **kw)
    shapes = jax.eval_shape(lambda: init_cidnet(jax.random.PRNGKey(0), JaxConfig(**cfg)))
    ref = {
        k: (s.shape[3], s.shape[2], s.shape[0], s.shape[1]) if len(s.shape) == 4 else s.shape
        for k, s in shapes.items()
    }
    got = {k: tuple(v.shape) for k, v in CIDNet(CIDNetConfig(**cfg)).state_dict().items()}
    assert got == ref


def test_tnsm_is_drawn_after_the_base_tree():
    """One seed gives TNSM the base model's weights, and the TNSM blocks
    come after them (HV before I, levels 1-6, then noise_fusion, as JAX
    draws them)."""
    gen = lambda: torch.Generator().manual_seed(3)
    base = CIDNet(CIDNetConfig(**TINY), generator=gen()).state_dict()
    tnsm = CIDNet(CIDNetConfig(variant="tnsm", **TINY), generator=gen()).state_dict()
    assert list(tnsm)[: len(base)] == list(base)
    for k, v in base.items():
        assert torch.equal(tnsm[k], v), k
    extra = [k.split(".")[0] for k in list(tnsm)[len(base):]]
    order = list(dict.fromkeys(extra))
    assert order == [f"{b}{i}" for i in range(1, 7) for b in ("HV_TNSM", "I_TNSM")] + ["noise_fusion"]


def _perturbed(model: CIDNet, prefix: str) -> CIDNet:
    out = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        hit = 0
        for k, v in out.state_dict().items():
            if k.startswith(prefix + "."):
                v.add_(0.5 * torch.randn(v.shape, generator=gen))
                hit += 1
    assert hit
    return out


@pytest.mark.parametrize("prefix,live", [
    ("I_TNSM5", False), ("noise_fusion", False), ("I_LCA5", True), ("HV_TNSM5", True),
])
def test_serving_liveness(run, prefix, live):
    """Serving skips what reaches nothing (the output is bitwise the same
    when its weights change) and computes what does."""
    model, _, x, _ = run
    ref = _serve(model, x)
    got = _serve(_perturbed(model, prefix), x)
    assert torch.equal(got, ref) is not live


@pytest.mark.parametrize("prefix", ["I_TNSM5", "noise_fusion"])
def test_training_reads_what_serving_skips(run, prefix):
    model, _, x, _ = run
    with torch.no_grad():
        _, ref = cidnet_forward(model, x, training=True)
        _, got = cidnet_forward(_perturbed(model, prefix), x, training=True)
    assert not torch.equal(got, ref)


# (input H, W, output H, W): the noise maps' x2, x4 and x8 (levels 1/6, 2/5,
# 3/4 at 600 x 400 and at the tiny test's 16 x 24), and general ratios
RESIZES = [(200, 300, 400, 600), (100, 150, 400, 600), (50, 75, 400, 600),
           (8, 12, 16, 24), (4, 6, 16, 24), (2, 3, 16, 24), (7, 5, 3, 11)]
_ids = lambda s: "{}x{}-{}x{}".format(*s)


@pytest.mark.parametrize("shape", RESIZES, ids=_ids)
def test_half_pixel_matrix_bitwise_equal_jax(shape):
    """The weights the general resize runs with, as JAX builds them."""
    h, w, oh, ow = shape
    for size, out in ((h, oh), (w, ow)):
        np.testing.assert_array_equal(port_interp_matrix(size, out, False),
                                      jax_interp_matrix(size, out, False))


@pytest.mark.parametrize("shape", RESIZES, ids=_ids)
def test_resize_bilinear_matches_jax(shape):
    h, w, oh, ow = shape
    x = np.random.default_rng(h * w).uniform(0, 1, (2, 1, h, w)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), oh, ow)
    ref = resize_bilinear_hwcb(jnp.asarray(x.transpose(2, 3, 1, 0)), oh, ow, align_corners=False)
    assert got.shape == (2, 1, oh, ow)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(3, 2, 0, 1), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", RESIZES[:6], ids=_ids)
def test_resize_bilinear_matches_interpolate(shape):
    """The independent check: at the x2, x4 and x8 ratios torch's fp32
    source positions ((i + 0.5) / r - 0.5) are exact, so only the order of
    the two axes' sums differs."""
    h, w, oh, ow = shape
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 1, h, w)).astype(np.float32))
    ref = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False)
    torch.testing.assert_close(resize_bilinear(x, oh, ow), ref, atol=1e-6, rtol=0)
