"""The port's training losses (``hvi_cidnet_torch/losses``) vs the JAX
package's (CPU, fp32).

L1, MSE, SSIM, the Edge chain and its Laplacian response: values and
gradients within 1e-6 absolute of the JAX functions under both of that
package's blur arms (``loss_blur_mxu`` on and off), at 2 x 32 x 40 and at
odd extents 2 x 33 x 39. The VGG19 taps against ``vgg_features`` on the
same weights (carried across by ``vgg_params_from_jax``), a torchvision-
layout file loaded by both ``load_vgg_torch``s, and ``perceptual_loss``
(perceptual and style arms) with ``gt`` detached. The JAX side runs eager.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvi_cidnet_tpu.losses import basic as jbasic
from hvi_cidnet_tpu.losses.perceptual import perceptual_loss as jax_perceptual
from hvi_cidnet_tpu.losses.vgg import load_vgg_torch as jax_load_vgg, vgg_features
from hvi_cidnet_tpu.ops.pallas_gate import kernel_flags
from hvi_cidnet_torch.losses import basic
from hvi_cidnet_torch.losses.perceptual import perceptual_loss
from hvi_cidnet_torch.losses.vgg import VGG19, VGGFeatures, load_vgg_torch, vgg_params_from_jax
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-6                 # losses: values and gradients, absolute
TOL_TAP = 1e-5             # VGG taps: relative to the tap's largest |value|
TOL_PERC = 1e-5            # perceptual loss value, relative
TOL_PERC_GRAD = 1e-4       # its gradient, relative to the largest |gradient|
SHAPES = [(2, 32, 40, 3), (2, 33, 39, 3)]
LAYERS = {"conv1_2": 1.0, "conv2_2": 1.0, "conv3_4": 1.0, "conv4_4": 1.0}
CRITERIA = ("mse", "l1", "fro")

# name -> (JAX fn of (a, b), port fn of (a, b)) on NHWC / NCHW images
LOSSES = {
    "l1": (jbasic.l1_loss, basic.l1_loss),
    "mse": (jbasic.mse_loss, basic.mse_loss),
    "ssim_loss": (lambda a, b: jbasic.ssim_loss(a, b, weight=0.5),
                  lambda a, b: basic.ssim_loss(a, b, weight=0.5)),
    "ssim_map_mean": (jbasic.ssim_map_mean, basic.ssim_map_mean),
    "edge": (jbasic.edge_loss, basic.edge_loss),
}


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


def _nchw(a: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).requires_grad_(grad)


@pytest.fixture(scope="module")
def jax_losses():
    """(shape, arm, name) -> (value, gradient wrt the first image, NHWC):
    one jitted program per arm (the flag is read when it traces), both
    shapes in it."""
    pairs = [tuple(jnp.asarray(t) for t in _pair(shape, si)) for si, shape in enumerate(SHAPES)]

    def everything(pairs):
        out = {}
        for shape, (a, b) in zip(SHAPES, pairs):
            for name, (fn, _) in LOSSES.items():
                out[shape, name] = jax.value_and_grad(lambda x, fn=fn: fn(x, b))(a)
            out[shape, "laplacian"] = (jbasic.laplacian_response(a), None)
        return out

    out = {}
    for arm in (True, False):
        with kernel_flags(loss_blur_mxu=arm):
            for (shape, name), (v, g) in jax.jit(everything)(pairs).items():
                out[shape, arm, name] = (np.asarray(v), None if g is None else np.asarray(g))
    return out


@pytest.mark.parametrize("arm", [True, False], ids=["mxu_arm", "conv_arm"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[1]}x{s[2]}")
@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_value_and_gradient_match_jax(jax_losses, name, shape, arm):
    a, b = _pair(shape, SHAPES.index(shape))
    x = _nchw(a, grad=True)
    value = LOSSES[name][1](x, _nchw(b))
    value.backward()
    ref, ref_grad = jax_losses[shape, arm, name]
    assert value.dtype == torch.float32
    assert abs(value.item() - float(ref)) <= TOL, (value.item(), ref)
    got = x.grad.numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - ref_grad).max() <= TOL


@pytest.mark.parametrize("arm", [True, False], ids=["mxu_arm", "conv_arm"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[1]}x{s[2]}")
def test_laplacian_response_matches_jax(jax_losses, shape, arm):
    a, _ = _pair(shape, SHAPES.index(shape))
    got = basic.laplacian_response(_nchw(a)).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - jax_losses[shape, arm, "laplacian"][0]).max() <= TOL


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_weighted_reduction_matches_jax(channels, reduction):
    a, b = _pair(SHAPES[0], 4)
    w = (np.random.default_rng(5).uniform(0, 1, SHAPES[0][:3] + (channels,)) > 0.5).astype(np.float32)
    ref = np.asarray(jbasic.l1_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), reduction))
    got = basic.l1_loss(_nchw(a), _nchw(b), _nchw(w), reduction).numpy()
    if reduction == "none":
        got = got.transpose(0, 2, 3, 1)
    # a sum of ~7,700 terms is ~1e3: one fp32 ulp there is 1.2e-4, so the
    # bar is relative for it
    scale = abs(float(ref)) if reduction == "sum" else 1.0
    assert np.abs(got - ref).max() <= TOL * scale


def test_unknown_reduction_raises():
    a, b = _pair(SHAPES[0], 0)
    with pytest.raises(ValueError, match="unknown reduction"):
        basic.l1_loss(_nchw(a), _nchw(b), reduction="max")


@pytest.fixture(scope="module")
def vgg_pair():
    """A JAX VGG19 tree (HWIO, drawn with numpy, as ``init_vgg`` lays it out)
    and the port's module on the same weights."""
    rng = np.random.default_rng(0)
    params, cin = {}, 3
    for name, kind, cout in VGG19[:26]:  # up to conv4_4
        if kind == "conv":
            params[name + ".weight"] = rng.normal(0, np.sqrt(2 / (9 * cin)), (3, 3, cin, cout)).astype(np.float32)
            params[name + ".bias"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
            cin = cout
    vgg = VGGFeatures()
    vgg.load_state_dict(vgg_params_from_jax(params), strict=True)
    return {k: jnp.asarray(v) for k, v in params.items()}, vgg.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def jax_perceptual_refs(vgg_pair):
    """criterion -> (percep, style, d percep / dx, d style / dx), NHWC, from
    one jitted program."""
    params, _ = vgg_pair
    a, b = (jnp.asarray(t) for t in _pair((2, 32, 32, 3), 10))

    def everything(params, a, b):
        out = {}
        for crit in CRITERIA:
            def arm(x, i, crit=crit):
                return jax_perceptual(params, x, b, LAYERS, criterion=crit, style_weight=0.5)[i]
            out[crit] = (arm(a, 0), arm(a, 1), jax.grad(arm)(a, 0), jax.grad(arm)(a, 1))
        return out

    return {k: [np.asarray(t) for t in v] for k, v in jax.jit(everything)(params, a, b).items()}


def _taps_close(got: dict, ref: dict) -> None:
    for name in LAYERS:
        r = np.asarray(ref[name])
        g = got[name].numpy().transpose(0, 2, 3, 1)
        assert g.shape == r.shape, name
        assert np.abs(g - r).max() <= TOL_TAP * np.abs(r).max(), name


def test_vgg_taps_match_jax(vgg_pair):
    params, vgg = vgg_pair
    x, _ = _pair((2, 32, 40, 3), 6)
    ref = vgg_features(params, jnp.asarray(x), list(LAYERS))
    with torch.no_grad():
        got = vgg(_nchw(x), list(LAYERS))
    _taps_close(got, ref)
    assert got["conv4_4"].shape == (2, 512, 4, 5)
    assert got["conv4_4"].min() < 0  # taps precede the ReLU


def test_vgg_seeded_init_is_he_normal():
    vgg = VGGFeatures(generator=torch.Generator().manual_seed(3))
    w = vgg.features[25].weight  # conv4_4
    assert abs(w.std().item() - np.sqrt(2.0 / (512 * 9))) < 1e-3
    assert all(m.bias.abs().max() == 0 for m in vgg.features if hasattr(m, "bias"))
    again = VGGFeatures(generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.features[0].weight, vgg.features[0].weight)


def _torchvision_vgg19(seed: int) -> dict:
    """A full torchvision ``vgg19`` state dict (features and classifier)."""
    rng = np.random.default_rng(seed)
    state, cin = {}, 3
    for i, (_, kind, cout) in enumerate(VGG19):
        if kind == "conv":
            state[f"features.{i}.weight"] = torch.from_numpy(
                rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(np.float32))
            state[f"features.{i}.bias"] = torch.from_numpy(
                rng.normal(0, 0.05, (cout,)).astype(np.float32))
            cin = cout
    for i, (n_in, n_out) in {0: (16, 8), 3: (8, 8), 6: (8, 4)}.items():  # shapes cut down
        state[f"classifier.{i}.weight"] = torch.zeros(n_out, n_in)
        state[f"classifier.{i}.bias"] = torch.zeros(n_out)
    return state


def test_torchvision_file_loads_in_both_packages(tmp_path, vgg_pair):
    state = _torchvision_vgg19(7)
    path = str(tmp_path / "vgg19.pth")
    torch.save(state, path)
    vgg = load_vgg_torch(path)
    assert vgg.features[25].weight.shape == (512, 512, 3, 3)
    assert torch.equal(vgg.features[25].weight, state["features.25.weight"])
    x, _ = _pair((2, 32, 40, 3), 8)
    ref = vgg_features(jax_load_vgg(path), jnp.asarray(x), list(LAYERS))
    with torch.no_grad():
        got = vgg(_nchw(x), list(LAYERS))
    _taps_close(got, ref)


def test_vgg_file_missing_a_conv_raises(tmp_path):
    state = _torchvision_vgg19(9)
    del state["features.25.weight"]
    path = str(tmp_path / "vgg19_cut.pth")
    torch.save(state, path)
    with pytest.raises(KeyError, match="features.25.weight"):
        load_vgg_torch(path)


@pytest.mark.parametrize("criterion", CRITERIA)
def test_perceptual_and_style_match_jax(vgg_pair, jax_perceptual_refs, criterion):
    _, vgg = vgg_pair
    a, b = _pair((2, 32, 32, 3), 10)
    p_ref, s_ref, pg_ref, sg_ref = jax_perceptual_refs[criterion]
    for i, (ref, grad) in enumerate(((p_ref, pg_ref), (s_ref, sg_ref))):
        x, gt = _nchw(a, grad=True), _nchw(b, grad=True)
        value = perceptual_loss(vgg, x, gt, LAYERS, criterion=criterion, style_weight=0.5)[i]
        value.backward()
        assert abs(value.item() - float(ref)) <= TOL_PERC * abs(float(ref)), i
        g = x.grad.numpy().transpose(0, 2, 3, 1)
        assert np.abs(g - grad).max() <= TOL_PERC_GRAD * np.abs(grad).max(), i
        assert gt.grad is None  # gt is detached (losses.py:133)


def test_perceptual_weight_zero_gives_none(vgg_pair):
    _, vgg = vgg_pair
    a, b = _pair((1, 16, 16, 3), 11)
    percep, style = perceptual_loss(vgg, _nchw(a), _nchw(b), LAYERS, perceptual_weight=0.0)
    assert percep is None and style is None
