"""The LCA interior of the PyTorch port vs the JAX package (CPU), and the
MSSA variant.

K5-K7's dispatchers (``ops/attention_cuda.py``, ``ops/norm_cuda.py``,
``ops/iel_cuda.py``) take their plain twins on a CPU tensor; each is held
here against the JAX Pallas kernel itself, run in interpret mode as the JAX
package's own tests run it. Inputs come from numpy with a seed; JAX
activations are HWCB or (B, C, N), the port's NCHW. Tolerances:

* fp32: 2e-5 for attention (the JAX kernel's own bar against its XLA twin,
  tests/test_attention_pallas.py) and 1e-5 for LayerNorm and the IEL
  branch (sums over C or nine taps in another order);
* bf16: 2**-5, four bf16 ulps at |y| < 4. Both sides keep fp32 statistics
  and fp32 taps, but XLA's CPU backend may carry a bf16 elementwise chain in
  fp32 and round once where torch rounds after each op.

The MSSA forward is held to the whole-forward bar, 2e-5 in fp32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hvi_cidnet_tpu.compat.torch_ckpt import to_torch_state_dict
from hvi_cidnet_tpu.eval.evaluator import Evaluator
from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import HVIGates as JaxGates
from hvi_cidnet_tpu.models.cidnet import cidnet_forward as jax_forward
from hvi_cidnet_tpu.models.cidnet import init_cidnet
from hvi_cidnet_tpu.ops.attention import attention_bcn_pallas
from hvi_cidnet_tpu.ops.iel_pallas import iel_branch_pallas
from hvi_cidnet_tpu.ops.norm_pallas import layer_norm_pallas
from hvi_cidnet_torch.cli import net_test
from hvi_cidnet_torch.compat.jax_params import load_weights
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates, cidnet_forward
from hvi_cidnet_torch.ops import attention_cuda, iel_cuda, norm_cuda
from hvi_cidnet_torch.serve import Enhancer
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
MSSA = dict(TINY, variant="mssa")
BF16_TOL = 2.0**-5


def _nchw_to_hwcb(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(2, 3, 1, 0))


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """Values that bf16 holds exactly, so both sides start from one input."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "no_fold"])
@pytest.mark.parametrize("normalize_qk", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("heads", [1, 2, 4, 8])
def test_k5_twin_matches_pallas(heads, normalize_qk, fold):
    b, c, h, w = 2, 16, 5, 7
    rng = np.random.default_rng(100 + heads)
    q, k, v = (rng.standard_normal((b, c, h, w)).astype(np.float32) * 0.5 for _ in range(3))
    temp = rng.uniform(0.5, 2.0, (heads, 1, 1)).astype(np.float32)
    w_oihw = (rng.standard_normal((c, c, 1, 1)) * 0.2).astype(np.float32)
    cp = c // heads
    ref = attention_bcn_pallas(
        *(jnp.asarray(t.reshape(b, c, h * w)) for t in (q, k, v)),
        jnp.asarray(np.repeat(temp.reshape(heads), cp)),
        jnp.asarray(w_oihw[:, :, 0, 0].T) if fold else None,  # (C_in, C_out), as the JAX fold
        heads, normalize_qk=normalize_qk, interpret=True,
    )
    got = attention_cuda.channel_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(temp), heads,
        normalize_qk=normalize_qk, w_proj=torch.from_numpy(w_oihw) if fold else None,
    )
    assert got.shape == (b, c, h, w)
    np.testing.assert_allclose(got.numpy().reshape(b, c, h * w), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [8, 36])
def test_k6_twin_matches_pallas(dtype, c):
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((3, c, 6, 5)) * 2 + 0.5).astype(np.float32)
    wgt = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16_exact(x)
    ref = layer_norm_pallas(
        jnp.asarray(_nchw_to_hwcb(x), dtype), jnp.asarray(wgt), jnp.asarray(bias), interpret=True
    )
    got = norm_cuda.layer_norm(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(wgt), torch.from_numpy(bias)
    )
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32).transpose(3, 2, 0, 1),
        atol=1e-5 if dtype == "float32" else BF16_TOL, rtol=0,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(12, 10), (8, 5)])
def test_k7_twin_matches_pallas(dtype, hw):
    """At 12 rows the Pallas kernel takes three 4-row tiles, so its first and
    last tiles meet the image's top and bottom, where dw2 pads dw1's output
    with zeros rather than values extrapolated by dw1."""
    h, w = hw
    b, c = 2, 20
    rng = np.random.default_rng(h * w)
    y = (rng.standard_normal((b, c, h, w)) * 0.7).astype(np.float32)
    w1 = (rng.standard_normal((c, 1, 3, 3)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((c, 1, 3, 3)) * 0.3).astype(np.float32)
    if dtype == "bfloat16":  # the port's twin takes the weights in bf16, the Pallas kernel in fp32
        y, w1, w2 = _bf16_exact(y), _bf16_exact(w1), _bf16_exact(w2)
    hwio = lambda t: jnp.asarray(np.ascontiguousarray(t.transpose(2, 3, 1, 0)))
    ref = iel_branch_pallas(jnp.asarray(_nchw_to_hwcb(y), dtype), hwio(w1), hwio(w2), interpret=True)
    dt = getattr(torch, dtype)
    got = iel_cuda.iel_branch(torch.from_numpy(y).to(dt), torch.from_numpy(w1).to(dt),
                              torch.from_numpy(w2).to(dt))
    assert got.dtype == dt
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32).transpose(3, 2, 0, 1),
        atol=1e-5 if dtype == "float32" else BF16_TOL, rtol=0,
    )


def test_k7_zero_padding_rule_is_what_the_twin_computes():
    """The rule itself, without the Pallas kernel: a dw1 that extrapolates
    past the image border would change the first and last rows."""
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.standard_normal((1, 3, 6, 5)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((3, 1, 3, 3)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((3, 1, 3, 3)).astype(np.float32))
    conv = lambda t, wt, pad: torch.nn.functional.conv2d(t, wt, padding=pad, groups=3)
    t1_ext = conv(torch.nn.functional.pad(y, (2, 2, 2, 2)), w1, 0)  # dw1 on the 1-ring too
    wrong = torch.tanh(conv(t1_ext, w2, 0)) + t1_ext[:, :, 1:-1, 1:-1]
    got = iel_cuda.iel_branch(y, w1, w2)
    t1 = conv(y, w1, 1)
    torch.testing.assert_close(got, torch.tanh(conv(t1, w2, 1)) + t1, atol=0, rtol=0)
    assert (got - wrong)[:, :, [0, -1]].abs().max() > 1e-3
    torch.testing.assert_close(got[:, :, 1:-1, 1:-1], wrong[:, :, 1:-1, 1:-1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(3, 12, 7, 5), (1, 8, 1, 33)])
def test_split_plan_covers_space_without_empty_splits(shape):
    """K5's launch plan (``attention_plan``, which replaced ``split_plan``):
    the scores and apply slices cover N in whole tiles, none empty."""
    b, c, h, w = shape
    for heads in (1, 2, 4):
        for itemsize in (4, 2):
            p = attention_cuda.attention_plan(b, c, heads, h * w, itemsize)
            assert p.chunk % p.score_tile == 0 and p.splits >= 1
            assert (p.splits - 1) * p.chunk < h * w <= p.splits * p.chunk
            assert p.apply_chunk % p.apply_tile == 0 and p.apply_splits >= 1
            assert (p.apply_splits - 1) * p.apply_chunk < h * w <= p.apply_splits * p.apply_chunk


# ---------------------------------------------------------------------------
# MSSA
# ---------------------------------------------------------------------------


def _jax_layout(model: CIDNet) -> dict:
    return {
        k: np.ascontiguousarray(v.numpy().transpose(2, 3, 1, 0)) if v.dim() == 4 else v.numpy().copy()
        for k, v in model.state_dict().items()
    }


@pytest.fixture(scope="module")
def mssa():
    model = CIDNet(CIDNetConfig(**MSSA), generator=torch.Generator().manual_seed(21))
    return model, _jax_layout(model)


def test_mssa_tiny_forward_matches_jax(mssa):
    model, np_params = mssa
    x = np.random.default_rng(4).uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    cfg = JaxConfig(**MSSA)
    ref = jax.jit(lambda p, x: jax_forward(p, x, cfg, JaxGates()))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x)
    )
    with torch.no_grad():
        got = cidnet_forward(model, torch.from_numpy(x))
    assert got.shape == (2, 16, 24, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("config", ["tiny", "full"])
def test_mssa_state_dict_keys_and_shapes_equal_jax(config):
    kw = MSSA if config == "tiny" else {"variant": "mssa"}
    shapes = jax.eval_shape(lambda: init_cidnet(jax.random.PRNGKey(0), JaxConfig(**kw)))
    ref = {
        k: (s.shape[3], s.shape[2], s.shape[0], s.shape[1]) if len(s.shape) == 4 else s.shape
        for k, s in shapes.items()
    }
    model = CIDNet(CIDNetConfig(**kw))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == ref
    if config == "full":  # base + six 2 -> 1 7x7 gates
        assert model.count_params() == 1_975_569 + 6 * 98


def test_mssa_adds_its_gates_after_the_base_draws():
    """The gates are drawn last, so a seed gives MSSA the base model's weights."""
    base = CIDNet(CIDNetConfig(**TINY), generator=torch.Generator().manual_seed(3)).state_dict()
    ms = CIDNet(CIDNetConfig(**MSSA), generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(v, ms[k]) for k, v in base.items())
    assert sorted(set(ms) - set(base)) == sorted(f"{n}.conv1.weight" for n in
                                                 ("sa_hv3", "sa_i3", "sa_hv2", "sa_i2", "sa_hv1", "sa_i1"))


def test_mssa_strict_load_of_jax_exported_state_dict(mssa, tmp_path):
    model, np_params = mssa
    state = to_torch_state_dict({k: jnp.asarray(v) for k, v in np_params.items()})
    np.savez(tmp_path / "mssa.npz", **state)
    loaded = load_weights(CIDNet(CIDNetConfig(**MSSA)), str(tmp_path / "mssa.npz"))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(KeyError, match="unexpected"):  # an MSSA file into a base model
        load_weights(CIDNet(CIDNetConfig(**TINY)), str(tmp_path / "mssa.npz"))


def test_mssa_enhancer_matches_jax_evaluator(mssa, tmp_path):
    model, np_params = mssa
    gates = dict(gated=True, gated2=True, alpha=0.9, alpha_s=1.2)
    ev = Evaluator({k: jnp.asarray(v) for k, v in np_params.items()}, JaxConfig(**MSSA),
                   JaxGates(**gates), gamma=0.8)
    state = to_torch_state_dict({k: jnp.asarray(v) for k, v in np_params.items()})
    np.savez(tmp_path / "mssa.npz", **state)
    en = Enhancer(str(tmp_path / "mssa.npz"), HVIGates(**gates), config=CIDNetConfig(**MSSA),
                  gamma=0.8, device="cpu")
    assert en.config.variant == "mssa"
    img = np.random.default_rng(5).uniform(0, 1, (19, 26, 3)).astype(np.float32)
    got = en.enhance(img)
    assert got.shape == (19, 26, 3)
    np.testing.assert_allclose(got, ev.enhance(img), atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="serving config"):
        Enhancer(model, config=CIDNetConfig(**TINY), device="cpu")


def test_net_test_cli_mssa_on_cpu(capsys):
    res = net_test.main(["--cpu", "--size", "32", "--iters", "1", "--variant", "mssa"])
    assert res["n_params"] == 1_975_569 + 6 * 98
    assert res["out_shape"] == (1, 32, 32, 3)
