"""Base CIDNet of the PyTorch port vs the JAX package (CPU, fp32).

The whole tiny forward (8, 8, 16, 32) is held to the JAX package's own bar
against torch, 2e-5 (docs/DESIGN.md, "Numerics policy"). Parameters are
drawn once on the port side and handed to JAX in its HWIO layout (a JAX
init runs op by op here and costs tens of seconds); the JAX side of the
key/shape contract comes from ``jax.eval_shape(init_cidnet)``.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hvi_cidnet_tpu.compat.torch_ckpt import to_torch_state_dict
from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import HVIGates as JaxGates
from hvi_cidnet_tpu.models.cidnet import cidnet_forward as jax_forward
from hvi_cidnet_tpu.models.cidnet import init_cidnet
from hvi_cidnet_torch.compat.jax_params import jax_params_to_torch, load_weights
from hvi_cidnet_torch.models.cidnet import (
    CIDNet,
    CIDNetConfig,
    HVIGates,
    cast_conv_weights,
    cidnet_forward,
)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_layout(model: CIDNet) -> dict:
    """The port's parameters as a JAX parameter dict (HWIO convs)."""
    return {
        k: np.ascontiguousarray(v.numpy().transpose(2, 3, 1, 0)) if v.dim() == 4 else v.numpy().copy()
        for k, v in model.state_dict().items()
    }


@pytest.fixture(scope="module")
def tiny():
    model = CIDNet(CIDNetConfig(**TINY), generator=torch.Generator().manual_seed(11))
    return model, _jax_layout(model)


@pytest.mark.parametrize(
    "gates",
    [{}, {"gated2": True, "alpha": 0.84}, {"gated": True, "alpha_s": 1.3}],
    ids=["default", "gated2", "gated"],
)
def test_tiny_forward_matches_jax(tiny, gates):
    model, np_params = tiny
    # the JAX parameters reach the port through the bridge under test
    port = load_weights(CIDNet(CIDNetConfig(**TINY)), jax_params_to_torch(np_params))
    x = np.random.default_rng(0).uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    cfg = JaxConfig(**TINY)
    jg = JaxGates(**gates)
    ref = jax.jit(lambda p, x: jax_forward(p, x, cfg, jg))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x)
    )
    with torch.no_grad():
        got = cidnet_forward(port, torch.from_numpy(x), HVIGates(**gates))
    assert got.shape == (2, 16, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_full_width_param_count():
    assert CIDNet(CIDNetConfig()).count_params() == 1_975_569


@pytest.mark.parametrize("config", ["tiny", "full"])
def test_state_dict_keys_and_shapes_equal_jax(config):
    kw = TINY if config == "tiny" else {}
    shapes = jax.eval_shape(lambda: init_cidnet(jax.random.PRNGKey(0), JaxConfig(**kw)))
    ref = {
        k: (s.shape[3], s.shape[2], s.shape[0], s.shape[1]) if len(s.shape) == 4 else s.shape
        for k, s in shapes.items()
    }
    got = {k: tuple(v.shape) for k, v in CIDNet(CIDNetConfig(**kw)).state_dict().items()}
    assert got == ref


def test_strict_load_of_jax_exported_state_dict(tiny, tmp_path):
    """JAX ``to_torch_state_dict`` -> .npz / .pth -> strict port load."""
    model, np_params = tiny
    state = to_torch_state_dict({k: jnp.asarray(v) for k, v in np_params.items()})
    np.savez(tmp_path / "w.npz", **state)
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in state.items()}},
               tmp_path / "w.pth")
    for name in ("w.npz", "w.pth"):
        loaded = load_weights(CIDNet(CIDNetConfig(**TINY)), str(tmp_path / name))
        for k, v in model.state_dict().items():
            torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)


def test_strict_load_rejects_missing_and_misshapen(tiny):
    model, _ = tiny
    state = dict(model.state_dict())
    state.pop("trans.density_k")
    with pytest.raises(KeyError, match="strict load failed"):
        load_weights(CIDNet(CIDNetConfig(**TINY)), state)
    state["trans.density_k"] = torch.zeros(2)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_weights(CIDNet(CIDNetConfig(**TINY)), state)
    state["trans.density_k"] = torch.zeros(1)
    state["extra.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="unexpected"):
        load_weights(CIDNet(CIDNetConfig(**TINY)), state)


def test_x8_error_matches_jax(tiny):
    model, np_params = tiny
    x = np.zeros((1, 12, 16, 3), np.float32)
    with pytest.raises(ValueError, match="multiples of 8") as port_err:
        cidnet_forward(model, torch.from_numpy(x))
    with pytest.raises(ValueError) as jax_err:
        jax_forward({k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x),
                    JaxConfig(**TINY))
    assert str(port_err.value) == str(jax_err.value)


def test_only_conv_weights_take_the_compute_dtype():
    model = cast_conv_weights(CIDNet(CIDNetConfig(**TINY)), torch.bfloat16)
    for k, v in model.state_dict().items():
        assert v.dtype == (torch.bfloat16 if v.dim() == 4 else torch.float32), k
    # density_k stays exactly the fp32 0.2 (a bf16 cast would make it 0.2002)
    assert model.trans.density_k.item() == np.float32(0.2)


def test_bf16_forward_runs_on_cpu(tiny):
    model, _ = tiny
    m = cast_conv_weights(CIDNet(CIDNetConfig(**TINY)), torch.bfloat16)
    m.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        out = cidnet_forward(m, x.to(torch.bfloat16), compute_dtype=torch.bfloat16)
        ref = cidnet_forward(model, x)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert (out.float() - ref).abs().mean().item() < 2e-2


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="'foo' is not one of base, mssa, tnsm"):
        CIDNet(CIDNetConfig(variant="foo"))


def test_entry_twin_shapes():
    from hvi_cidnet_torch.entry import entry

    fn, (model, x) = entry("cpu")
    assert x.shape == (4, 256, 256, 3) and x.dtype == torch.bfloat16
    assert model.count_params() == 1_975_569
    assert model.HV_LCA1.ffn.q.weight.dtype == torch.bfloat16
    assert model.trans.density_k.dtype == torch.float32
    assert callable(fn)


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package (whose __init__ pulls in jax and optax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hvi_cidnet_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib', "
        "'hvi_cidnet_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules if n.startswith('hvi_cidnet_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
