"""Serving through the PyTorch port: ``Enhancer`` vs the JAX ``Evaluator``,
and the port's CLIs, on the CPU.

``Enhancer.enhance`` pads an odd-sized image to x8 (reflect), applies gamma,
runs the forward with both gates on, clips and crops, as
``Evaluator.enhance`` does. Tolerance 2e-5 (fp32), the whole-forward bar.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from hvi_cidnet_tpu.eval.evaluator import Evaluator
from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import HVIGates as JaxGates
from hvi_cidnet_torch.cli import demo, net_test
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates
from hvi_cidnet_torch.serve import Enhancer

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
GATES = dict(gated=True, gated2=True, alpha=0.9, alpha_s=1.2)


@pytest.fixture(scope="module")
def pair():
    model = CIDNet(CIDNetConfig(**TINY), generator=torch.Generator().manual_seed(5))
    params = {
        k: jnp.asarray(v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4 else v.numpy())
        for k, v in model.state_dict().items()
    }
    ev = Evaluator(params, JaxConfig(**TINY), JaxGates(**GATES), gamma=0.8)
    en = Enhancer(model, HVIGates(**GATES), gamma=0.8, device="cpu")
    return ev, en


def test_enhance_matches_jax_evaluator(pair):
    ev, en = pair
    img = np.random.default_rng(0).uniform(0, 1, (21, 27, 3)).astype(np.float32)
    ref = ev.enhance(img)
    got = en.enhance(img)
    assert got.shape == (21, 27, 3) and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_enhance_batch_matches_jax_evaluator(pair):
    ev, en = pair
    imgs = np.random.default_rng(1).uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(en.enhance_batch(imgs), ev.enhance_batch(imgs), atol=2e-5, rtol=0)


def test_sliver_image_pads_with_edge(pair):
    """numpy 'reflect' needs pad < dim: a 3-px strip pads with 'edge', as in
    the JAX evaluator."""
    ev, en = pair
    img = np.random.default_rng(2).uniform(0, 1, (3, 17, 3)).astype(np.float32)
    np.testing.assert_allclose(en.enhance(img), ev.enhance(img), atol=2e-5, rtol=0)


def test_net_test_cli_on_cpu(capsys):
    res = net_test.main(["--cpu", "--size", "32", "--iters", "1"])
    out = capsys.readouterr().out
    assert res["n_params"] == 1_975_569 and "n_paras: 1.884M" in out
    assert res["out_shape"] == (1, 32, 32, 3) and res["device"] == "cpu"
    assert res["flops"] > 0


def test_demo_cli_random_init_on_cpu(tmp_path):
    src = tmp_path / "low.png"
    rgb = (np.random.default_rng(3).uniform(0, 0.3, (13, 21, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(src)
    out = demo.main(["--input", str(src), "--output_dir", str(tmp_path / "out"),
                     "--random_init", "--cpu", "--gamma", "0.9"])
    with Image.open(out) as im:
        assert im.size == (21, 13) and im.mode == "RGB"
