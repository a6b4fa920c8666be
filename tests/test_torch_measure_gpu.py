"""The port's scoring on the card: LPIPS on the GPU against the port on the
CPU, the TF32 scope, and the paired harness with LPIPS on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is False. No JAX, so on a machine without
jax it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_measure_gpu.py -q

LPIPS on the card runs fp32 with TF32 off (``lpips.no_tf32``) and must
agree with the CPU within 1e-5 relative, also when TF32 is allowed
globally before the call; the global flags are restored after it.
"""

import numpy as np
import pytest
import torch

from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.eval import measure
from hvi_cidnet_torch.metrics import lpips

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _pair(n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((n, 3, h, w), generator=g) * 2 - 1
    b = (a + 0.3 * torch.randn((n, 3, h, w), generator=g)).clamp(-1, 1)
    return a, b


@pytest.mark.parametrize("n,h,w", [(1, 400, 600), (3, 67, 93)])
@pytest.mark.parametrize("tf32", [False, True])
def test_lpips_card_matches_cpu(cuda, n, h, w, tf32):
    model = lpips.init_lpips(torch.Generator().manual_seed(0))
    a, b = _pair(n, h, w, 1)
    want = lpips.lpips_distance(model, a, b)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        got = lpips.lpips_distance(model.to(cuda), a.to(cuda), b.to(cuda))
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert got.device.type == "cuda" and got.shape == (n,)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)


def test_metrics_lpips_on_the_card(cuda, tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "out").mkdir()
    (tmp_path / "gt").mkdir()
    for i, (h, w) in enumerate([(40, 56), (40, 55)]):
        gt = rng.integers(0, 256, (h, 56, 3)).astype(np.uint8)
        png.write(str(tmp_path / "gt" / f"{i}.png"), gt)
        png.write(str(tmp_path / "out" / f"{i}.png"), (gt[:, :w] * 0.7).astype(np.uint8))
    model = lpips.init_lpips(torch.Generator().manual_seed(0))
    args = (str(tmp_path / "out" / "*.png"), str(tmp_path / "gt"), True)
    got = measure.metrics(*args, lpips=model, device=cuda, verbose=False)
    want = measure.metrics(*args, lpips=model.cpu(), device="cpu", verbose=False)
    assert got[:2] == want[:2]
    assert abs(got[2] - want[2]) <= 1e-5 * want[2]
