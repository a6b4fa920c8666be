"""The PyTorch port's metrics vs the JAX package's (CPU).

``hvi_cidnet_torch/metrics`` against ``hvi_cidnet_tpu/metrics`` (which
uses cv2 where the port uses numpy and scipy) and against Pillow, on the
same seeded numpy inputs: PSNR, the GT-mean rectification and the resize
bitwise; SSIM within 1e-12; NIQE within 1e-10; the BRISQUE features within
1e-5 relative and a libsvm score within 1e-4; the native BRISQUE backend
where the system's OpenCV quality module is present; LPIPS within 1e-5
relative on the JAX ``init_lpips`` weights carried across.
"""

import filecmp
import warnings
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hvi_cidnet_torch.metrics import brisque, brisque_cv, lpips, niqe, pil_resize, psnr_ssim
from hvi_cidnet_tpu.metrics import brisque as jax_brisque
from hvi_cidnet_tpu.metrics import brisque_cv as jax_brisque_cv
from hvi_cidnet_tpu.metrics import lpips as jax_lpips
from hvi_cidnet_tpu.metrics import niqe as jax_niqe
from hvi_cidnet_tpu.metrics import psnr_ssim as jax_psnr_ssim
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, shape)
    b = np.clip(a + rng.normal(0, 20, shape), 0, 255)
    return a, b


def _natural(hw, seed):
    """Smooth multi-scale RGB uint8 image (natural-like statistics)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((*hw, 3))
    for cell in (8, 32):
        base = rng.uniform(0, 255, (-(-hw[0] // cell), -(-hw[1] // cell), 3))
        img += cv2.resize(base, hw[::-1], interpolation=cv2.INTER_CUBIC)
    return (img / 2 + rng.normal(0, 4, img.shape)).clip(0, 255).astype(np.uint8)


# --- PSNR, SSIM, GT-mean -----------------------------------------------------

@pytest.mark.parametrize("eps_guard", [True, False])
@pytest.mark.parametrize("dtype", ["uint8", "float64"])
def test_psnr_bitwise(eps_guard, dtype):
    a, b = _pair((37, 53, 3), 0)
    a, b = a.astype(dtype), b.astype(dtype)
    assert psnr_ssim.psnr(a, b, eps_guard=eps_guard) == jax_psnr_ssim.psnr(
        a, b, eps_guard=eps_guard)


def test_psnr_identical_images_without_guard_is_inf():
    """The reference's divide by zero on identical images (measure_SID_blur
    has no 1e-8 guard) is kept on purpose: both give inf and warn."""
    a = np.full((8, 8, 3), 17.0)
    for fn in (psnr_ssim.psnr, jax_psnr_ssim.psnr):
        with pytest.warns(RuntimeWarning, match="divide by zero"):
            assert fn(a, a, eps_guard=False) == float("inf")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert np.isfinite(fn(a, a))


@pytest.mark.parametrize("shape", [(64, 80), (61, 77, 3), (45, 33, 1), (400, 600, 3), (11, 12)])
def test_ssim_matches_jax(shape):
    a, b = _pair(shape, 1)
    got, want = psnr_ssim.ssim_matlab(a, b), jax_psnr_ssim.ssim_matlab(a, b)
    assert abs(got - want) <= 1e-12, (got, want)


def test_ssim_rejects_what_jax_rejects():
    for a, b in [(np.zeros((16, 16)), np.zeros((16, 17))), (np.zeros((16, 16, 2)),) * 2]:
        for fn in (psnr_ssim.ssim_matlab, jax_psnr_ssim.ssim_matlab):
            with pytest.raises(ValueError):
                fn(a, b)


def test_gaussian_kernels_match_cv2():
    for k, s in ((11, 1.5), (7, 7 / 6)):
        np.testing.assert_allclose(psnr_ssim.gaussian_kernel(k, s),
                                   cv2.getGaussianKernel(k, s).ravel(), rtol=0, atol=1e-16)


def test_rgb_to_gray_u8_is_cv2s_rule():
    u = np.random.default_rng(2).integers(0, 256, (400, 600, 3)).astype(np.uint8)
    assert np.array_equal(psnr_ssim.rgb_to_gray_u8(u), cv2.cvtColor(u, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("seed", [0, 1])
def test_gt_mean_rectify_bitwise(seed):
    a, b = _pair((33, 47, 3), seed)
    a = a * 0.4  # a darker output, fractional: the uint8 truncation matters
    got = psnr_ssim.gt_mean_rectify(a, b.astype(np.uint8))
    want = jax_psnr_ssim.gt_mean_rectify(a, b.astype(np.uint8))
    assert got.dtype == want.dtype and np.array_equal(got, want)


# --- Pillow's resize -----------------------------------------------------------

RESIZE_CASES = [
    ((400, 600), (600, 400)),    # unchanged: a copy
    ((400, 600), (599, 400)),    # one pixel narrower
    ((400, 600), (601, 400)),    # one pixel wider
    ((400, 600), (600, 399)),    # one pixel shorter
    ((397, 601), (600, 400)),    # both axes, down and up
    ((400, 600), (300, 200)),    # halves
    ((400, 600), (1280, 720)),   # upscale both
    ((64, 30), (7, 9)),          # strong downscale
    ((10, 10), (200, 3)),        # up one axis, down the other
    ((5, 7), (1, 1)),
    ((1, 1), (5, 9)),
    ((13, 17), (17, 13)),
]


@pytest.mark.parametrize("hw,size", RESIZE_CASES)
def test_pil_resize_bitwise(hw, size):
    rng = np.random.default_rng(hw[0] * 1000 + size[0])
    img = rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size))
    got = pil_resize.resize(img, size)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert got is not img


def test_pil_resize_random_sizes_bitwise():
    rng = np.random.default_rng(5)
    for _ in range(30):
        h, w = rng.integers(1, 90, 2)
        size = tuple(int(v) for v in rng.integers(1, 130, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        assert np.array_equal(pil_resize.resize(img, size),
                              np.asarray(Image.fromarray(img).resize(size))), (h, w, size)


def test_pil_resize_rejects_non_uint8():
    with pytest.raises(ValueError, match="uint8"):
        pil_resize.resize(np.zeros((4, 4, 3), np.float32), (2, 2))


# --- NIQE ---------------------------------------------------------------------

def test_niqe_data_is_the_jax_packages():
    ours = REPO / "hvi_cidnet_torch/metrics/data/niqe_pris_params.npz"
    theirs = REPO / "hvi_cidnet_tpu/metrics/data/niqe_pris_params.npz"
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert (ours.parent / "PROVENANCE.md").exists()


@pytest.mark.parametrize("hw", [(96, 128), (400, 600)])
def test_niqe_matches_jax(hw):
    img = _natural(hw, hw[0])
    got, want = niqe.calculate_niqe(img), jax_niqe.calculate_niqe(img)
    assert np.isfinite(got) and abs(got - want) <= 1e-10, (got, want)


def test_niqe_helpers_match_jax():
    x = np.random.default_rng(3).uniform(0, 1, (50, 70, 3))
    for scale in (0.5, 0.37):
        assert np.array_equal(niqe.imresize_matlab(x, scale), jax_niqe.imresize_matlab(x, scale))
    u = _natural((40, 56), 4)
    assert np.array_equal(niqe.rgb_as_bgr_to_y(u), jax_niqe.rgb_as_bgr_to_y(u))
    v = np.random.default_rng(6).normal(0, 1, (30, 30))
    assert niqe.estimate_aggd(v) == jax_niqe.estimate_aggd(v)
    assert niqe.block_features(v) == jax_niqe.block_features(v)


# --- BRISQUE ------------------------------------------------------------------

def test_rgb_to_gray_f32_is_cv2s_vector_form():
    """OpenCV's float RGB2GRAY: bitwise over its vector loop; its scalar
    tail (the last < 32 pixels) may differ by one float32 ulp."""
    x = np.random.default_rng(7).uniform(0, 255, (397, 603, 3)).astype(np.float32)
    got = brisque.rgb_to_gray_f32(x).ravel()
    want = cv2.cvtColor(x, cv2.COLOR_RGB2GRAY).ravel()
    assert np.array_equal(got[:-32], want[:-32])
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


@pytest.mark.parametrize("hw,seed", [((192, 192), 3), ((400, 600), 9), ((61, 77), 2)])
def test_brisque_features_match_jax(hw, seed):
    img = _natural(hw, seed)
    got, want = brisque.brisque_features(img), jax_brisque.brisque_features(img)
    assert got.shape == (36,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # the grey (HW) input path (sqrt of a local variance near 0 magnifies
    # the filters' 1e-13 differences, as in the RGB path)
    g = img[..., 1].astype(np.float64)
    np.testing.assert_allclose(brisque.brisque_features(g), jax_brisque.brisque_features(g),
                               rtol=1e-5, atol=0)


def _write_svr_model(path, gamma, rho, svs):
    """A minimal libsvm epsilon-SVR model file (RBF kernel)."""
    lines = ["svm_type epsilon_svr", "kernel_type rbf", f"gamma {gamma}", "nr_class 2",
             f"total_sv {len(svs)}", f"rho {rho}", "SV"]
    for coef, vec in svs:
        lines.append(f"{coef} " + " ".join(f"{i + 1}:{v}" for i, v in enumerate(vec)))
    path.write_text("\n".join(lines) + "\n")


def test_brisque_libsvm_roundtrip_matches_jax(tmp_path):
    """Model + LIVE ``allrange``-style scale file: the port's score equals a
    hand computation and the JAX package's score."""
    img = _natural((192, 192), 4)
    feats = brisque.brisque_features(img)
    rng = np.random.default_rng(0)
    lo, hi = feats - rng.uniform(0.5, 2.0, 36), feats + rng.uniform(0.5, 2.0, 36)
    scaled = -1 + 2 * (feats - lo) / (hi - lo)
    gamma, rho = 0.05, -0.25
    svs = [(1.3, rng.normal(0, 0.3, 36)), (-0.7, rng.normal(0, 0.3, 36)),
           (0.4, rng.normal(0, 0.3, 36))]
    want = -rho + sum(c * np.exp(-gamma * np.dot(scaled - v, scaled - v)) for c, v in svs)
    model_path = tmp_path / "brisque_svm.txt"
    _write_svr_model(model_path, gamma, rho, svs)
    (tmp_path / "brisque_svm_scale.txt").write_text(
        "".join(f"{i + 1} {lo[i]} {hi[i]}\n" for i in range(36)))
    model = brisque.LibSVMModel(str(model_path))
    assert model.scale_lo is not None
    np.testing.assert_allclose(model.scale(feats), scaled, atol=1e-9)
    got = brisque.score(img, model_path=str(model_path))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs(got - jax_brisque.score(img, model_path=str(model_path))) <= 1e-4


def test_brisque_scale_restore_format_and_env(tmp_path, monkeypatch):
    """svm-scale restore files ('x' header + 'lower upper' line), and the
    BRISQUE_MODEL / BRISQUE_RANGE variables, as the JAX reader takes them."""
    model_path = tmp_path / "m.txt"
    _write_svr_model(model_path, 0.1, 0.0, [(1.0, np.zeros(3))])
    (tmp_path / "m_scale.txt").write_text("x\n0 1\n1 -2 2\n2 0 4\n3 -1 3\n")
    model = brisque.LibSVMModel(str(model_path))
    assert model.lower == 0.0 and model.upper == 1.0
    np.testing.assert_allclose(model.scale(np.array([0.0, 2.0, 3.0])), [0.5, 0.5, 1.0],
                               atol=1e-12)
    x = np.array([0.3, 0.1, -0.2])
    assert model.predict(x) == jax_brisque.LibSVMModel(str(model_path)).predict(x)
    monkeypatch.setenv("BRISQUE_MODEL", str(model_path))
    assert brisque._default_model_path() == jax_brisque._default_model_path() == str(model_path)
    rng_file = tmp_path / "elsewhere.range"
    rng_file.write_text("1 0 1\n")
    monkeypatch.setenv("BRISQUE_RANGE", str(rng_file))
    assert brisque._find_scale_file(str(model_path)) == str(rng_file)


def test_brisque_without_any_model_raises(monkeypatch):
    """No libsvm file and no native backend: FileNotFoundError, as the JAX
    ``score`` (the harness reports n/a)."""
    monkeypatch.delenv("BRISQUE_MODEL", raising=False)
    monkeypatch.setattr(brisque_cv, "MODEL_PATH", "/nonexistent/brisque_model_live.yml")
    assert not brisque_cv.available()
    assert "absent" in brisque_cv.reason()
    with pytest.raises(FileNotFoundError, match="BRISQUE needs a trained model"):
        brisque.score(_natural((64, 64), 1))


def test_brisque_cv_builds_outside_the_package():
    path = brisque_cv.shim_path()
    assert path.parent == REPO / "build" / "brisque"
    assert not list((REPO / "hvi_cidnet_torch").rglob("*.so"))


needs_native = pytest.mark.skipif(not jax_brisque_cv.available(),
                                  reason="system OpenCV quality module absent")


@needs_native
def test_brisque_native_matches_jax():
    img = _natural((256, 256), 1)
    assert brisque_cv.available(), brisque_cv.reason()
    assert brisque_cv.score(img) == jax_brisque_cv.score(img)
    assert np.array_equal(brisque_cv.features(img), jax_brisque_cv.features(img))
    # with no libsvm file, score() dispatches to the native backend
    assert brisque.score(img) == jax_brisque.score(img) == brisque_cv.score(img)
    # OpenCV's own features against the numpy ones (a looser, independent check)
    np.testing.assert_allclose(brisque.brisque_features(img)[:2],
                               brisque_cv.features(img)[:2], rtol=5e-2)


# --- LPIPS --------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return {k: np.asarray(v) for k, v in jax_lpips.init_lpips(jax.random.PRNGKey(0)).items()}


def _lpips_pair(n, hw, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (n, *hw, 3)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-40, 40, a.shape), 0, 255).astype(np.uint8)
    return a, b


def _nchw(x_u8):
    return torch.from_numpy((x_u8.astype(np.float32) / 127.5 - 1.0).transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("n,hw", [(2, (64, 96)), (1, (75, 101))])
def test_lpips_matches_jax(jax_params, n, hw):
    model = lpips.LPIPS()
    model.load_state_dict(lpips.lpips_params_from_jax(jax_params))
    a, b = _lpips_pair(n, hw, 1)
    got = lpips.lpips_distance(model, _nchw(a), _nchw(b))
    want = np.asarray(jax_lpips.lpips_distance(jax_params, a / 127.5 - 1.0, b / 127.5 - 1.0))
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_im2tensor_range_matches_jax():
    a, _ = _lpips_pair(1, (9, 13), 2)
    got = lpips.im2tensor_range(a[0])
    assert got.shape == (1, 3, 9, 13) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), jax_lpips.im2tensor_range(a[0]).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("lin_form", ["lin{i}.model.1.weight", "lin{i}.weight"])
def test_load_lpips_torch_key_forms(tmp_path, jax_params, lin_form):
    """A combined torchvision-alexnet + lpips state dict loads into the
    port and into the JAX package alike, and both score the same."""
    state = lpips.lpips_params_from_jax(jax_params)
    state = {(lin_form.format(i=k[3]) if k.startswith("lin") else k): v for k, v in state.items()}
    path = tmp_path / "alex_lpips.pth"
    torch.save(state, path)
    model = lpips.load_lpips_torch(str(path))
    back = jax_lpips.load_lpips_torch(str(path))
    a, b = _lpips_pair(1, (64, 64), 3)
    got = lpips.lpips_distance(model, _nchw(a), _nchw(b)).numpy()
    want = np.asarray(jax_lpips.lpips_distance(back, a / 127.5 - 1.0, b / 127.5 - 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_load_lpips_is_strict(jax_params):
    state = lpips.lpips_params_from_jax(jax_params)
    with pytest.raises(KeyError, match="lin3"):
        lpips.load_lpips_state({k: v for k, v in state.items() if k != "lin3.weight"})
    with pytest.raises(KeyError, match="features.6.bias"):
        lpips.load_lpips_state({k: v for k, v in state.items() if k != "features.6.bias"})
    with pytest.raises(KeyError, match="unexpected"):
        lpips.load_lpips_state({**state, "classifier.1.weight": torch.zeros(2)})


def test_init_lpips_is_seeded_and_finite():
    a, b = _lpips_pair(1, (64, 64), 4)
    d1 = lpips.lpips_distance(lpips.init_lpips(torch.Generator().manual_seed(0)), _nchw(a),
                              _nchw(b))
    d2 = lpips.lpips_distance(lpips.init_lpips(torch.Generator().manual_seed(0)), _nchw(a),
                              _nchw(b))
    assert torch.equal(d1, d2) and torch.isfinite(d1).all() and d1.item() > 0


def test_no_tf32_restores_the_global_flags():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            torch.backends.cuda.matmul.allow_tf32 = flag
            with lpips.no_tf32():
                assert not torch.backends.cudnn.allow_tf32
                assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32 is flag
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
