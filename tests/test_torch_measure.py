"""The PyTorch port's measure harness, its CLIs and the parity harness vs the
JAX package's (CPU).

``hvi_cidnet_torch/eval/measure.py`` (``metrics``, ``unpaired_metrics``),
``cli/measure.py``, ``cli/measure_SID_blur.py``, ``cli/measure_niqe_bris.py``
and ``cli/parity.py`` against their JAX counterparts on the same folders:
PSNR bitwise, SSIM within 1e-12, LPIPS within 1e-5 relative (the JAX
``init_lpips`` weights carried across), NIQE within 1e-10, BRISQUE equal
(both the system OpenCV backend) or n/a in both; the printed lines equal;
``CASES`` equal to the JAX table; ``parity --dry_run`` and one
``run_case`` beside the JAX one (its Pallas kernels in interpret mode). The
harness runs with cv2 and PIL made unimportable, and ``read_rgb`` is
PIL's ``convert("RGB")`` on PNGs of every colour type.
"""

import contextlib
import dataclasses
import io
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cli import parity as jax_parity
from hvi_cidnet_torch.cli import measure as measure_cli
from hvi_cidnet_torch.cli import measure_niqe_bris, measure_SID_blur, parity
from hvi_cidnet_torch.compat.checkpoint import export_pth
from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.data.datasets import load_image, read_rgb
from hvi_cidnet_torch.eval import measure
from hvi_cidnet_torch.metrics import brisque_cv
from hvi_cidnet_torch.metrics import lpips as lpips_mod
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
from hvi_cidnet_tpu.eval import measure as jax_measure
from hvi_cidnet_tpu.metrics import lpips as jax_lpips
from _torch_port import one_torch_thread, run_jax_cli  # noqa: F401 (autouse)


def _img(rng, h, w, lo=0, hi=255):
    return rng.integers(lo, hi + 1, (h, w, 3)).astype(np.uint8)


def _smooth(rng, h, w):
    """Natural-like statistics for NIQE / BRISQUE: noise over a gradient."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = 60 + 120 * (yy[..., None] * rng.uniform(0, 1, 3) + xx[..., None] * rng.uniform(0, 1, 3))
    return np.clip(img + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """out/*.png against label/: same-name GT, a ``.jpg`` GT (extension
    fallback), a GT one pixel wider (the resize), a missing GT; an
    unpaired folder of PNGs and a JPEG."""
    root = tmp_path_factory.mktemp("measure")
    rng = np.random.default_rng(0)
    (root / "out").mkdir()
    (root / "label").mkdir()
    (root / "unpaired").mkdir()
    for name, (h, w), gt_name, gt_w in [("00.png", (40, 56), "00.png", 56),
                                        ("01.png", (40, 56), "01.jpg", 56),
                                        ("02.png", (40, 55), "02.png", 56),
                                        ("03.png", (24, 32), None, 32)]:
        gt = _img(rng, h, gt_w)
        out = np.clip(gt[:, :w].astype(np.int32) * 0.6 + rng.normal(0, 9, (h, w, 3)),
                      0, 255).astype(np.uint8)
        png.write(str(root / "out" / name), out)
        if gt_name is not None:
            Image.fromarray(gt).save(root / "label" / gt_name)
    for i in range(2):
        png.write(str(root / "unpaired" / f"{i}.png"), _smooth(rng, 96, 128))
    Image.fromarray(_smooth(rng, 96, 128)).save(root / "unpaired" / "2.jpg", quality=95)
    jax_params = {k: np.asarray(v) for k, v in jax_lpips.init_lpips(jax.random.PRNGKey(0)).items()}
    torch.save(lpips_mod.lpips_params_from_jax(jax_params), root / "alex_lpips.pth")
    return root, jax_params


def _port_lpips(tree_root):
    return lpips_mod.load_lpips_torch(str(tree_root / "alex_lpips.pth"))


@pytest.mark.parametrize("gt_mean", [False, True])
def test_metrics_matches_jax(tree, gt_mean, capsys):
    root, jax_params = tree
    args = (str(root / "out" / "*.png"), str(root / "label"), gt_mean)
    got = measure.metrics(*args, lpips=_port_lpips(root), device="cpu")
    got_text = capsys.readouterr().out
    want = jax_measure.metrics(*args, lpips_params=jax_params)
    want_text = capsys.readouterr().out
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= 1e-12
    assert abs(got[2] - want[2]) <= 1e-5 * abs(want[2])
    assert got_text == want_text and "no ground truth for 03.png" in got_text


def test_metrics_without_lpips_is_nan_and_empty_glob(tree, tmp_path):
    root, _ = tree
    got = measure.metrics(str(root / "out" / "*.png"), str(root / "label"), verbose=False)
    want = jax_measure.metrics(str(root / "out" / "*.png"), str(root / "label"), verbose=False)
    assert got[:2] == (want[0], pytest.approx(want[1], abs=1e-12)) and np.isnan(got[2])
    assert all(np.isnan(v) for v in measure.metrics(str(tmp_path / "*.png"), str(tmp_path),
                                                    verbose=False))
    assert measure.fmt_metric(float("nan")) == "n/a" == jax_measure.fmt_metric(float("nan"))
    assert measure.fmt_metric(0.12345) == jax_measure.fmt_metric(0.12345)


def test_unpaired_metrics_matches_jax(tree, capsys):
    root, _ = tree
    for pattern in ("*.png", "*.jpg", "*"):
        got = measure.unpaired_metrics(str(root / "unpaired" / pattern))
        got_text = capsys.readouterr().out
        want = jax_measure.unpaired_metrics(str(root / "unpaired" / pattern))
        assert got_text == capsys.readouterr().out
        assert np.isfinite(got[0]) and abs(got[0] - want[0]) <= 1e-10, pattern
        if brisque_cv.available():
            assert got[1] == want[1], pattern
        else:
            assert np.isnan(got[1]) and np.isnan(want[1])
    assert all(np.isnan(v) for v in measure.unpaired_metrics(str(root / "none" / "*.png")))


def test_unpaired_metrics_without_a_brisque_model_reports_nan_and_why(tree, monkeypatch, capsys):
    root, _ = tree
    monkeypatch.delenv("BRISQUE_MODEL", raising=False)
    monkeypatch.setattr(brisque_cv, "MODEL_PATH", "/nonexistent/brisque_model_live.yml")
    niqe, bris = measure.unpaired_metrics(str(root / "unpaired" / "*.png"))
    assert np.isfinite(niqe) and np.isnan(bris)
    assert "BRISQUE skipped: BRISQUE needs a trained model" in capsys.readouterr().out


@contextlib.contextmanager
def _without(*names):
    """Importing any of ``names`` (or their submodules) raises ImportError."""
    saved = {n: m for n, m in sys.modules.items() if n.split(".")[0] in names}
    for n in saved:
        del sys.modules[n]
    sys.modules.update({n: None for n in names})
    try:
        yield
    finally:
        for n in names:
            del sys.modules[n]
        sys.modules.update(saved)


def test_metrics_needs_neither_cv2_nor_pil(tree, tmp_path):
    """The card's path: PNGs only, cv2 and PIL blocked. The same numbers as
    with them importable; a JPEG GT raises an ImportError naming it."""
    root, _ = tree
    label = tmp_path / "label"
    label.mkdir()
    for name in ("00.png", "02.png"):
        (label / name).write_bytes((root / "label" / name).read_bytes())
    args = (str(root / "out" / "*.png"), str(label), True)
    want = measure.metrics(*args, lpips=_port_lpips(root), device="cpu", verbose=False)
    with _without("cv2", "PIL"):
        got = measure.metrics(*args, lpips=_port_lpips(root), device="cpu", verbose=False)
        niqe, _ = measure.unpaired_metrics(str(root / "unpaired" / "*.png"), verbose=False)
        with pytest.raises(ImportError, match="01.jpg"):
            measure.metrics(str(root / "out" / "01.png"), str(root / "label"))
        with pytest.raises(ImportError, match="2.jpg"):
            measure_niqe_bris.main(["--im_dir", str(root / "unpaired" / "*.jpg")])
    assert got == want and np.isfinite(niqe)


# PNG colour types (PIL mode, with a tRNS chunk or not) read_rgb must read
# as PIL's convert("RGB") does
PNG_KINDS = ["L", "LA", "RGB", "RGBA", "P", "L_trns", "RGB_trns", "P_trns"]


@pytest.mark.parametrize("kind", PNG_KINDS)
def test_read_rgb_is_pil_convert_rgb(kind, tmp_path):
    rng = np.random.default_rng(PNG_KINDS.index(kind))
    mode = kind.split("_")[0]
    rgba = _img(rng, 13, 17)
    if mode in ("L", "LA"):
        im = Image.fromarray(rgba[..., 0]).convert(mode)
    elif mode == "P":
        im = Image.fromarray(rgba).quantize(37)
    else:
        im = Image.fromarray(rgba).convert(mode)
    if mode in ("LA", "RGBA"):
        im.putalpha(Image.fromarray(_img(rng, 13, 17)[..., 0]))
    path = tmp_path / "x.png"
    if kind.endswith("_trns"):
        im.info["transparency"] = {"L": 7, "RGB": (1, 2, 3), "P": 5}[mode]
        im.save(path, transparency=im.info["transparency"])
    else:
        im.save(path)
    with Image.open(path) as ref:
        assert ref.mode == mode
        want = np.asarray(ref.convert("RGB"))
    assert np.array_equal(read_rgb(str(path)), want)
    assert np.array_equal(load_image(str(path)), want)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


def _run_jax(script, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_jax_cli(script, argv)
    return buf.getvalue()


@pytest.mark.parametrize("gt_mean", [False, True])
def test_measure_cli_prints_what_jax_prints(tree, gt_mean):
    root, _ = tree
    argv = ["--im_dir", str(root / "out" / "*.png"), "--label_dir", str(root / "label"),
            "--lpips_weights", str(root / "alex_lpips.pth")] + (["--use_GT_mean"] * gt_mean)
    (p, s, lp), text = _run(measure_cli.main, argv + ["--cpu"])
    assert text == _run_jax("measure.py", argv)
    want = jax_measure.metrics(argv[1], argv[3], gt_mean, lpips_params=tree[1], verbose=False)
    assert p == want[0] and abs(s - want[1]) <= 1e-12 and abs(lp - want[2]) <= 1e-5 * want[2]


def test_measure_cli_routes_and_lpips_note(tree, monkeypatch):
    root, _ = tree
    port = {a.dest for a in measure_cli.parser()._actions} - {"cpu"}
    assert port == {"help", "use_GT_mean", "im_dir", "label_dir", "lpips_weights",
                    *measure_cli.ROUTES}
    monkeypatch.chdir(root)
    # --lol's route reads ./output/LOLv1/*.png against ./datasets/LOLdataset/eval15/high/
    os.makedirs("output/LOLv1", exist_ok=True)
    os.makedirs("datasets/LOLdataset/eval15/high", exist_ok=True)
    for name in ("00.png", "02.png"):
        (root / "output/LOLv1" / name).write_bytes((root / "out" / name).read_bytes())
        (root / "datasets/LOLdataset/eval15/high" / name).write_bytes(
            (root / "label" / name).read_bytes())
    _, text = _run(measure_cli.main, ["--lol", "--cpu"])
    assert text == _run_jax("measure.py", ["--lol"])
    assert measure_cli.LPIPS_NOTE in text and "===> Avg.LPIPS: n/a" in text
    with pytest.raises(SystemExit, match="choose a dataset flag"):
        measure_cli.main([])


def test_measure_sid_blur_cli_prints_what_jax_prints(tree, tmp_path):
    """Two scenes; one GT found by its stem (another extension), one output
    a pixel narrower than its GT (resized), one output without a GT."""
    root, _ = tree
    rng = np.random.default_rng(3)
    for scene in ("10001", "10002"):
        for d in ("out", "gt"):
            (tmp_path / d / scene).mkdir(parents=True)
        for i, w in enumerate((48, 47)):
            gt = _img(rng, 32, 48)
            out = np.clip(gt[:, :w] * 0.7 + rng.normal(0, 6, (32, w, 3)), 0, 255).astype(np.uint8)
            png.write(str(tmp_path / "out" / scene / f"{i}.png"), out)
            ext = ".jpg" if (scene, i) == ("10002", 0) else ".png"
            Image.fromarray(gt).save(tmp_path / "gt" / scene / f"{i}{ext}")
        png.write(str(tmp_path / "out" / scene / "orphan.png"), _img(rng, 8, 8))
    for extra in ([], ["--use_GT_mean"]):
        argv = ["--SID", "--out_root", str(tmp_path / "out"), "--gt_root", str(tmp_path / "gt"),
                "--lpips_weights", str(root / "alex_lpips.pth"), *extra]
        avg, text = _run(measure_SID_blur.main, argv + ["--cpu"])
        assert text == _run_jax("measure_SID_blur.py", argv) and np.isfinite(avg).all()
    with pytest.raises(SystemExit, match="pass --SID or --Blur"):
        measure_SID_blur.main([])


def test_measure_niqe_bris_cli_prints_what_jax_prints(tree):
    root, _ = tree
    argv = ["--im_dir", str(root / "unpaired" / "*.png")]
    (niqe, bris), text = _run(measure_niqe_bris.main, argv)
    want = _run_jax("measure_niqe_bris.py", argv).splitlines()
    lines = text.splitlines()
    assert abs(float(lines[-2]) - float(want[-2])) <= 1e-10 and lines[-1] == want[-1]
    assert lines[:-2] == want[:-2] and float(lines[-2]) == niqe
    # the five routes and their extensions
    for name, ext in [("DICM", "jpg"), ("LIME", "bmp"), ("MEF", "png"), ("NPE", "jpg"),
                      ("VV", "jpg")]:
        assert measure_niqe_bris.ROUTES[name] == f"./output/{name}/*.{ext}"
    with pytest.raises(SystemExit, match="choose --DICM"):
        measure_niqe_bris.main([])


# --- the parity harness --------------------------------------------------------

def test_parity_cases_equal_the_jax_table():
    assert [dataclasses.asdict(c) for c in parity.CASES] == [
        dataclasses.asdict(c) for c in jax_parity.CASES]
    assert (parity.PSNR_TOL, parity.SSIM_TOL, parity.LPIPS_TOL) == (
        jax_parity.PSNR_TOL, jax_parity.SSIM_TOL, jax_parity.LPIPS_TOL)


def test_parity_report_and_skips_like_jax(tmp_path, monkeypatch):
    rows = [{"case": "LOLv1 wo_perc", "gt_mean": g, "psnr": 23.51 + g, "e_psnr": 23.5 + g,
             "d_psnr": 0.01, "ssim": 0.87, "e_ssim": 0.8703, "lpips": lp, "e_lpips": 0.1053,
             "pass": g} for g, lp in ((False, float("nan")), (True, 0.1))]
    skipped = [("SICE-Mix", "missing x")]
    assert parity.render_report(rows, skipped) == jax_parity.render_report(rows, skipped)
    monkeypatch.chdir(tmp_path)
    argv = ["--weights_root", "nowhere", "--datasets_root", "nothing", "--report", "port.md"]
    code, text = _run(parity.main, argv + ["--cpu"])
    monkeypatch.setattr(sys, "argv", ["parity.py", *argv[:-1], "jax.md"])
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_parity.main() == code == 2
    assert (tmp_path / "port.md").read_text() == (tmp_path / "jax.md").read_text()
    assert "9 case(s) skipped" in text


def test_parity_dry_run_on_the_cpu():
    code, text = _run(parity.main, ["--dry_run", "--cpu"])
    assert code == 0 and "dry run OK" in text


@pytest.fixture(scope="module")
def parity_layout(tmp_path_factory):
    """A 2-image LOLv1 layout (48 x 64 PNGs) and base weights as ``.pth``."""
    root = tmp_path_factory.mktemp("parity")
    case = next(c for c in parity.CASES if c.name == "LOLv1 wo_perc")
    wpath = root / "weights" / case.weights_rel
    export_pth(str(wpath), CIDNet(CIDNetConfig(),
                                  generator=torch.Generator().manual_seed(0)).state_dict())
    low, high = root / "datasets" / case.eval_dir_rel, root / "datasets" / case.label_dir_rel
    low.mkdir(parents=True)
    high.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        lo = (rng.uniform(0, 0.3, (48, 64, 3)) * 255).astype(np.uint8)
        png.write(str(low / f"{i}.png"), lo)
        png.write(str(high / f"{i}.png"), np.clip(lo.astype(np.int32) * 3, 0, 255).astype(np.uint8))
    return case, str(wpath), str(low), str(high), root


def test_parity_run_case_matches_jax(parity_layout, monkeypatch):
    """The port's run_case writes what the JAX one writes (within one uint8
    level: the forwards agree within 2e-5) and scores its own PNGs exactly
    as ``metrics`` does; the rows agree with the JAX rows."""
    case, wpath, low, high, root = parity_layout
    rows = parity.run_case(case, wpath, low, high, str(root / "port"), device="cpu")
    with monkeypatch.context() as mp:
        mp.setenv("PALLAS_FORCE_INTERPRET", "1")
        want = jax_parity.run_case(case, wpath, low, high, str(root / "jax"))
    for name in ("0.png", "1.png"):
        got = png.read(str(root / "port" / name)).astype(np.int16)
        ref = np.asarray(Image.open(root / "jax" / name).convert("RGB"))
        assert got.shape == ref.shape and np.abs(got - ref).max() <= 1
    assert [r["gt_mean"] for r in rows] == [r["gt_mean"] for r in want] == [False, True]
    for r, w in zip(rows, want):
        p, s, lp = measure.metrics(str(root / "port" / "*.png"), high, r["gt_mean"],
                                   verbose=False)
        assert (r["psnr"], r["ssim"]) == (p, s) and np.isnan(r["lpips"]) and np.isnan(lp)
        assert r["images"] == w["images"] == 2 and not r["pass"] and not w["pass"]
        assert abs(r["psnr"] - w["psnr"]) <= 0.05 and abs(r["ssim"] - w["ssim"]) <= 1e-3


def test_parity_gate_check_rejects_a_dead_gate(parity_layout):
    """With a tolerance wider than the 1 dB perturbation the perturbed rows
    pass, and ``gate_check`` (``--dry_run``'s proof) must refuse."""
    case, wpath, low, high, root = parity_layout
    with pytest.raises(AssertionError, match="perturbed by 1 dB must fail"):
        parity.gate_check(case, wpath, low, high, str(root / "dead"), tol=2.0, device="cpu")


def test_port_imports_neither_cv2_nor_pil():
    """Importing every module of the port (the metrics and the measure
    CLIs among them) loads neither cv2 nor PIL, and parses no argv."""
    import subprocess

    code = (
        "import importlib, pkgutil, sys\n"
        "sys.argv = ['x', '--no-such-flag']\n"
        "import hvi_cidnet_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('cv2', 'PIL', 'jax')]\n"
        "assert not bad, bad\n"
        "assert 'hvi_cidnet_torch.cli.parity' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
