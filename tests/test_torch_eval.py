"""Dataset evaluation in the PyTorch port vs the JAX package (CPU, fp32).

* ``data/png.py`` decodes bitwise as the JAX ``load_image`` (cv2 here) for
  grey, grey + alpha, RGB, RGBA and palette PNGs written by cv2, by PIL and,
  for each of the five row filters, by a reference encoder in this file;
  PIL reads the port's written PNG back bitwise; the ``IHDR`` size is the
  JAX ``image_size``.
* ``data/transforms.py``, ``data/datasets.py``: the copies equal the JAX
  functions (file order, ``sizes()``, items with ``pad`` on and off, an
  EXIF-rotated JPEG's size).
* ``eval/evaluator.py``: ``_bucket``, ``plan_bucket_quantum``, ``_pad_to``
  and ``gates_for_dataset`` equal the JAX functions; ``run_dataset`` on a
  mixed-size folder (paired and unpaired, ``max_programs`` None and 2,
  batch 8 with a partial chunk) writes the JAX evaluator's file names and
  shapes, its batches' floats within 2e-5 (the port's end-to-end bar,
  docs/DESIGN.md), its PNGs within one uint8 level (truncation may flip at
  a level's boundary), and raises the JAX error text on a decoded shape
  that exceeds its bucket.

The module-scoped fixture runs the JAX evaluator once a case, with the JAX
Pallas kernels in interpret mode (``PALLAS_FORCE_INTERPRET=1``). The eval
CLIs are held to the JAX CLIs in ``tests/test_torch_eval_cli.py``.
"""

import os
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from hvi_cidnet_tpu.data import datasets as jax_datasets
from hvi_cidnet_tpu.data import transforms as jax_transforms
from hvi_cidnet_tpu.eval import evaluator as jax_evaluator
from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_torch.compat.jax_params import torch_to_jax_params
from hvi_cidnet_torch.data import datasets, png, transforms
from hvi_cidnet_torch.eval import evaluator
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas():
    """The JAX package's Pallas kernels in interpret mode, as its tests run
    them on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_FORCE_INTERPRET", "1")
        yield


# ---------------------------------------------------------------------------
# data/png.py
# ---------------------------------------------------------------------------

# name -> (PNG colour type, samples a pixel)
CTYPES = {"grey": (0, 1), "rgb": (2, 3), "palette": (3, 1), "grey_alpha": (4, 2), "rgba": (6, 4)}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(path, samples: np.ndarray, ctype: int, filters, palette=None, interlace=0):
    """A PNG of ``samples`` (H, W, spp) uint8, row i filtered with
    ``filters[i % len(filters)]``: a reference encoder, byte by byte as the
    PNG specification defines the five filters."""
    h, w, spp = samples.shape
    raw = samples.reshape(h, w * spp).astype(np.int64)
    prev = np.zeros(w * spp, np.int64)
    rows = []
    for i in range(h):
        f = filters[i % len(filters)]
        cur = raw[i]
        a = np.concatenate([np.zeros(spp, np.int64), cur[:-spp]])
        c = np.concatenate([np.zeros(spp, np.int64), prev[:-spp]])
        pred = [0, a, prev, (a + prev) // 2, _paeth(a, prev, c)][f]
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes()) + chunk(b"tRNS", bytes(range(len(palette))))
    data += chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")
    Path(path).write_bytes(data)


def _samples(rng, ctype_name, h=13, w=21):
    ctype, spp = CTYPES[ctype_name]
    if ctype == 3:
        palette = rng.integers(0, 256, (19, 3), dtype=np.uint8)
        return rng.integers(0, 19, (h, w, 1), dtype=np.uint8), ctype, palette
    return rng.integers(0, 256, (h, w, spp), dtype=np.uint8), ctype, None


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("ctype", list(CTYPES))
def test_png_row_filters_decode_as_jax_load_image(tmp_path, ctype, filters):
    samples, code, palette = _samples(np.random.default_rng(len(filters) * 7 + filters[0]), ctype)
    path = str(tmp_path / "x.png")
    _encode(path, samples, code, filters, palette)
    got = png.read(path)
    assert got.dtype == np.uint8 and got.shape == (13, 21, 3)
    assert np.array_equal(got, jax_datasets.load_image(path))
    # alpha dropped, not composited (``tRNS`` too), as cv2 drops it
    assert np.array_equal(got, np.asarray(Image.open(path).convert("RGBA"))[..., :3])


def _write_cv2(path, rng, kind):
    img = rng.integers(0, 256, (17, 30, {"grey": 1, "rgb": 3, "rgba": 4}[kind]), dtype=np.uint8)
    assert cv2.imwrite(path, img[..., 0] if kind == "grey" else img)


def _write_pil(path, rng, kind):
    rgb = Image.fromarray(rng.integers(0, 256, (17, 30, 3), dtype=np.uint8))
    mode = {"grey": "L", "grey_alpha": "LA", "rgb": "RGB", "rgba": "RGBA"}.get(kind)
    (rgb.quantize(23) if kind == "palette" else rgb.convert(mode)).save(path)


@pytest.mark.parametrize("writer, kind", [
    ("cv2", "grey"), ("cv2", "rgb"), ("cv2", "rgba"),
    ("pil", "grey"), ("pil", "grey_alpha"), ("pil", "rgb"), ("pil", "rgba"), ("pil", "palette"),
])
def test_png_written_by_cv2_and_pil_decodes_as_jax_load_image(tmp_path, writer, kind):
    path = str(tmp_path / f"{writer}_{kind}.png")
    (_write_cv2 if writer == "cv2" else _write_pil)(path, np.random.default_rng(1), kind)
    got = png.read(path)
    assert np.array_equal(got, jax_datasets.load_image(path))
    assert png.image_size(path) == jax_datasets.image_size(path) == got.shape[:2]


@pytest.mark.parametrize("shape", [(1, 1), (13, 21), (400, 3)], ids=str)
def test_png_write_reads_back_in_pil_bitwise(tmp_path, shape):
    img = np.random.default_rng(2).integers(0, 256, (*shape, 3), dtype=np.uint8)
    path = str(tmp_path / "w.png")
    png.write(path, img)
    with Image.open(path) as im:
        assert im.mode == "RGB" and np.array_equal(np.asarray(im), img)
    assert np.array_equal(png.read(path), img)
    assert png.image_size(path) == jax_datasets.image_size(path) == shape


@pytest.mark.parametrize("case", ["interlaced", "16-bit"])
def test_png_rejects_what_it_does_not_read_naming_the_file(tmp_path, case):
    path = str(tmp_path / f"{case}.png")
    rgb = np.random.default_rng(3).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    if case == "interlaced":
        _encode(path, rgb, 2, [0], interlace=1)
    else:
        assert cv2.imwrite(path, rgb.astype(np.uint16) * 257)
    with pytest.raises(ValueError, match=f"{case}.png.*(interlaced|16-bit)"):
        png.read(path)


def test_png_write_takes_rgb_uint8_only(tmp_path):
    with pytest.raises(ValueError, match="RGB uint8"):
        png.write(str(tmp_path / "f.png"), np.zeros((4, 4, 3), np.float32))


# ---------------------------------------------------------------------------
# data/transforms.py, data/datasets.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, factor", [((13, 21, 3), 8), ((16, 24, 3), 8), ((3, 17, 3), 8),
                                           ((37, 61, 3), 32)], ids=str)
def test_transforms_equal_jax(shape, factor):
    img = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    assert np.array_equal(transforms.to_float01(img), jax_transforms.to_float01(img))
    f = transforms.to_float01(img)
    assert np.array_equal(transforms.to_float01(f), jax_transforms.to_float01(f))
    got, ref = transforms.pad_to_multiple(f, factor), jax_transforms.pad_to_multiple(f, factor)
    assert got[1:] == ref[1:] and np.array_equal(got[0], ref[0])


def _folder(path, sizes, seed=5, ext=".png"):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        img = (rng.uniform(0, 0.4, (h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(path, f"{i:02d}_{h}x{w}{ext}"))
    return str(path)


# nine of one padded shape (a chunk of 8 and a partial one), a transpose, a
# 3-row sliver (edge padding below 8 rows) and a larger image
SIZES = [(16, 24)] * 9 + [(13, 21), (21, 13), (3, 17), (40, 32)]


@pytest.mark.parametrize("pad", [False, True], ids=["pad_off", "pad_on"])
def test_eval_dataset_equals_jax(tmp_path, pad):
    folder = _folder(tmp_path / "d", SIZES)
    (tmp_path / "d" / "notes.txt").write_text("not an image")
    port, ref = datasets.EvalDataset(folder, pad=pad), jax_datasets.EvalDataset(folder, pad=pad)
    assert port.files == ref.files and len(port) == len(ref) == len(SIZES)
    assert port.sizes() == ref.sizes()
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert len(got) == len(want) == (4 if pad else 2)
        assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
        assert got[1:] == want[1:]


def test_bmp_decodes_as_jax_load_image_and_is_listed(tmp_path):
    folder = _folder(tmp_path / "b", [(9, 14), (16, 8)], ext=".bmp")
    for f in datasets.list_images(folder):
        assert np.array_equal(datasets.load_image(f), jax_datasets.load_image(f))
        assert datasets.image_size(f) == jax_datasets.image_size(f)
    assert sorted(datasets.list_images(folder)) == sorted(jax_datasets.list_images(folder))
    assert [datasets.is_image_file(n) for n in ("a.png", "a.JPG", "a.jpeg", "a.gif", "a.PNG")] == [
        jax_datasets.is_image_file(n) for n in ("a.png", "a.JPG", "a.jpeg", "a.gif", "a.PNG")]


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_exif_rotated_jpeg_size_equals_jax(tmp_path, orientation):
    """The header size honours the EXIF orientation, as the decoder applies
    it (``tests/test_data.py:test_image_size_honors_exif_orientation``)."""
    img = Image.fromarray(np.random.default_rng(3).integers(0, 255, (40, 56, 3)).astype(np.uint8))
    ex = Image.Exif()
    ex[0x0112] = orientation
    p = str(tmp_path / "rot.jpg")
    img.save(p, exif=ex)
    assert datasets.image_size(p) == jax_datasets.image_size(p)
    assert datasets.load_image(p).shape[:2] == jax_datasets.load_image(p).shape[:2]
    assert datasets.image_size(p) == datasets.load_image(p).shape[:2]


def test_png_needs_no_pil_and_other_formats_name_the_file(tmp_path, monkeypatch):
    folder = _folder(tmp_path / "p", [(9, 14)])
    jpg = str(tmp_path / "x.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpg)
    monkeypatch.setitem(sys.modules, "PIL", None)
    f = datasets.list_images(folder)[0]
    assert datasets.load_image(f).shape == (9, 14, 3) and datasets.image_size(f) == (9, 14)
    for call in (datasets.load_image, datasets.image_size):
        with pytest.raises(ImportError, match="x.jpg"):
            call(jpg)


# ---------------------------------------------------------------------------
# eval/evaluator.py: helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h, w, factor", [(16, 24, 8), (13, 21, 8), (3, 17, 8), (400, 601, 8),
                                          (37, 61, 32), (1, 1, 64)])
def test_bucket_and_pad_equal_jax(h, w, factor):
    assert evaluator._bucket(h, w, factor) == jax_evaluator._bucket(h, w, factor)
    img = np.random.default_rng(6).uniform(0, 1, (h, w, 3)).astype(np.float32)
    bh, bw = jax_evaluator._bucket(h, w, factor)
    assert np.array_equal(evaluator._pad_to(img, bh, bw), jax_evaluator._pad_to(img, bh, bw))


@pytest.mark.parametrize("max_programs", [None, 1, 2, 3, 4, 13])
def test_plan_bucket_quantum_equals_jax(max_programs):
    shapes = SIZES + [(24 + 8 * i, 88 - 4 * i) for i in range(14)] + [(400, 600), (720, 1280)]
    for factor in (8, 16):
        assert (evaluator.plan_bucket_quantum(shapes, factor, max_programs)
                == jax_evaluator.plan_bucket_quantum(shapes, factor, max_programs))


@pytest.mark.parametrize("flags", [{}, {"lol": True}, {"lmot": True}, {"v2": True, "alpha": 0.84},
                                   {"unpaired": True, "alpha": 0.9},
                                   {"lol": True, "v2": True, "alpha": 0.8}], ids=str)
def test_gates_for_dataset_equal_jax(flags):
    got = evaluator.gates_for_dataset(**flags)
    ref = jax_evaluator.gates_for_dataset(**flags)
    assert (got.gated, got.gated2, got.alpha, got.alpha_s) == (
        ref.gated, ref.gated2, ref.alpha, ref.alpha_s)


# ---------------------------------------------------------------------------
# Evaluator.run_dataset against the JAX evaluator
# ---------------------------------------------------------------------------

RUNS = {"paired": (False, None), "unpaired": (True, None), "unpaired_max2": (True, 2)}


def _jax_params(model: CIDNet) -> dict:
    return {k: np.ascontiguousarray(v) for k, v in torch_to_jax_params(model.state_dict()).items()}


def _recording(ev):
    """Record each batch ``ev.enhance_batch`` returns."""
    seen, original = [], ev.enhance_batch
    ev.enhance_batch = lambda imgs: (seen.append(np.asarray(original(imgs))), seen[-1])[1]
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case of RUNS: the JAX and the port evaluator's batches and output
    folders on one tiny model and one mixed-size folder, at batch 8."""
    root = tmp_path_factory.mktemp("run_dataset")
    folder = _folder(root / "in", SIZES)
    model = CIDNet(CIDNetConfig(**TINY), generator=torch.Generator().manual_seed(3)).eval()
    params = _jax_params(model)
    out = {}
    for case, (pad, max_programs) in RUNS.items():
        flags = {"unpaired": True, "alpha": 0.9} if pad else {"lol": True}
        kw = dict(gamma=0.9, max_programs=max_programs)
        ref = jax_evaluator.Evaluator(params, JaxConfig(**TINY),
                                      jax_evaluator.gates_for_dataset(**flags), **kw)
        port = evaluator.Evaluator(model, None, evaluator.gates_for_dataset(**flags), device="cpu",
                                   **kw)
        res = {}
        for name, ev, ds in (("jax", ref, jax_datasets.EvalDataset(folder, pad=pad)),
                             ("port", port, datasets.EvalDataset(folder, pad=pad))):
            batches = _recording(ev)
            n = ev.run_dataset(ds, str(root / case / name), verbose=False, batch_size=8)
            res[name] = (n, batches, root / case / name)
        out[case] = res
    return out


@pytest.mark.parametrize("case", list(RUNS))
def test_run_dataset_writes_the_jax_files(runs, case):
    (n_jax, b_jax, d_jax), (n, b, d) = runs[case]["jax"], runs[case]["port"]
    assert n == n_jax == len(SIZES)
    names = sorted(os.listdir(d))
    assert names == sorted(os.listdir(d_jax)) and len(names) == len(SIZES)
    for name in names:
        got, ref = png.read(str(d / name)), np.asarray(Image.open(d_jax / name).convert("RGB"))
        h, w = (int(v) for v in name[3:-4].split("x"))
        assert got.shape == ref.shape == (h, w, 3)
        assert np.abs(got.astype(np.int16) - ref).max() <= 1, name


@pytest.mark.parametrize("case", list(RUNS))
def test_run_dataset_batches_match_jax(runs, case):
    """The same chunks in the same order (bucket order, batch 8, the tail
    repeated to 8 rows under ``max_programs``), floats within 2e-5."""
    b_jax, b = runs[case]["jax"][1], runs[case]["port"][1]
    assert [x.shape for x in b] == [x.shape for x in b_jax]
    if RUNS[case][1] is not None:
        assert all(x.shape[0] == 8 for x in b)
    else:
        assert sorted(x.shape[0] for x in b if x.shape[1:3] == (16, 24)) == [2, 8]
    for got, ref in zip(b, b_jax):
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


class _LyingSizes:
    """A dataset whose ``sizes()`` understates its decoded shapes."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def sizes(self):
        return [(8, 8)] * len(self.base)

    def __getitem__(self, i):
        return self.base[i]


def test_decoded_shape_error_equals_jax(tmp_path):
    folder = _folder(tmp_path / "in", [(16, 24)])
    model = CIDNet(CIDNetConfig(**TINY), generator=torch.Generator().manual_seed(3)).eval()
    port = evaluator.Evaluator(model, None, device="cpu")
    ref = jax_evaluator.Evaluator(_jax_params(model), JaxConfig(**TINY))
    with pytest.raises(ValueError) as got:
        port.run_dataset(_LyingSizes(datasets.EvalDataset(folder)), str(tmp_path / "a"))
    with pytest.raises(ValueError) as want:
        ref.run_dataset(_LyingSizes(jax_datasets.EvalDataset(folder)), str(tmp_path / "b"))
    assert str(got.value) == str(want.value) and "exceeds its planned bucket" in str(got.value)


def test_enhance_takes_the_bucket_factor(tmp_path):
    """``Evaluator.enhance`` pads to ``bucket_factor``, as the JAX one."""
    model = CIDNet(CIDNetConfig(**TINY), generator=torch.Generator().manual_seed(4)).eval()
    img = np.random.default_rng(0).uniform(0, 1, (37, 61, 3)).astype(np.float32)
    port = evaluator.Evaluator(model, None, device="cpu", bucket_factor=32)
    ref = jax_evaluator.Evaluator(_jax_params(model), JaxConfig(**TINY), bucket_factor=32)
    got = port.enhance(img)
    assert got.shape == (37, 61, 3)
    np.testing.assert_allclose(got, ref.enhance(img), atol=ATOL, rtol=0)


def test_every_port_module_imports_without_pil_or_cv2():
    """The machine with the card has neither: no module of the port imports
    them when it is imported (PNG needs neither at all)."""
    import subprocess

    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['PIL'] = sys.modules['cv2'] = None\n"
        "import hvi_cidnet_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(Path(__file__).resolve().parents[1]),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr
