"""Datasets: image files listed, sized, decoded and written; the training
samplers and the eval folders.

This package's own copy of ``is_image_file``, ``load_image``,
``list_images``, ``image_size``, the training datasets
``PairedFolderDataset`` and ``SceneFolderDataset`` and ``EvalDataset``
(``hvi_cidnet_tpu/data/datasets.py:34-215``; that package is not
importable without jax), and ``read_rgb``, the measure harness's reader.
The one change is the decoder: a PNG is read by ``data/png.py`` (zlib and
numpy; the port's paths must run where neither PIL nor cv2 is installed),
bit for bit what the JAX package's ``cv2.imread(..., IMREAD_COLOR)``
returns, and its size comes from its ``IHDR`` chunk. Every
other extension goes through PIL, imported inside the call, with its EXIF
orientation applied as cv2 applies it. ``save_image`` writes a PNG the
same way. So the SICE corpus's ``.JPG`` labels need PIL; every PNG corpus
trains without it.
"""

from __future__ import annotations

import os
from os import listdir
from os.path import join
from typing import List, Optional, Tuple

import numpy as np

from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.data.transforms import (
    pad_to_multiple,
    paired_random_crop_flip,
    to_float01,
)

_IMG_EXTS = (".png", ".jpg", ".bmp", ".JPG", ".jpeg")
# EXIF orientations that transpose the image (90 or 270 degrees)
_TRANSPOSING = (5, 6, 7, 8)


def is_image_file(name: str) -> bool:
    return name.endswith(_IMG_EXTS)


def _is_png(path: str) -> bool:
    return path.lower().endswith(".png")


def _pil(path: str):
    """PIL's ``Image`` module, or an ``ImportError`` that names ``path``."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: only PNG is decoded without PIL, and PIL is not "
                          "installed") from e
    return Image


def load_image(path: str) -> np.ndarray:
    """Decode to RGB uint8 HWC."""
    if _is_png(path):
        return png.read(path)
    Image = _pil(path)
    from PIL import ImageOps

    with Image.open(path) as im:
        return np.asarray(ImageOps.exif_transpose(im).convert("RGB"))


def read_rgb(path: str) -> np.ndarray:
    """RGB uint8 HWC as PIL's ``Image.open(path).convert("RGB")``, which
    the JAX measure harness reads with: as ``load_image``, but a non-PNG
    keeps its stored orientation (no EXIF transpose)."""
    if _is_png(path):
        return png.read(path)
    with _pil(path).open(path) as im:
        return np.asarray(im.convert("RGB"))


def save_image(path: str, img: np.ndarray) -> None:
    """Write RGB uint8 HWC ``img``: a ``.png`` through ``data/png.py``, any
    other extension through PIL, which picks the format from it (as the JAX
    evaluator's ``Image.save`` does)."""
    if _is_png(path):
        png.write(path, img)
    else:
        _pil(path).fromarray(img).save(path)


def list_images(folder: str) -> List[str]:
    return [join(folder, x) for x in listdir(folder) if is_image_file(x)]


def image_size(path: str) -> Tuple[int, int]:
    """Decoded (h, w) from the image header, with no pixel decode, so eval
    bucket planning over a full-resolution set reads kilobytes.

    A PNG's comes from its ``IHDR``. For the other formats EXIF orientation
    is honoured: ``load_image`` applies it, so orientations 5-8 (90- and
    270-degree transposes) swap the header's (w, h), or bucket planning
    would disagree with the decoded shape."""
    if _is_png(path):
        return png.image_size(path)
    Image = _pil(path)
    with Image.open(path) as im:
        w, h = im.size
        try:
            orientation = im.getexif().get(0x0112, 1)
        except Exception:  # a malformed EXIF block: PIL raises several types
            orientation = 1
    if orientation in _TRANSPOSING:
        w, h = h, w
    return h, w


class PairedFolderDataset:
    """Aligned low/high folders (LOLv1 low/high, LOLv2 Low/Normal, LMOT).

    Reference classes: LOL*DatasetFromFolder / LMOTDatasetFromFolder
    (data/LOLdataset.py). The reference hardcodes epoch lengths
    (485/685/900, passed by ``cli/train.py``); the default is the file
    count.
    """

    def __init__(self, low_dir: str, high_dir: str, crop_size: int = 256,
                 length: Optional[int] = None):
        self.low_files = sorted(list_images(low_dir))
        self.high_files = sorted(list_images(high_dir))
        if not self.low_files:
            raise FileNotFoundError(f"no images in {low_dir}")
        self.crop_size = crop_size
        self._length = length if length is not None else len(self.low_files)

    def __len__(self) -> int:
        return self._length

    def sample(self, index: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        i = index % len(self.low_files)
        im1 = load_image(self.low_files[i])
        im2 = load_image(self.high_files[i])
        im1, im2 = paired_random_crop_flip(im1, im2, self.crop_size, rng)
        return to_float01(im1), to_float01(im2)


class SceneFolderDataset:
    """Folder-of-folders stochastic sampler (LOL-Blur / SID / SICE).

    ``kind``:
      * ``"blur"``: low_blur/NNNN vs high_sharp_scaled/NNNN, frame-aligned
        pairs, scenes 1..260, virtual len 10200 (SICE_blur_SID.py:13-50);
      * ``"sid"``: short/NNNNN vs long/NNNNN, GT = first long frame,
        scenes 1..234, virtual len 2099 (:53-92);
      * ``"sice"``: <root>/N vs <root>/../label/N.JPG, scenes 1..591,
        virtual len 4803 (:96-133).

    The index argument is ignored: sampling is purely stochastic, like the
    reference's ``while True`` + fresh ``random.randint`` loops, bounded at
    10,000 draws.
    """

    _SPEC = {
        "blur": dict(n_scenes=260, length=10200, zfill=4),
        "sid": dict(n_scenes=234, length=2099, zfill=5),
        "sice": dict(n_scenes=591, length=4803, zfill=0),
    }

    def __init__(self, data_dir: str, kind: str, crop_size: int = 256):
        if kind not in self._SPEC:
            raise ValueError(f"unknown kind {kind}")
        self.data_dir = data_dir
        self.kind = kind
        self.crop_size = crop_size
        self.spec = self._SPEC[kind]

    def __len__(self) -> int:
        return self.spec["length"]

    def _scene_dirs(self, scene: int) -> Tuple[str, str]:
        z = self.spec["zfill"]
        name = str(scene + 1).zfill(z) if z else str(scene + 1)
        if self.kind == "blur":
            return join(self.data_dir, "low_blur", name), join(self.data_dir, "high_sharp_scaled", name)
        if self.kind == "sid":
            return join(self.data_dir, "short", name), join(self.data_dir, "long", name)
        return join(self.data_dir, name), join(os.path.dirname(self.data_dir), "label", name + ".JPG")

    def sample(self, index: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        del index  # stochastic by design (SICE_blur_SID.py:20-34)
        for _ in range(10_000):
            scene = int(rng.integers(0, self.spec["n_scenes"]))
            low_dir, high_ref = self._scene_dirs(scene)
            if not os.path.isdir(low_dir):
                continue
            files = sorted(list_images(low_dir))
            if not files:
                continue
            j = int(rng.integers(0, len(files)))
            im1 = load_image(files[j])
            if self.kind == "blur":
                im2 = load_image(sorted(list_images(high_ref))[j])
            elif self.kind == "sid":
                im2 = load_image(sorted(list_images(high_ref))[0])
            else:
                im2 = load_image(high_ref)
            im1, im2 = paired_random_crop_flip(im1, im2, self.crop_size, rng)
            return to_float01(im1), to_float01(im2)
        raise FileNotFoundError(f"no usable scene folders under {self.data_dir}")


class EvalDataset:
    """Sorted eval files; optional pad-to-x8 with original size retained.

    ``pad=False`` == DatasetFromFolderEval (eval_sets.py:35-52);
    ``pad=True``  == SICEDatasetFromFolderEval (eval_sets.py:9-32).
    """

    def __init__(self, data_dir: str, pad: bool = False, factor: int = 8):
        self.files = sorted(list_images(data_dir))
        self.pad = pad
        self.factor = factor

    def __len__(self) -> int:
        return len(self.files)

    def sizes(self) -> List[Tuple[int, int]]:
        """Per-item decoded (h, w) from headers only: the evaluator plans
        its shape buckets from this without decoding any pixels."""
        out = []
        for f in self.files:
            h, w = image_size(f)
            if self.pad:
                q = self.factor
                h, w = (h + q - 1) // q * q, (w + q - 1) // q * q
            out.append((h, w))
        return out

    def __getitem__(self, i: int):
        img = to_float01(load_image(self.files[i]))
        name = os.path.basename(self.files[i])
        if self.pad:
            img, h, w = pad_to_multiple(img, self.factor)
            return img, name, h, w
        return img, name
