"""Eval datasets: image files listed, sized, decoded and written.

This package's own copy of ``is_image_file``, ``load_image``,
``list_images``, ``image_size`` and ``EvalDataset``
(``hvi_cidnet_tpu/data/datasets.py:34-85,181-215``; that package is not
importable without jax), and ``read_rgb``, the measure harness's reader.
The one change is the decoder: a PNG is read by ``data/png.py`` (zlib and
numpy; the port's paths must run where neither PIL nor cv2 is installed),
bit for bit what the JAX package's ``cv2.imread(..., IMREAD_COLOR)``
returns, and its size comes from its ``IHDR`` chunk. Every
other extension goes through PIL, imported inside the call, with its EXIF
orientation applied as cv2 applies it. ``save_image`` writes a PNG the
same way. The training datasets come with the training data pipeline.
"""

from __future__ import annotations

import os
from os import listdir
from os.path import join
from typing import List, Tuple

import numpy as np

from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.data.transforms import pad_to_multiple, to_float01

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
