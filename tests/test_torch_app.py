"""The port's interactive UI (``hvi_cidnet_torch/cli/app.py``) on the CPU.

* The five cases of ``tests/test_app_ui.py`` against the port's stdlib
  fallback server over a real socket: the page and its controls, 404, a bad
  body's JSON 500, a PNG round trip through the model, an arbitrary weights
  path's 400.
* ``process_image`` against the JAX app's (``cli/app.py``) on weights
  written from one JAX init (a tiny base config in both apps): within one
  uint8 level, at least 99.9% of pixels equal; the info text's NIQE as
  ``calculate_niqe`` on the output; a PNG posted to the server and the
  decoded reply equal to ``process_image``'s array.
* The app imports with PIL made unimportable (a fresh process); a JPEG body
  then gives the JSON error naming the format; ``--cpu`` is needed where
  there is no card.
"""

from __future__ import annotations

import base64
import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hvi_cidnet_torch.cli import app
from hvi_cidnet_torch.compat.checkpoint import export_pth
from hvi_cidnet_torch.compat.jax_params import jax_params_to_torch
from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.metrics.niqe import calculate_niqe
from hvi_cidnet_torch.models.cidnet import CIDNetConfig
from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import init_cidnet
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))


def _load_jax_app():
    spec = importlib.util.spec_from_file_location("jax_cli_app",
                                                  os.path.join(REPO, "cli", "app.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def server():
    saved = app.DEVICE
    app.DEVICE = "cpu"
    srv = app.make_fallback_server("127.0.0.1", 0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    app.DEVICE = saved


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=600).read().decode())


def test_page_carries_every_reference_control(server):
    html = urllib.request.urlopen(f"{server}/", timeout=10).read().decode()
    for control in ("gamma", "alpha_s", "alpha_i", "weights", "score", "/enhance"):
        assert control in html
    assert "&lt;random init&gt;" in html


def test_unknown_path_is_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/nope", timeout=10)
    assert e.value.code == 404


def test_bad_body_returns_json_error(server):
    req = urllib.request.Request(
        f"{server}/enhance?weights=%3Crandom%20init%3E", data=b"not an image", method="POST"
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 500
    assert "error" in json.loads(e.value.read().decode())


def test_enhance_roundtrip_runs_model(server):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (16, 24, 3), np.uint8)
    reply = _post(f"{server}/enhance?weights=%3Crandom%20init%3E&gamma=1.0&alpha_s=1.0"
                  "&alpha_i=1.0", png.encode(img))
    out = png.decode(base64.b64decode(reply["image"]))
    assert out.shape == (16, 24, 3) and out.dtype == np.uint8  # padded inside, cropped back
    assert reply["info"] == ""


def test_arbitrary_weights_path_rejected(server):
    req = urllib.request.Request(
        f"{server}/enhance?weights=/tmp/attacker.pth", data=b"x", method="POST"
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    assert "unknown weights" in json.loads(e.value.read().decode())["error"]


@pytest.fixture(scope="module")
def jax_init_dir(tmp_path_factory):
    """A directory holding weights/jax_init.pth: one JAX init of a tiny
    base config, in the reference layout."""
    root = tmp_path_factory.mktemp("app")
    params = {k: np.asarray(v) for k, v in
              init_cidnet(jax.random.PRNGKey(3), JaxConfig(**TINY)).items()}
    (root / "weights").mkdir()
    export_pth(str(root / "weights" / "jax_init.pth"), jax_params_to_torch(params))
    return root


@pytest.fixture
def tiny_weights(jax_init_dir, monkeypatch):
    """The JAX init's weights as the working directory's only entry, and
    both apps building the tiny base config."""
    monkeypatch.chdir(jax_init_dir)
    monkeypatch.setattr(app, "DEVICE", "cpu")
    monkeypatch.setattr(app, "CIDNetConfig", functools.partial(CIDNetConfig, **TINY))
    monkeypatch.setattr(app, "_cache", {})
    jax_app = _load_jax_app()
    monkeypatch.setattr(jax_app, "CIDNetConfig", functools.partial(JaxConfig, **TINY))
    assert app.find_weights() == jax_app.find_weights() == [
        os.path.join("weights", "jax_init.pth"), app.RANDOM_INIT]
    return os.path.join("weights", "jax_init.pth"), jax_app


def test_process_image_matches_jax(tiny_weights):
    path, jax_app = tiny_weights
    rng = np.random.default_rng(5)
    img = (rng.uniform(0, 0.5, (101, 131, 3)) * 255).astype(np.uint8)  # NIQE's 96-pixel blocks
    args = (True, path, 0.9, 1.1, 0.95)
    got, info = app.process_image(img, *args)
    ref_img, ref_info = jax_app.process_image(Image.fromarray(img), *args)
    ref = np.asarray(ref_img)
    assert got.dtype == np.uint8 and got.shape == ref.shape == img.shape
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    assert info.startswith(f"NIQE: {calculate_niqe(got):.4f}")
    assert ref_info.split("  ")[1:] == info.split("  ")[1:]  # the BRISQUE part
    # a PIL image (gradio's) gives the same; grey and alpha as convert("RGB")
    np.testing.assert_array_equal(app.process_image(Image.fromarray(img), *args)[0], got)
    rgba = np.concatenate([img, np.full(img.shape[:2] + (1,), 7, np.uint8)], axis=2)
    np.testing.assert_array_equal(app.process_image(rgba, *args)[0], got)
    grey = img[:37, :45, 1]
    no_score = (False, *args[1:])
    np.testing.assert_array_equal(app.process_image(grey, *no_score)[0],
                                  app.process_image(np.repeat(grey[:, :, None], 3, 2),
                                                    *no_score)[0])
    assert app.process_image(None, *args) == (None, "no image")


def test_server_reply_is_process_image(tiny_weights):
    path, _ = tiny_weights
    srv = app.make_fallback_server("127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        img = (np.random.default_rng(6).uniform(0, 1, (97, 100, 3)) * 255).astype(np.uint8)
        url = (f"http://127.0.0.1:{srv.server_address[1]}/enhance?weights="
               f"{urllib.request.quote(path)}&gamma=0.8&alpha_s=1.2&alpha_i=1.0&score=1")
        reply = _post(url, png.encode(img))
        # a JPEG body goes through PIL
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=95)
        jpeg_reply = _post(url, buf.getvalue())
    finally:
        srv.shutdown()
    out = png.decode(base64.b64decode(reply["image"]))
    want, info = app.process_image(img, True, path, 0.8, 1.2, 1.0)
    np.testing.assert_array_equal(out, want)
    assert reply["info"] == info and info.startswith(f"NIQE: {calculate_niqe(out):.4f}")
    jpeg = np.asarray(Image.open(buf).convert("RGB"))
    np.testing.assert_array_equal(png.decode(base64.b64decode(jpeg_reply["image"])),
                                  app.process_image(jpeg, False, path, 0.8, 1.2, 1.0)[0])


def test_app_imports_without_pil():
    code = (
        "import sys; sys.modules.update(PIL=None, cv2=None)\n"
        "from hvi_cidnet_torch.cli import app\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'hvi_cidnet_tpu')]\n"
        "assert not bad, bad\n"
        "try:\n"
        "    app.decode_body(b'\\xff\\xd8\\xff\\xe0 jpeg')\n"
        "except ValueError as e:\n"
        "    print(e)\n"
        "import numpy as np\n"
        "img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)\n"
        "assert (app.decode_body(app.png.encode(img)) == img).all()\n"
        "try:\n"
        "    app.main([])\n"
        "except SystemExit as e:\n"
        "    print(e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "JPEG image: only PNG is decoded without PIL, and PIL is not installed"
    if not torch.cuda.is_available():
        assert lines[1].startswith("no CUDA device") and "--cpu" in lines[1]
