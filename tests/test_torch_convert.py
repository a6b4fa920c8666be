"""The PyTorch port's weight writers and converter vs the JAX package's (CPU).

* ``torch_to_jax_params`` is the exact inverse of ``jax_params_to_torch``
  and equals the JAX ``from_torch_state_dict``.
* ``save_checkpoint``'s ``.npz`` loads in the JAX ``load_checkpoint``
  bitwise equal to the JAX ``save_checkpoint``'s of the same parameters;
  ``export_pth`` equals the JAX ``export_pth``; ``compat/safetensors_io.py``'s
  ``save_file`` loads in the ``safetensors`` package bitwise; ``save_pretrained``
  writes the JAX folder (tensors bitwise, ``config.json`` equal as JSON) for
  base, MSSA and TNSM.
* ``cli/convert_weights.py`` writes what the JAX ``cli/convert_weights.py``
  writes from the same source (``.pth``, the JAX checkpoint, ``.safetensors``,
  an HF folder) to ``.npz``, ``.pth`` and ``--hf``; an orbax tree raises.
* ``cli/eval_hf.py --local_file`` writes what the JAX CLI writes from the same
  folder and image (a tiny model through ``config.json``). The module-scoped
  fixture runs the JAX CLI once, with the JAX Pallas kernels in interpret
  mode (``PALLAS_FORCE_INTERPRET=1``).
"""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import safetensors.numpy
import safetensors.torch
import torch
from PIL import Image

from hvi_cidnet_tpu.compat.torch_ckpt import from_torch_state_dict
from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.train import checkpoint as jax_ckpt
from hvi_cidnet_torch.cli import convert_weights, eval_hf
from hvi_cidnet_torch.compat import checkpoint, safetensors_io
from hvi_cidnet_torch.compat.jax_params import (
    jax_params_to_torch,
    load_state_dict_file,
    torch_to_jax_params,
)
from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
from hvi_cidnet_torch.utils.hf_config import config_from_hf_json
from _torch_port import one_torch_thread, run_jax_cli  # noqa: F401 (autouse)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
VARIANTS = ("base", "mssa", "tnsm")


def _state(variant="base", seed=0, **kw):
    cfg = CIDNetConfig(variant=variant, **kw)
    return CIDNet(cfg, generator=torch.Generator().manual_seed(seed)).state_dict(), cfg


def _jax(state) -> dict:
    """The JAX package's parameter dict of a reference-layout state dict."""
    return from_torch_state_dict(state)


def _equal_dicts(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


@pytest.mark.parametrize("variant", VARIANTS)
def test_torch_to_jax_params_inverts_jax_params_to_torch(variant):
    state, _ = _state(variant, **TINY)
    jax_params = torch_to_jax_params(state)
    _equal_dicts(jax_params, {k: np.asarray(v) for k, v in _jax(state).items()})
    back = jax_params_to_torch(jax_params)
    _equal_dicts({k: v.numpy() for k, v in back.items()}, {k: v.numpy() for k, v in state.items()})
    again = torch_to_jax_params(back)
    _equal_dicts(again, jax_params)
    assert all(v.flags.c_contiguous for v in jax_params.values())


@pytest.mark.parametrize("epoch", [0, 12])
@pytest.mark.parametrize("variant", VARIANTS)
def test_save_checkpoint_loads_in_jax_as_its_own(tmp_path, variant, epoch):
    state, _ = _state(variant, seed=1, **TINY)
    port = checkpoint.save_checkpoint(str(tmp_path / "sub" / "port.npz"), state, epoch=epoch)
    ref = jax_ckpt.save_checkpoint(str(tmp_path / "jax.npz"), _jax(state), epoch=epoch)
    got, _, got_epoch = jax_ckpt.load_checkpoint(port)
    want, _, want_epoch = jax_ckpt.load_checkpoint(ref)
    _equal_dicts(got, want)
    assert got_epoch == want_epoch == epoch
    with np.load(port) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert not os.path.exists(port + ".tmp.npz")


@pytest.mark.parametrize("variant", VARIANTS)
def test_export_pth_equals_jax_export_pth(tmp_path, variant):
    state, _ = _state(variant, seed=2, **TINY)
    port = checkpoint.export_pth(str(tmp_path / "port.pth"), state)
    ref = jax_ckpt.export_pth(str(tmp_path / "jax.pth"), _jax(state))
    got = torch.load(port, weights_only=True)
    want = torch.load(ref, weights_only=True)
    _equal_dicts({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in want.items()})
    assert all(v.is_contiguous() for v in got.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.float64])
def test_safetensors_save_file_loads_in_the_safetensors_package(tmp_path, dtype):
    gen = torch.Generator().manual_seed(3)
    tensors = {"b.weight": torch.randn(4, 3, 3, 3, generator=gen).to(dtype),
               "a.scalar": torch.randn((), generator=gen).to(dtype),
               "c.vector": torch.randn(7, generator=gen).to(dtype),
               "d.empty": torch.zeros(0, 5, dtype=dtype),
               "e.strided": torch.randn(6, 4, generator=gen).to(dtype).t()}
    path = str(tmp_path / "t.safetensors")
    safetensors_io.save_file(tensors, path)
    ref = safetensors.torch.load_file(path)
    mine = safetensors_io.load_file(path)
    assert sorted(ref) == sorted(mine) == sorted(tensors)
    for k, v in tensors.items():
        assert ref[k].dtype == mine[k].dtype == dtype and torch.equal(ref[k], v), k
        assert torch.equal(mine[k], v), k
    assert int.from_bytes(Path(path).read_bytes()[:8], "little") % 8 == 0
    if dtype != torch.bfloat16:  # numpy has no bfloat16
        arrays = safetensors.numpy.load_file(path)
        for k, v in tensors.items():
            assert np.array_equal(arrays[k], v.numpy()), k


@pytest.mark.parametrize("variant", VARIANTS)
def test_save_pretrained_writes_the_jax_folder(tmp_path, variant):
    state, cfg = _state(variant, seed=4, **TINY)
    port = checkpoint.save_pretrained(str(tmp_path / "port"), state, cfg)
    ref = jax_ckpt.save_pretrained(str(tmp_path / "jax"), _jax(state), JaxConfig(variant=variant,
                                                                                 **TINY))
    _equal_dicts(safetensors.numpy.load_file(os.path.join(port, "model.safetensors")),
                 safetensors.numpy.load_file(os.path.join(ref, "model.safetensors")))
    got = json.loads(Path(port, "config.json").read_text())
    assert got == json.loads(Path(ref, "config.json").read_text())
    assert ("variant" in got) == (variant != "base")
    assert config_from_hf_json(os.path.join(port, "config.json")) == cfg
    back = load_state_dict_file(port)
    assert all(torch.equal(back[k], v) for k, v in state.items()) and back.keys() == state.keys()


def test_save_pretrained_without_a_config_writes_an_empty_one(tmp_path):
    state, _ = _state(**TINY)
    port = checkpoint.save_pretrained(str(tmp_path / "port"), state)
    ref = jax_ckpt.save_pretrained(str(tmp_path / "jax"), _jax(state))
    assert json.loads(Path(port, "config.json").read_text()) == json.loads(
        Path(ref, "config.json").read_text()) == {}


# ---------------------------------------------------------------------------
# cli/convert_weights.py against the JAX CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """One TNSM state (full width: the CLI's default channels) in each source
    format the converter reads."""
    root = tmp_path_factory.mktemp("sources")
    state, cfg = _state("tnsm", seed=5)
    paths = {"pth": checkpoint.export_pth(str(root / "w.pth"), state),
             "npz": checkpoint.save_checkpoint(str(root / "w.npz"), state, epoch=3),
             "hf": checkpoint.save_pretrained(str(root / "hf"), state, cfg)}
    paths["safetensors"] = os.path.join(paths["hf"], "model.safetensors")
    return paths


def _read_output(path: str) -> dict:
    """A converter output as numpy arrays by key, with the folder's config."""
    if os.path.isdir(path):
        out = dict(safetensors.numpy.load_file(os.path.join(path, "model.safetensors")))
        out["config.json"] = json.loads(Path(path, "config.json").read_text())
        return out
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    return {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}


@pytest.mark.parametrize("src, dst, extra", [
    ("pth", "out.npz", []), ("npz", "out.pth", []), ("safetensors", "out.npz", []),
    ("hf", "out.pth", []), ("pth", "hf_out", ["--hf", "--variant", "tnsm"]),
    ("npz", "hf_out", ["--hf"]),
], ids=["pth-npz", "npz-pth", "safetensors-npz", "hf-pth", "pth-hf_tnsm", "npz-hf"])
def test_convert_weights_cli_writes_what_the_jax_cli_writes(sources, tmp_path, src, dst, extra,
                                                            capsys):
    port_dst, jax_dst = str(tmp_path / "port" / dst), str(tmp_path / "jax" / dst)
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    convert_weights.main([sources[src], port_dst, *extra])
    port_out = capsys.readouterr().out
    run_jax_cli("convert_weights.py", [sources[src], jax_dst, *extra])
    jax_out = capsys.readouterr().out
    assert port_out == jax_out.replace(jax_dst, port_dst)
    got, ref = _read_output(port_dst), _read_output(jax_dst)
    if "config.json" in ref:
        assert got.pop("config.json") == ref.pop("config.json")
    _equal_dicts(got, ref)


def test_convert_weights_raises_on_an_orbax_tree_and_a_bad_destination(sources, tmp_path):
    tree = tmp_path / "orbax"
    (tree / "100").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        convert_weights.main([str(tree), str(tmp_path / "x.npz")])
    with pytest.raises(SystemExit, match="dst must end in .npz or .pth"):
        convert_weights.main([sources["pth"], str(tmp_path / "x.bin")])


# ---------------------------------------------------------------------------
# cli/eval_hf.py --local_file against the JAX CLI
# ---------------------------------------------------------------------------

HF_ARGV = ["--local_file", "hf/model.safetensors", "--config_json", "hf/config.json",
           "--input_img", "low.png", "--alpha_s", "1.2", "--alpha_i", "0.9", "--gamma", "0.8"]


@pytest.fixture(scope="module")
def hf_tree(tmp_path_factory):
    """A tiny model's HF folder and a 21 x 37 image, and the JAX CLI's output
    for them (its Pallas kernels in interpret mode)."""
    tree = tmp_path_factory.mktemp("hf_tree")
    state, cfg = _state("base", seed=6, **TINY)
    checkpoint.save_pretrained(str(tree / "hf"), state, cfg)
    img = (np.random.default_rng(7).uniform(0, 0.4, (21, 37, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tree / "low.png")
    work = tmp_path_factory.mktemp("jax_hf")
    shutil.copytree(tree, work, dirs_exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_FORCE_INTERPRET", "1")
        mp.chdir(work)
        run_jax_cli("eval_hf.py", HF_ARGV)
    return tree, work / "output_hf" / "low.png"


def test_eval_hf_local_file_writes_what_the_jax_cli_writes(hf_tree, tmp_path, monkeypatch):
    tree, ref_path = hf_tree
    shutil.copytree(tree, tmp_path, dirs_exist_ok=True)
    monkeypatch.chdir(tmp_path)
    out = eval_hf.main([*HF_ARGV, "--cpu"])
    assert out == os.path.join("./output_hf", "low.png")
    got = png.read(out).astype(np.int16)
    ref = np.asarray(Image.open(ref_path).convert("RGB"))
    assert got.shape == ref.shape == (21, 37, 3)
    assert np.abs(got - ref).max() <= 1


def test_eval_hf_hub_arm_imports_huggingface_hub_only_in_its_branch(monkeypatch, tmp_path):
    """Without ``--local_file`` the CLI asks ``huggingface_hub`` for the files
    (which needs the network); the module imports it only there."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ImportError, match="huggingface_hub"):
        eval_hf.main(["--input_img", str(tmp_path / "x.png"), "--cpu"])
    assert "huggingface_hub" not in eval_hf.__dict__


def test_jax_params_to_torch_takes_jax_arrays():
    """The converter's inverse pair also takes what the JAX package holds
    (jax arrays), as ``save_checkpoint`` callers pass."""
    state, _ = _state(**TINY)
    params = {k: jnp.asarray(v) for k, v in torch_to_jax_params(state).items()}
    back = jax_params_to_torch(params)
    assert all(torch.equal(back[k], v) for k, v in state.items())
