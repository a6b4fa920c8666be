"""Weights for the PyTorch port: the shape-filtered non-strict load, the
safetensors reader, HF folders, and serving TNSM, vs the JAX package (CPU).

* The non-strict load takes exactly the keys JAX ``filtered_update(...,
  strict=False)`` takes; the port's and JAX's inits draw from other RNGs,
  so the tests compare which keys were taken and the values taken, never
  the fresh values left in place.
* The port's own safetensors reader (the machine with the card has no
  ``safetensors`` package) gives the bits ``safetensors.numpy.load_file``
  gives, and raises on a truncated file or a dtype it does not take.
* An HF folder from JAX ``save_pretrained`` loads with its config.
* ``Enhancer`` serving TNSM matches the JAX ``Evaluator`` at 2e-5 (fp32).
"""

import json
import os

import ml_dtypes
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save_file as st_save_file

from hvi_cidnet_tpu.compat.torch_ckpt import filtered_update, from_torch_state_dict
from hvi_cidnet_tpu.eval.evaluator import Evaluator
from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import HVIGates as JaxGates
from hvi_cidnet_tpu.models.cidnet import init_cidnet
from hvi_cidnet_tpu.train.checkpoint import save_pretrained
from hvi_cidnet_tpu.utils.hf_config import config_from_hf_json as jax_config_from_hf_json
from hvi_cidnet_torch.cli import demo, net_test
from hvi_cidnet_torch.compat import safetensors_io
from hvi_cidnet_torch.compat.jax_params import filtered_keys, load_state_dict_file, load_weights
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates
from hvi_cidnet_torch.serve import Enhancer
from hvi_cidnet_torch.utils.hf_config import config_from_hf_json
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
TNSM = dict(variant="tnsm", **TINY)
GATES = dict(gated=True, gated2=True, alpha=0.9, alpha_s=1.2)
SENTINEL = -7.0  # no drawn or constant parameter takes it


def _model(seed, **cfg) -> CIDNet:
    return CIDNet(CIDNetConfig(**cfg), generator=torch.Generator().manual_seed(seed))


def _jax_params(model: CIDNet) -> dict:
    return {k: jnp.asarray(v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4 else v.numpy())
            for k, v in model.state_dict().items()}


def _jax_taken(config: dict, state: dict) -> set:
    """The keys JAX ``filtered_update(strict=False)`` takes from the
    reference-layout ``state`` into a fresh ``init_cidnet(config)``."""
    shapes = jax.eval_shape(lambda: init_cidnet(jax.random.PRNGKey(0), JaxConfig(**config)))
    params = {k: jnp.full(s.shape, SENTINEL, s.dtype) for k, s in shapes.items()}
    merged = filtered_update(params, from_torch_state_dict(state), strict=False)
    return {k for k, v in merged.items() if not np.all(np.asarray(v) == SENTINEL)}


def _check_load(model: CIDNet, fresh: dict, state: dict, taken: set) -> None:
    for k, v in model.state_dict().items():
        want = torch.as_tensor(state[k]) if k in taken else fresh[k]
        assert torch.equal(v, want), k


@pytest.mark.parametrize("case", ["base_into_tnsm", "one_misshapen_key"])
def test_non_strict_load_takes_the_keys_jax_takes(tmp_path, case, capsys):
    src = _model(31, **(TINY if case == "base_into_tnsm" else TNSM))
    state = {k: v.numpy() for k, v in src.state_dict().items()}
    if case == "one_misshapen_key":
        state["HV_TNSM3.tnsm.noise_attention.temperature"] = np.ones((3, 1, 1), np.float32)
        state["unknown.weight"] = np.ones((2, 2, 3, 3), np.float32)
    path = str(tmp_path / "w.npz")
    np.savez(path, **state)

    model = _model(32, **TNSM)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    load_weights(model, path, strict=False)
    taken = _jax_taken(TNSM, state)
    assert set(filtered_keys(fresh, load_state_dict_file(path))) == taken
    _check_load(model, fresh, state, taken)
    if case == "base_into_tnsm":  # every base tensor, none of TNSM's
        assert taken == set(src.state_dict())
    else:
        assert taken == set(fresh) - {"HV_TNSM3.tnsm.noise_attention.temperature"}
    assert f"loaded {len(taken)}/{len(fresh)} tensors from {path}" in capsys.readouterr().out
    with pytest.raises((KeyError, ValueError), match="strict load failed"):
        load_weights(_model(32, **TNSM), path)  # strict stays the default


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "F64"])
def test_safetensors_reader_equals_the_package(tmp_path, dtype):
    np_dtype = {"F32": np.float32, "F16": np.float16, "BF16": ml_dtypes.bfloat16,
                "F64": np.float64}[dtype]
    rng = np.random.default_rng(0)
    arrays = {"a.weight": rng.standard_normal((4, 3, 3, 3)), "b": rng.standard_normal((5,)),
              "c.scalar": np.asarray(2.5), "d.empty": np.zeros((0, 3))}
    arrays = {k: v.astype(np_dtype) for k, v in arrays.items()}
    path = str(tmp_path / "t.safetensors")
    st_save_file(arrays, path, metadata={"format": "pt"})
    ref = st_load_file(path)
    got = safetensors_io.load_file(path)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == safetensors_io.DTYPES[dtype]
        as_bytes = got[k].reshape(-1).view(torch.uint8).numpy().tobytes()
        assert as_bytes == np.ascontiguousarray(v).tobytes(), k


def test_safetensors_reader_raises_on_bad_files(tmp_path):
    path = str(tmp_path / "ok.safetensors")
    st_save_file({"a": np.arange(12, dtype=np.float32).reshape(3, 4)}, path)
    raw = open(path, "rb").read()
    cases = {
        "truncated": raw[:-4],
        "header_past_end": (10**6).to_bytes(8, "little") + raw[8:],
        "too_short": raw[:5],
    }
    for name, data in cases.items():
        (tmp_path / f"{name}.safetensors").write_bytes(data)
        with pytest.raises(ValueError):
            safetensors_io.load_file(str(tmp_path / f"{name}.safetensors"))
    ints = str(tmp_path / "ints.safetensors")
    st_save_file({"a": np.arange(4, dtype=np.int32)}, ints)
    with pytest.raises(ValueError, match="dtype 'I32'"):
        safetensors_io.load_file(ints)
    with pytest.raises(ValueError, match="does not fit"):
        header = json.dumps({"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}).encode()
        (tmp_path / "short_entry.safetensors").write_bytes(
            len(header).to_bytes(8, "little") + header + bytes(8))
        safetensors_io.load_file(str(tmp_path / "short_entry.safetensors"))


@pytest.mark.parametrize("cfg", [TNSM, TINY, dict(variant="mssa", norm=True, **TINY)],
                         ids=["tnsm", "base", "mssa_norm"])
def test_hf_folder_loads_with_its_config(tmp_path, cfg):
    model = _model(41, **cfg)
    folder = save_pretrained(str(tmp_path / "hf"), _jax_params(model), JaxConfig(**cfg))
    config_json = os.path.join(folder, "config.json")
    want = jax_config_from_hf_json(config_json)
    got = config_from_hf_json(config_json)
    assert got == CIDNetConfig(**cfg)
    assert (got.channels, got.heads, got.norm, got.variant) == (
        want.channels, want.heads, want.norm, want.variant)
    state = load_state_dict_file(folder)
    assert set(state) == set(model.state_dict())
    en = Enhancer(folder, device="cpu")  # the config from config.json
    assert en.config == CIDNetConfig(**cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v) and torch.equal(en.model.state_dict()[k], v), k


def test_hf_config_defaults_and_errors(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"channels": [8, 8, 16, 32], "heads": [1, 2, 4, 8]}))
    assert config_from_hf_json(str(path)) == CIDNetConfig(**TINY)  # no variant: base
    assert config_from_hf_json(None) == CIDNetConfig()
    path.write_text(json.dumps({"variant": "foo"}))
    with pytest.raises(ValueError, match="variant"):
        config_from_hf_json(str(path))
    with pytest.raises(ValueError, match="variant"):
        jax_config_from_hf_json(str(path))


def test_orbax_tree_and_empty_folder_raise(tmp_path):
    (tmp_path / "orbax" / "100").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        load_state_dict_file(str(tmp_path / "orbax"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="neither an HF export"):
        load_state_dict_file(str(tmp_path / "empty"))


@pytest.fixture(scope="module")
def tnsm_pair():
    model = _model(51, **TNSM)
    ev = Evaluator(_jax_params(model), JaxConfig(**TNSM), JaxGates(**GATES), gamma=0.8)
    en = Enhancer(model, HVIGates(**GATES), gamma=0.8, device="cpu")
    return ev, en


def test_tnsm_enhance_matches_jax_evaluator(tnsm_pair):
    ev, en = tnsm_pair
    img = np.random.default_rng(0).uniform(0, 1, (21, 27, 3)).astype(np.float32)
    got = en.enhance(img)
    assert got.shape == (21, 27, 3) and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, ev.enhance(img), atol=2e-5, rtol=0)


def test_tnsm_enhance_batch_matches_jax_evaluator(tnsm_pair):
    ev, en = tnsm_pair
    imgs = np.random.default_rng(1).uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(en.enhance_batch(imgs), ev.enhance_batch(imgs), atol=2e-5, rtol=0)


def test_tnsm_enhancer_loads_a_base_file_non_strict(tmp_path, capsys):
    """A TNSM Enhancer on a base model's file takes the base tensors and
    keeps its seeded TNSM init, as the TNSM evaluator does; strict=True
    refuses the same file."""
    base = _model(61, **TINY)
    path = str(tmp_path / "base.npz")
    np.savez(path, **{k: v.numpy() for k, v in base.state_dict().items()})
    en = Enhancer(path, config=CIDNetConfig(**TNSM), device="cpu")
    fresh = _model(0, **TNSM).state_dict()  # the Enhancer's init: a generator seeded 0
    for k, v in en.model.state_dict().items():
        assert torch.equal(v, base.state_dict()[k] if k in base.state_dict() else fresh[k]), k
    assert "shape-filtered, non-strict" in capsys.readouterr().out
    with pytest.raises(KeyError, match="missing"):
        Enhancer(path, config=CIDNetConfig(**TNSM), strict=True, device="cpu")


def test_demo_cli_tnsm_random_init_on_cpu(tmp_path):
    src = tmp_path / "low.png"
    rgb = (np.random.default_rng(3).uniform(0, 0.3, (13, 21, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(src)
    out = demo.main(["--input", str(src), "--output_dir", str(tmp_path / "out"),
                     "--random_init", "--cpu", "--variant", "tnsm"])
    with Image.open(out) as im:
        assert im.size == (21, 13) and im.mode == "RGB"


def test_demo_cli_on_an_hf_folder(tmp_path):
    """``demo --weight FOLDER`` takes the folder's config.json (TNSM here,
    though ``--variant`` says base) and writes what the model gives."""
    model = _model(71, **TNSM)
    folder = save_pretrained(str(tmp_path / "hf"), _jax_params(model), JaxConfig(**TNSM))
    src = tmp_path / "low.png"
    rgb = (np.random.default_rng(4).uniform(0, 0.3, (16, 24, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(src)
    out = demo.main(["--input", str(src), "--output_dir", str(tmp_path / "out"), "--cpu",
                     "--weight", folder])
    en = Enhancer(model, HVIGates(gated=True, gated2=True, alpha_s=1.0), device="cpu")
    want = (np.clip(en.enhance(np.asarray(rgb, np.float32) / 255.0), 0, 1) * 255.0).astype(np.uint8)
    with Image.open(out) as im:
        assert np.array_equal(np.asarray(im), want)


def test_net_test_cli_tnsm_on_cpu(capsys):
    res = net_test.main(["--cpu", "--size", "32", "--iters", "1", "--variant", "tnsm"])
    assert res["n_params"] == 3_072_653 and "n_paras: 2.930M" in capsys.readouterr().out
    assert res["out_shape"] == (1, 32, 32, 3)
