"""The port's train CLIs (``hvi_cidnet_torch/cli/train.py``,
``train_tnsm.py``) on the CPU, at full width and crop 32.

The flag surface and defaults equal the JAX parser's (``--cpu`` added);
``main(argv)`` trains on synthetic data for base and through
``train_tnsm.main``, resumes with ``--start_epoch`` (optimizer state
included), and trains a generated LMOT layout with the in-loop eval, once
with ``Evaluator.run_dataset`` stubbed out: the eval gets a copy of the
model, so the parameters after epoch 2 are the same and still fp32. The
dataset lengths of the other layouts, ``--multihost``'s error without a
coordinator, ``--ckpt_backend orbax``'s files and the report's rows are
checked too. Each run happens in ``tmp_path``
(the CLI writes ``./weights/train`` and ``--val_folder`` there).
"""

import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

from hvi_cidnet_tpu.utils.config import option as jax_option
from hvi_cidnet_torch.cli import train, train_tnsm
from hvi_cidnet_torch.compat.jax_params import torch_to_jax_params
from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.eval.evaluator import Evaluator
from hvi_cidnet_torch.train import checkpoint as ckpt
from hvi_cidnet_torch.utils.config import option
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

# fp32 (bf16 convs are slow on the CPU); the in-loop eval test keeps bf16
SMOKE = ["--cpu", "--synthetic_steps", "2", "--nEpochs", "2", "--snapshots", "1", "--batchSize",
         "2", "--cropSize", "32", "--threads", "2", "--seed", "1", "--start_warmup", "false",
         "--compute_dtype", "float32", "--allow_random_vgg", "true"]


def _actions(p):
    return {a.dest: a for a in p._actions if a.dest != "help"}


def test_flags_and_defaults_equal_the_jax_parser():
    ours, ref = _actions(option()), _actions(jax_option())
    assert set(ours) - set(ref) == {"cpu"} and set(ref) <= set(ours)
    for dest, a in ref.items():
        b = ours[dest]
        assert (b.option_strings, b.default, b.choices) == (a.option_strings, a.default, a.choices), dest
        assert (b.type.__name__ if b.type else None) == (a.type.__name__ if a.type else None), dest
    assert ours["cpu"].default is False


def test_synthetic_training_base(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    record = train.main(SMOKE + ["--variant", "base"])
    assert record["epochs"] == [1, 2] and all(len(x) == 2 for x in record["losses"])
    assert all(np.isfinite(x) for ep in record["losses"] for x in ep)
    assert sorted(os.listdir("weights/train")) == ["epoch_1.npz", "epoch_2.npz"]
    for name in ("test.png", "gt.png"):
        assert png.read(f"results/training/{name}").shape == (32, 32, 3)
    with open(record["report"]) as f:
        report = f.read()
    assert report.startswith("dataset: synthetic\nlr: 0.0001\nbatchSize: 2\ncropSize: 32\n")
    assert report.endswith("| Epochs | PSNR | SSIM | LPIPS |\n|---|---|---|---|\n")
    # the epoch-2 checkpoint holds 4 Adam steps and resumes
    model = record["model"]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    resumed = train.main(SMOKE + ["--variant", "base", "--start_epoch", "2", "--nEpochs", "1"])
    assert resumed["epochs"] == [3]
    leaves = np.load("weights/train/epoch_3.npz")
    assert int(leaves["opt::6"]) == 6 and int(leaves["meta::epoch"]) == 3


def test_train_tnsm_adds_the_variant(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    one = SMOKE[:-2] + ["--nEpochs", "1", "--synthetic_steps", "1", "--use_perceptual", "false"]
    record = train_tnsm.main(one)
    assert record["model"].config.variant == "tnsm"
    assert all(np.isfinite(x) for x in record["losses"][0])
    record = train_tnsm.main(one + ["--variant", "base"])
    assert record["model"].config.variant == "base"


def _lmot_tree(root):
    """4 training pairs (40 x 48) and 2 eval pairs (32 x 40), PNG."""
    rng = np.random.default_rng(0)
    for sub, n, (h, w) in (("train", 4, (40, 48)), ("val", 2, (32, 40))):
        for d in ("low", "high"):
            os.makedirs(f"{root}/{sub}/{d}")
        for i in range(n):
            high = rng.integers(60, 256, (h, w, 3)).astype(np.uint8)
            png.write(f"{root}/{sub}/high/{i}.png", high)
            png.write(f"{root}/{sub}/low/{i}.png", (high // 4).astype(np.uint8))


LMOT = ["--cpu", "--lmot", "true", "--nEpochs", "2", "--snapshots", "1", "--batchSize", "2",
        "--cropSize", "32", "--threads", "2", "--seed", "3", "--start_warmup", "false",
        "--use_perceptual", "false",
        "--data_train_lmot_low", "d/train/low", "--data_train_lmot_high", "d/train/high",
        "--data_val_lmot", "d/val/low", "--data_valgt_lmot", "d/val/high"]


def test_in_loop_eval_leaves_the_trained_model_alone(tmp_path, monkeypatch):
    """bf16 (the default dtype), so that an eval given the trained model
    itself would cast its conv weights to bf16 in place."""
    monkeypatch.chdir(tmp_path)
    _lmot_tree("d")
    record = train.main(LMOT)
    assert len(glob.glob("results/LMOT/*.png")) == 2
    assert all(p.dtype == torch.float32 for p in record["model"].parameters())
    with open(record["report"]) as f:
        rows = f.read().splitlines()[-2:]
    assert rows == [f"| {e} | {p:.4f} | {s:.4f} | n/a |" for e, p, s in
                    zip((1, 2), record["psnr"], record["ssim"])]
    evaluated = dict(np.load("weights/train/epoch_2.npz"))

    os.rename("weights", "weights_eval")
    monkeypatch.setattr(Evaluator, "run_dataset", lambda self, *a, **k: 0)
    train.main(LMOT)
    skipped = dict(np.load("weights/train/epoch_2.npz"))
    assert set(evaluated) == set(skipped)
    assert all(np.array_equal(evaluated[k], skipped[k]) for k in evaluated)


def test_dataset_lengths_of_the_layouts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    img = np.zeros((8, 8, 3), np.uint8)
    for folder in ("v1/low", "v1/high", "v2r/Low", "v2r/Normal", "v2s/Low", "v2s/Normal"):
        os.makedirs(folder)
        Image.fromarray(img).save(f"{folder}/0.png")
    opt = option().parse_args(["--data_train_lol_v1", "v1", "--data_train_lolv2_real", "v2r",
                               "--data_train_lolv2_syn", "v2s"])
    lengths = {name: len(train.build_train_dataset(opt, name)) for name in
               ("lol_v1", "lolv2_real", "lolv2_syn", "lol_blur", "SID", "SICE_mix")}
    assert lengths == {"lol_v1": 485, "lolv2_real": 685, "lolv2_syn": 900, "lol_blur": 10200,
                       "SID": 2099, "SICE_mix": 4803}


@pytest.mark.parametrize("flags", [["--multihost", "true"], ["--ckpt_backend", "orbax"]])
def test_flags_not_ported_raise(tmp_path, monkeypatch, flags):
    """Both flags are ported now: ``--multihost true`` with no coordinator
    and no launcher environment raises a clear error before training;
    ``--ckpt_backend orbax`` writes ``weights/train/orbax/<epoch>/
    checkpoint.npz`` in the background and no ``epoch_N.npz``."""
    monkeypatch.chdir(tmp_path)
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    if flags[0] == "--multihost":
        with pytest.raises(ValueError, match="no coordinator; pass --coordinator_address"):
            train.main(SMOKE + flags)
        assert not os.path.exists("weights")
        return
    record = train.main(SMOKE + flags + ["--use_perceptual", "false"])
    assert sorted(os.listdir("weights/train")) == ["orbax"]
    assert sorted(os.listdir("weights/train/orbax")) == ["1", "2"]
    assert ckpt.latest_epoch("weights/train") == 0
    leaves = np.load("weights/train/orbax/2/checkpoint.npz")
    assert int(leaves["opt::6"]) == 4 and int(leaves["meta::epoch"]) == 2
    saved = {k[len("param::"):]: leaves[k] for k in leaves.files if k.startswith("param::")}
    ours = torch_to_jax_params(record["model"].state_dict())
    assert set(saved) == set(ours) and all(np.array_equal(saved[k], ours[k]) for k in ours)


def test_no_cpu_fallback_without_a_card(tmp_path, monkeypatch):
    """Without --cpu the CLI trains on the card: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    monkeypatch.chdir(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        train.main([a for a in SMOKE if a != "--cpu"] + ["--variant", "base"])
    assert not os.path.exists("weights")


def test_checkpoint_names_latest_epoch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train.main(SMOKE + ["--variant", "base", "--nEpochs", "1", "--use_perceptual", "false"])
    assert ckpt.latest_epoch("weights/train") == 1
