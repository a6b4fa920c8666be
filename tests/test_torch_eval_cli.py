"""The PyTorch port's eval CLIs vs the JAX package's (CPU, fp32).

``eval --lol``, ``eval --unpaired --DICM``, ``eval_SID_blur --Blur`` on two
scenes and ``eval_tnsm`` write what the JAX CLIs write from the same folder
and weights, at full width as the CLIs run: the same files, each PNG within
one uint8 level (the forwards agree within 2e-5 and truncation may flip at a
level's boundary), and TNSM's ``loaded n/m tensors`` line. The route table
and the flag surface equal the JAX CLI's; ``--dp`` over several CUDA devices
gives a mesh of them. The module-scoped fixture runs each JAX CLI once, with the JAX
Pallas kernels in interpret mode (``PALLAS_FORCE_INTERPRET=1``).
"""

import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cli import eval as jax_eval_cli
from hvi_cidnet_torch.cli import eval as eval_cli
from hvi_cidnet_torch.cli import eval_SID_blur, eval_tnsm
from hvi_cidnet_torch.compat.checkpoint import export_pth, save_checkpoint, save_pretrained
from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
from _torch_port import one_torch_thread, run_jax_cli  # noqa: F401 (autouse)

def _folder(path, sizes, seed):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        img = (rng.uniform(0, 0.4, (h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(path, f"{i:02d}_{h}x{w}.png"))


# (port CLI, JAX CLI file, argv, output folder) of each case
CLI_CASES = {
    "lol": (eval_cli, "eval.py", ["--lol", "--variant", "base", "--weights", "w/base.pth"],
            "output/LOLv1"),
    "DICM": (eval_cli, "eval.py", ["--unpaired", "--DICM", "--variant", "base", "--weights",
                                   "w/base.npz", "--alpha", "0.9", "--gamma", "0.8"],
             "output/DICM"),
    "Blur": (eval_SID_blur, "eval_SID_blur.py", ["--Blur", "--weights", "w/hf/model.safetensors"],
             "output/LOL_Blur"),
    "tnsm": (eval_tnsm, "eval_tnsm.py", ["--unpaired", "--DICM", "--weights", "w/tnsm.npz"],
             "output/DICM"),
}


def _cli_tree(root: Path) -> None:
    """The CLIs' relative layout: ./datasets/... and the weights under ./w."""
    _folder(root / "datasets/LOLdataset/eval15/low", [(16, 24), (16, 24)], seed=7)
    _folder(root / "datasets/DICM", [(16, 24), (13, 21)], seed=8)
    for scene in ("0001", "0002"):
        _folder(root / "datasets/LOL_blur/test/low_blur" / scene, [(16, 24)] * 2,
                seed=int(scene))
    base = CIDNet(CIDNetConfig(), generator=torch.Generator().manual_seed(0)).state_dict()
    tnsm = CIDNet(CIDNetConfig(variant="tnsm"),
                  generator=torch.Generator().manual_seed(1)).state_dict()
    export_pth(str(root / "w/base.pth"), base)
    save_checkpoint(str(root / "w/base.npz"), base)
    save_pretrained(str(root / "w/hf"), base, CIDNetConfig())
    save_checkpoint(str(root / "w/tnsm.npz"), tnsm)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each case's JAX CLI run once in its own copy of the tree: its output
    folder and its stdout."""
    tree = tmp_path_factory.mktemp("cli_tree")
    _cli_tree(tree)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_FORCE_INTERPRET", "1")
        for case, (_, script, argv, folder) in CLI_CASES.items():
            work = tmp_path_factory.mktemp(f"jax_{case}")
            shutil.copytree(tree, work, dirs_exist_ok=True)
            mp.chdir(work)
            log = work / "stdout.txt"
            with open(log, "w") as f, pytest.MonkeyPatch.context() as mp2:
                mp2.setattr(sys, "stdout", f)
                run_jax_cli(script, argv)
            out[case] = (work / folder, log.read_text())
    return tree, out


def _files(folder: Path) -> list:
    return sorted(str(p.relative_to(folder)) for p in folder.rglob("*") if p.is_file())


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_eval_clis_write_what_the_jax_clis_write(cli_runs, case, tmp_path, monkeypatch, capsys):
    tree, ref = cli_runs
    port_cli, _, argv, folder = CLI_CASES[case]
    shutil.copytree(tree, tmp_path, dirs_exist_ok=True)
    monkeypatch.chdir(tmp_path)
    port_cli.main([*argv, "--cpu"])
    text = capsys.readouterr().out
    ref_folder, ref_text = ref[case]
    got_folder = tmp_path / folder
    assert _files(got_folder) == _files(ref_folder) != []
    for name in _files(ref_folder):
        got = png.read(str(got_folder / name)).astype(np.int16)
        want = np.asarray(Image.open(ref_folder / name).convert("RGB"))
        assert got.shape == want.shape and np.abs(got - want).max() <= 1, name
    if case == "tnsm":  # the shape-filtered load's count, as the JAX CLI prints it
        line = [s for s in ref_text.splitlines() if s.startswith("loaded ")]
        assert line and line[0] in text and "loaded 468/468 tensors" in line[0]
    if case in ("lol", "DICM"):
        assert "===> End evaluation (2 images)" in text and "===> End evaluation (2 images)" in ref_text


def test_eval_cli_routes_like_jax():
    """The route table (dataset folder, output folder, weights, alpha, pad)
    equals the JAX CLI's for every dataset flag, the deliberate
    ``--lol_v2_real`` default included."""
    cases = [["--lol"], ["--lol", "--perc"], ["--lol_v2_real"], ["--lol_v2_real", "--best_PSNR"],
             ["--lol_v2_real", "--best_GT_mean"], ["--lol_v2_real", "--best_SSIM"],
             ["--lol_v2_syn", "--perc"], ["--SICE_grad"], ["--SICE_mix"], ["--lmot"],
             ["--unpaired", "--VV", "--alpha", "0.7"], ["--unpaired", "--custome",
                                                        "--custome_path", "x"]]
    for argv in cases:
        got = eval_cli.route(eval_cli.parser().parse_args(argv))
        assert got == jax_eval_cli.route(jax_eval_cli.parser().parse_args(argv)), argv
    port_flags = {a.dest for a in eval_cli.parser()._actions} - {"cpu"}
    assert port_flags == {a.dest for a in jax_eval_cli.parser()._actions}
    with pytest.raises(SystemExit):
        eval_cli.route(eval_cli.parser().parse_args([]))


def test_dp_raises_on_several_cuda_devices_and_compile_cache_says_it_does_nothing(
        monkeypatch, capsys):
    """``--dp`` with two cards (the count monkeypatched) gives a mesh of
    both, which ``placement`` hands to ``Evaluator``; with one, a no-op."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = eval_cli.device_of(eval_cli.parser().parse_args(["--lol", "--dp"]))
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.axis_names == ("data",) and eval_cli.placement(mesh) == {"mesh": mesh}
    assert "dp serving: batch sharded over 2 devices" in capsys.readouterr().out
    assert eval_cli.device_of(eval_cli.parser().parse_args(["--lol", "--dp", "--cpu"])) == "cpu"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert eval_cli.device_of(eval_cli.parser().parse_args(
        ["--lol", "--dp", "--compile_cache", "d"])) == "cuda"
    out = capsys.readouterr().out
    assert "no-op" in out and "--compile_cache: no effect" in out
