"""Single-image inference from an HF-layout checkpoint — the counterpart of
``cli/eval_hf.py`` (reference eval_hf.py).

    python -m hvi_cidnet_torch.cli.eval_hf --input_img IMG
        (--local_file model.safetensors [--config_json config.json] | --path REPO_ID)
        [--alpha_s 1.0] [--alpha_i 1.0] [--gamma 1.0] [--cpu]

The model is ``CIDNet(**config.json)`` (defaults without one; the
reference model is a ``PyTorchModelHubMixin``, net/CIDNet.py:6-8), drawn
from a generator seeded 0 and loaded shape-filtered and non-strict; the
gates are ``alpha=alpha_i, alpha_s=alpha_s`` with both gate switches off,
as the JAX CLI sets them. Writes ``./output_hf/<name>``. Without
``--local_file`` the files come from the hub through ``huggingface_hub``,
which needs the network. Runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hvi_cidnet_torch.compat.jax_params import load_weights
from hvi_cidnet_torch.data.datasets import load_image, save_image
from hvi_cidnet_torch.data.transforms import to_float01
from hvi_cidnet_torch.eval.evaluator import Evaluator
from hvi_cidnet_torch.models.cidnet import CIDNet, HVIGates
from hvi_cidnet_torch.utils.hf_config import config_from_hf_json


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="EvalHF")
    p.add_argument("--path", type=str, default="Fediory/HVI-CIDNet-LOLv1-wperc",
                   help="HF repo id with model.safetensors")
    p.add_argument("--local_file", type=str, default=None,
                   help="local safetensors file (skips the hub download)")
    p.add_argument("--config_json", type=str, default=None,
                   help="local config.json (with --local_file); hub downloads use "
                        "the repo's config.json")
    p.add_argument("--input_img", type=str, required=True)
    p.add_argument("--alpha_s", type=float, default=1.0)
    p.add_argument("--alpha_i", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--compile_cache", type=str, default=None, metavar="DIR",
                   help="accepted for the JAX CLI's flag surface; does nothing here")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    return p


def main(argv=None) -> str:
    el = parser().parse_args(argv)
    config_file = el.config_json
    if el.local_file:
        model_file = el.local_file
    else:
        from huggingface_hub import hf_hub_download

        config_file = hf_hub_download(repo_id=el.path, filename="config.json", repo_type="model")
        model_file = hf_hub_download(repo_id=el.path, filename="model.safetensors", repo_type="model")
    model = CIDNet(config_from_hf_json(config_file), generator=torch.Generator().manual_seed(0))
    load_weights(model, model_file, strict=False)
    gates = HVIGates(gated=False, gated2=False, alpha=el.alpha_i, alpha_s=el.alpha_s)
    ev = Evaluator(model, None, gates, gamma=el.gamma, device="cpu" if el.cpu else "cuda")
    out = ev.enhance(to_float01(load_image(el.input_img)))
    os.makedirs("./output_hf", exist_ok=True)
    path = os.path.join("./output_hf", os.path.basename(el.input_img))
    save_image(path, (np.clip(out, 0, 1) * 255).astype(np.uint8))
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
