"""Weight converter — the counterpart of ``cli/convert_weights.py``.

    python -m hvi_cidnet_torch.cli.convert_weights SRC DST [--hf
        [--channels 36 36 72 144] [--heads 1 2 4 8] [--variant base|mssa|tnsm]]

SRC: a ``.pth``, ``.npz`` (a bare state dict or the JAX trainer's
checkpoint), ``.safetensors`` or an HF folder (``load_state_dict_file``;
an orbax tree raises). DST: ``.npz`` (the JAX trainer's checkpoint,
``param::`` keys, HWIO), ``.pth`` (the reference's state dict) or, with
``--hf``, a folder with ``model.safetensors`` and ``config.json``.
"""

from __future__ import annotations

import argparse

from hvi_cidnet_torch.compat.checkpoint import export_pth, save_checkpoint, save_pretrained
from hvi_cidnet_torch.compat.jax_params import load_state_dict_file
from hvi_cidnet_torch.models.cidnet import VARIANTS, CIDNetConfig


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="convert weights between formats")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--hf", action="store_true",
                   help="write dst as an HF folder (model.safetensors + config.json)")
    p.add_argument("--channels", type=int, nargs=4, default=(36, 36, 72, 144),
                   help="config.json channels (HF export)")
    p.add_argument("--heads", type=int, nargs=4, default=(1, 2, 4, 8),
                   help="config.json heads (HF export)")
    p.add_argument("--variant", choices=VARIANTS, default="base",
                   help="model variant recorded in config.json (HF export)")
    return p


def main(argv=None) -> str:
    args = parser().parse_args(argv)
    state = load_state_dict_file(args.src)
    print(f"loaded {len(state)} tensors from {args.src}")
    if args.hf:
        cfg = CIDNetConfig(variant=args.variant, channels=tuple(args.channels),
                           heads=tuple(args.heads))
        save_pretrained(args.dst, state, cfg)
    elif args.dst.endswith(".npz"):
        save_checkpoint(args.dst, state)
    elif args.dst.endswith(".pth"):
        export_pth(args.dst, state)
    else:
        raise SystemExit("dst must end in .npz or .pth (or pass --hf for a folder)")
    print(f"wrote {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
