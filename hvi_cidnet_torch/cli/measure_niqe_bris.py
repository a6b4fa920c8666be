"""Unpaired NIQE/BRISQUE CLI — the counterpart of ``cli/measure_niqe_bris.py``.

    python -m hvi_cidnet_torch.cli.measure_niqe_bris --DICM | --LIME |
        --MEF | --NPE | --VV | --im_dir GLOB [--brisque_model FILE]

Prints the average NIQE, then the average BRISQUE (nan, with the reason,
when no trained BRISQUE model is available: ``metrics/brisque.py``). Both
run on the host. The DICM, NPE and VV routes glob ``.jpg`` and LIME's
``.bmp``, which are read through PIL (absent on a machine without it: an
``ImportError`` names the file); MEF's ``.png`` needs no PIL.
"""

from __future__ import annotations

import argparse

from hvi_cidnet_torch.eval.measure import unpaired_metrics

# per-dataset extensions as the reference globs them (measure_niqe_bris.py:42-55)
ROUTES = {
    "DICM": "./output/DICM/*.jpg",
    "LIME": "./output/LIME/*.bmp",
    "MEF": "./output/MEF/*.png",
    "NPE": "./output/NPE/*.jpg",
    "VV": "./output/VV/*.jpg",
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Eval")
    for d in ROUTES:
        p.add_argument(f"--{d}", action="store_true")
    p.add_argument("--im_dir", type=str, default=None)
    p.add_argument("--brisque_model", type=str, default=None)
    return p


def main(argv=None):
    ep = parser().parse_args(argv)
    im_dir = ep.im_dir
    for name, glob_pat in ROUTES.items():
        if getattr(ep, name):
            im_dir = glob_pat
    if im_dir is None:
        raise SystemExit("choose --DICM/--LIME/--MEF/--NPE/--VV or pass --im_dir")

    avg_niqe, avg_brisque = unpaired_metrics(im_dir, brisque_model=ep.brisque_model)
    print(avg_niqe)
    print(avg_brisque)
    return avg_niqe, avg_brisque


if __name__ == "__main__":
    main()
