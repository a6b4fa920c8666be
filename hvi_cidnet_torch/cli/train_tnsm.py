"""TNSM trainer: the counterpart of ``cli/train_tnsm.py`` (reference
train_tnsm.py).

    python -m hvi_cidnet_torch.cli.train_tnsm [the train CLI's flags]

``cli/train.py`` with ``--variant=tnsm`` added when no ``--variant`` is
given: the step adds the noise consistency + smoothing losses for the TNSM
graph (``train/trainer.py``, train_tnsm.py:68-72). From the command line
it starts one process per card as ``cli/train.py`` does (``train.launch``).
"""

from __future__ import annotations

import sys
from typing import Optional

from hvi_cidnet_torch.cli import train


def tnsm_argv(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--variant") for a in argv):
        argv.append("--variant=tnsm")
    return argv


def main(argv=None) -> Optional[dict]:
    return train.main(tnsm_argv(argv))


if __name__ == "__main__":
    train.launch(tnsm_argv())
