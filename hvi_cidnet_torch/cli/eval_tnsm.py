"""TNSM-variant batch inference — the counterpart of ``cli/eval_tnsm.py``
(reference eval_tnsm.py).

    python -m hvi_cidnet_torch.cli.eval_tnsm <cli/eval.py's flags>

``cli/eval.py``'s flags and routing with the TNSM graph and the
reference's shape-filtered, non-strict weight load (eval_tnsm.py:39-43):
the keys present with matching shapes are taken, every other tensor keeps
its init, drawn from a generator seeded 0; it prints ``loaded n/m
tensors``. ``--variant`` is ignored, as in the JAX CLI.
"""

from __future__ import annotations

import torch

from hvi_cidnet_torch.cli.eval import DTYPES, device_of, gates_of, parser, placement, route
from hvi_cidnet_torch.compat.jax_params import load_weights
from hvi_cidnet_torch.data.datasets import EvalDataset
from hvi_cidnet_torch.eval.evaluator import Evaluator
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig


def main(argv=None) -> int:
    ep = parser().parse_args(argv)
    where = device_of(ep)
    eval_dir, out, weights, alpha, pad = route(ep)
    if ep.weights:
        weights = ep.weights
    model = CIDNet(CIDNetConfig(variant="tnsm"), generator=torch.Generator().manual_seed(0))
    load_weights(model, weights, strict=False)  # prints "loaded n/m tensors from ..."
    ev = Evaluator(model, None, gates_of(ep, alpha), gamma=ep.gamma,
                   compute_dtype=DTYPES[ep.dtype], **placement(where))
    n = ev.run_dataset(EvalDataset(eval_dir, pad=pad), out)
    print(f"===> End evaluation ({n} images)")
    return n


if __name__ == "__main__":
    main()
