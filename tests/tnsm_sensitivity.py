#!/usr/bin/env python3
"""How far last-bit changes move the full-width forward, per variant, on the
CPU: the measurement behind ``chip_smoke.py``'s TNSM tolerances.

    JAX_PLATFORMS=cpu python tests/tnsm_sensitivity.py [--sizes 96x144 192x288]

For each variant (base, TNSM) and image size, with the port's weights drawn
from a generator seeded 0 and an input drawn with numpy from seed 0, it
prints the max and mean absolute difference of the RGB output between:

* the JAX package's fp32 forward (XLA on the CPU) and the port's fp32
  forward (PyTorch on the CPU): two fp32 implementations that sum in other
  orders, as the card and the CPU do;
* the port's fp32 forward on the input and on the input with every value
  moved by one fp32 ulp (random sign): the output's sensitivity to a
  last-bit change at the start of the graph;
* the port's bf16 forward and its fp32 forward; the JAX package's bf16
  forward and its fp32 forward (the reference's own bf16 gap); the port's
  bf16 forward and the JAX package's.

For TNSM it also prints, at each of the three K5 site shapes, what the
unnormalised attention meets in the port's fp32 forward: the largest raw
score (times the temperature), the gap between a row's two largest scores,
and how far K5's plain twin in fp32 lands from the same attention in
float64 on the same inputs (``--attention``); and how far the fused noise
map of the ``training=True`` forward moves between the two fp32
implementations.

It imports both packages, so it runs where JAX runs; it needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig  # noqa: E402
from hvi_cidnet_tpu.models.cidnet import cidnet_forward as jax_forward  # noqa: E402
from hvi_cidnet_torch.models import tnsm as port_tnsm  # noqa: E402
from hvi_cidnet_torch.models.cidnet import (  # noqa: E402
    CIDNet,
    CIDNetConfig,
    cast_conv_weights,
    cidnet_forward,
)


def rgb(out):
    return out[0] if isinstance(out, tuple) else out


def attention_f64(q, k, v, temperature, heads, w_proj):
    """The unnormalised, folded channel attention of ``ops/attention.py`` in
    float64, and the scores it softmaxes (B, C, C), masked to the heads."""
    b, c, hh, ww = q.shape
    cp = c // heads
    q64, k64, v64 = (t.reshape(b, c, hh * ww).double() for t in (q, k, v))
    scores = torch.bmm(q64, k64.transpose(1, 2))
    scores = scores * temperature.reshape(heads).double().repeat_interleave(cp)[None, :, None]
    head = torch.arange(c) // cp
    scores = scores.masked_fill(head[:, None] != head[None, :], float("-inf"))
    attn = torch.matmul(w_proj.reshape(c, c).double(), torch.softmax(scores, dim=-1))
    return torch.bmm(attn, v64).reshape(b, c, hh, ww), scores


def capture_attention(model, x) -> list:
    """(q, k, v, temperature, heads, w_proj) of each noise-aware attention
    call in one fp32 forward of ``model``."""
    calls = []
    original = port_tnsm.channel_attention

    def record(q, k, v, temperature, heads, **kw):
        calls.append((q, k, v, temperature.detach(), heads, kw["w_proj"].detach()))
        return original(q, k, v, temperature, heads, **kw)

    port_tnsm.channel_attention = record
    try:
        with torch.no_grad():
            cidnet_forward(model, x)
    finally:
        port_tnsm.channel_attention = original
    return calls


def attention_sites(model, x) -> list:
    from hvi_cidnet_torch.ops.attention import channel_attention

    rows, seen = [], set()
    for q, k, v, temp, heads, wp in capture_attention(model, x):
        if q.shape in seen:
            continue
        seen.add(q.shape)
        ref, scores = attention_f64(q, k, v, temp, heads, wp)
        twin = channel_attention(q, k, v, temp, heads, normalize_qk=False, w_proj=wp)
        top2 = scores.topk(2, dim=-1).values
        rows.append({"shape": list(q.shape), "heads": heads,
                     "max_abs_score": float(scores[torch.isfinite(scores)].abs().max()),
                     "min_top2_gap": float((top2[..., 0] - top2[..., 1]).min()),
                     "median_top2_gap": float((top2[..., 0] - top2[..., 1]).median()),
                     "twin_fp32_vs_f64": float((twin.double() - ref).abs().max()),
                     "max_abs_out": float(ref.abs().max())})
    return rows


def measure(variant: str, h: int, w: int, attention: bool) -> dict:
    model = CIDNet(CIDNetConfig(variant=variant), generator=torch.Generator().manual_seed(0)).eval()
    params = {k: jnp.asarray(v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4 else v.numpy())
              for k, v in model.state_dict().items()}
    x = np.random.default_rng(0).uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    cfg = JaxConfig(variant=variant)
    t0 = time.perf_counter()
    ref = np.asarray(rgb(jax.jit(lambda p, x: jax_forward(p, x, cfg))(params, jnp.asarray(x))))
    jax_s = time.perf_counter() - t0
    # bf16 as the JAX package serves it: conv weights in bf16, the rest fp32
    params_bf = {k: v.astype(jnp.bfloat16) if v.ndim == 4 else v for k, v in params.items()}
    ref_bf = np.asarray(rgb(jax.jit(lambda p, x: jax_forward(
        p, x, cfg, compute_dtype=jnp.bfloat16))(params_bf, jnp.asarray(x, jnp.bfloat16))),
        np.float32)
    flip = np.where(np.random.default_rng(1).random(x.shape) < 0.5, -1, 1).astype(np.float32)
    x_ulp = (x + flip * np.spacing(x)).astype(np.float32)
    with torch.no_grad():
        got = rgb(cidnet_forward(model, torch.from_numpy(x))).numpy()
        got_ulp = rgb(cidnet_forward(model, torch.from_numpy(x_ulp))).numpy()
        bf = cast_conv_weights(
            CIDNet(CIDNetConfig(variant=variant), generator=torch.Generator().manual_seed(0)),
            torch.bfloat16).eval()
        got_bf = rgb(cidnet_forward(bf, torch.from_numpy(x).to(torch.bfloat16),
                                    compute_dtype=torch.bfloat16)).float().numpy()

    def err(a, b):
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        return {"max": float(d.max()), "mean": float(d.mean())}

    extra = {}
    if variant == "tnsm":
        noise = np.asarray(jax.jit(lambda p, x: jax_forward(p, x, cfg, training=True)[1])(
            params, jnp.asarray(x)))
        with torch.no_grad():
            got_noise = cidnet_forward(model, torch.from_numpy(x), training=True)[1].numpy()
        extra["noise_jax_fp32_vs_port_fp32"] = err(got_noise, noise)
        if attention:
            extra["attention"] = attention_sites(model, torch.from_numpy(x))
    return {**extra, "variant": variant, "size": [h, w], "jax_fp32_vs_port_fp32": err(got, ref),
            "port_fp32_vs_one_ulp_input": err(got, got_ulp), "port_bf16_vs_fp32": err(got_bf, got),
            "jax_bf16_vs_jax_fp32": err(ref_bf, ref), "port_bf16_vs_jax_bf16": err(got_bf, ref_bf),
            "jax_fp32_seconds": jax_s}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", nargs="+", default=["96x144", "192x288", "288x432"])
    p.add_argument("--variants", nargs="+", default=["base", "tnsm"])
    p.add_argument("--attention", action="store_true",
                   help="TNSM: the K5 sites' scores and the twin's fp32 error")
    args = p.parse_args(argv)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    rows = []
    for size in args.sizes:
        h, w = (int(s) for s in size.split("x"))
        for variant in args.variants:
            rows.append(measure(variant, h, w, args.attention))
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
