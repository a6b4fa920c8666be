"""Device time per call of K3 (bilinear x0.5 + PReLU), K1 (RGB -> HVI), K2
(HVI -> RGB) and the relayout (P7, P8/P9/P11, P12/P13, P14) at the 600 x
400 base forward's shapes; with ``--fused``,
of the fused block route's kernels P2/P3, P4 and P5 instead; with
``--probe``, of the probe route's P1, P6 and P10/P15.

    python -m hvi_cidnet_torch.cli.kernel_times [--batch 8 1] [--fused | --probe]
        [--out FILE.json]

Runs on the card. For K3 at NormDownsample's three sites (36 x 400 x 600,
72 x 200 x 300, 144 x 100 x 150 per image), K1 at 400 x 600 x 3 and K2 at
3 x 400 x 600, per batch, in bf16 and fp32 (K1 from and to the same type,
as the forward calls it), it prints the kernel's device time per call from
a CUDA graph of GRAPH_CALLS launches (no host work between them: at batch 1
the wrapper's host work otherwise sets the pace), its time through the
wrapper from CUDA events, its bytes bound (each input read once, each
output written once, over 3.35 TB/s), and its agreement with the plain twin
(bitwise equal, else the max error). The relayout rows: the HWCB contract's
entry (P14 on (H W, 3, B)) and exit (P11 on K2's output as (B, 1, 3 H W)),
and, at level 1 ((60000, 36, B)), P8, P7 at steps 3 and P12 in blocks of
1000 rows, each through its dispatcher beside its plain version (one
``permute(...).contiguous()``).

With ``--fused``: P2/P3 (LayerNorm + IEL + residual) at the three LCA
levels, P4 at the stems, heads and NormUpsample convs, P5 at the three
NormDownsample sites, each beside what the unfused route runs in its place,
timed the same way (P2/P3: K6, the 1x1 convs, 2 x K7, the product; P4:
``F.conv2d``, cuDNN; P5: cuDNN's conv and K3).

With ``--probe``: P1 at the three LCA levels' CAB sites and P10/P15 at
TNSM's, each alone, then the route's whole site (P1 and the 1x1
``project_out``; P10/P15, the temperature, softmax, value product and
``project_out``) beside K5 with the fold, which the default route runs
there; P6 at the 16 dense 3x3 convs, alone on the staged operand, then the
route's conv (``F.unfold`` and P6) beside cuDNN's (after the replication
pad at the stems and heads).

It uses only the kernels' wrappers and twins, so another checkout (a
parent commit unpacked with ``git archive``) is timed by running this file
with that checkout first on the path, in turns with this one on one card:

    PYTHONPATH=build/parent python hvi_cidnet_torch/cli/kernel_times.py
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import hvi_cidnet_torch
from hvi_cidnet_torch.ops import hvi_cuda, relayout, relayout_cuda, resize_cuda, routes
from hvi_cidnet_torch.ops.conv import conv3x3_same

H, W = 400, 600
K3_SITES = (("block1", 36, H, W), ("block2", 72, H // 2, W // 2), ("block3", 144, H // 4, W // 4))
HBM_BYTES_PER_S = 3.35e12
GRAPH_CALLS = 20
REPLAYS = 5
K = 0.2        # density_k at init
ALPHA = 0.25   # a PReLU slope


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="time K3, K1, K2 and the relayout per call on "
                                "the card")
    p.add_argument("--batch", type=int, nargs="+", default=[8, 1])
    p.add_argument("--out", type=str, default="")
    routes.add_flags(p)  # --fused / --probe: time that route's kernels
    return p.parse_args(argv)


def graph_ms(fn) -> float:
    """Device time per call of ``fn`` from a CUDA graph of GRAPH_CALLS calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture: builds, caches
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (REPLAYS * GRAPH_CALLS)


def wrapper_ms(fn, iters: int = 50) -> float:
    """Time per call through the wrapper, host work included (CUDA events)."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(name: str, kernel, plain, x: torch.Tensor, bytes_moved: int, **info) -> dict:
    got, ref = kernel(), plain()
    row = {"kernel": name, **info, "dtype": str(x.dtype).removeprefix("torch."),
           "shape": list(x.shape), "bitwise": bool(torch.equal(got, ref)),
           "max_abs_err": (got.float() - ref.float()).abs().max().item(),
           "graph_ms": graph_ms(kernel), "wrapper_ms": wrapper_ms(kernel),
           "bound_ms": 1e3 * bytes_moved / HBM_BYTES_PER_S}
    print(f"{name} {info} {row['dtype']} {tuple(x.shape)}: {1e3 * row['graph_ms']:.2f} us a call "
          f"(graph), {1e3 * row['wrapper_ms']:.2f} us through the wrapper, bound "
          f"{1e3 * row['bound_ms']:.2f} us; bitwise {row['bitwise']}, max err "
          f"{row['max_abs_err']:.3e}", flush=True)
    return row


# (site, C_in, C_out, h, w, pad) of P4 and P5 at 600 x 400, and P2/P3's
# (level, C, h, w)
P4_SITES = (("stem_hv", 3, 36, H, W, "edge"), ("stem_i", 1, 36, H, W, "edge"),
            ("head_hv", 36, 2, H, W, "edge"), ("head_i", 36, 1, H, W, "edge"),
            ("up3", 144, 72, H // 8, W // 8, "zero"), ("up2", 72, 36, H // 4, W // 4, "zero"),
            ("up1", 36, 36, H // 2, W // 2, "zero"))
P5_SITES = (("block1", 36, 36, H, W), ("block2", 36, 72, H // 2, W // 2),
            ("block3", 72, 144, H // 4, W // 4))
LN_IEL_SITES = ((1, 36, H // 2, W // 2), (2, 72, H // 4, W // 4), (3, 144, H // 8, W // 8))


def measure_fused(name, kernel, unfused, x, **info) -> dict:
    """A fused kernel's device time per call beside the unfused route's ops
    in its place (both from CUDA graphs), and their max difference."""
    got, ref = kernel(), unfused()
    row = {"kernel": name, **info, "dtype": str(x.dtype).removeprefix("torch."),
           "shape": list(x.shape),
           "max_abs_diff_to_unfused": (got.float() - ref.float()).abs().max().item(),
           "graph_ms": graph_ms(kernel), "wrapper_ms": wrapper_ms(kernel),
           "unfused_graph_ms": graph_ms(unfused)}
    print(f"{name} {info} {row['dtype']} {tuple(x.shape)}: {1e3 * row['graph_ms']:.2f} us a call "
          f"(graph), {1e3 * row['wrapper_ms']:.2f} us through the wrapper; unfused "
          f"{1e3 * row['unfused_graph_ms']:.2f} us; max diff {row['max_abs_diff_to_unfused']:.3e}",
          flush=True)
    return row


def fused_rows(dev, gen, batches) -> list:
    from hvi_cidnet_torch.models.layers import IEL, LayerNorm
    from hvi_cidnet_torch.ops import conv3x3_cuda

    def rnd(shape, lo, hi, dt):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev, dt)

    rows = []
    alpha = torch.full((1,), ALPHA, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        for b in batches:
            for level, c, h, w in LN_IEL_SITES:
                iel, norm = IEL(c), LayerNorm(c)
                with torch.no_grad():
                    for p in iel.parameters():  # U(+-1/sqrt(fan_in)), as the model's init
                        bound = p[0].numel() ** -0.5
                        p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)
                iel, norm = iel.to(dev, dt), norm.to(dev)
                x = rnd((b, c, h, w), -2.0, 2.0, dt)
                with torch.no_grad():
                    rows.append(measure_fused(
                        "P2/P3", lambda: iel.fused(x, norm, True), lambda: x + iel(norm(x)), x,
                        level=level, batch=b))
            for site, cin, cout, h, w, pad in P4_SITES:
                x = rnd((b, cin, h, w), -1.0, 1.0, dt)
                wt = rnd((cout, cin, 3, 3), -cin**-0.5 / 3, cin**-0.5 / 3, dt)
                rows.append(measure_fused(
                    "P4", lambda: conv3x3_cuda.conv3x3_kernel(x, wt, pad),
                    lambda: conv3x3_cuda.conv3x3_plain(x, wt, pad), x, site=site, batch=b))
            for site, cin, cout, h, w in P5_SITES:
                x = rnd((b, cin, h, w), -1.0, 1.0, dt)
                wt = rnd((cout, cin, 3, 3), -cin**-0.5 / 3, cin**-0.5 / 3, dt)
                rows.append(measure_fused(
                    "P5", lambda: conv3x3_cuda.conv3x3_half_prelu_kernel(x, wt, alpha),
                    lambda: resize_cuda.half_prelu(conv3x3_same(x, wt), alpha), x, site=site,
                    batch=b))
    return rows


# (level, C, heads, h, w) of the attention sites (CAB and TNSM) at 600 x 400
ATTENTION_SITES = ((1, 36, 2, H // 2, W // 2), (2, 72, 4, H // 4, W // 4),
                   (3, 144, 8, H // 8, W // 8))


def measure_probe(name, kernel, route, default, x, **info) -> dict:
    """A probe kernel's device time per call, the route's whole site and
    the default route's op there (all from CUDA graphs), and the largest
    difference of the two sites' outputs."""
    got, ref = route(), default()
    row = {"kernel": name, **info, "dtype": str(x.dtype).removeprefix("torch."),
           "shape": list(x.shape),
           "max_abs_diff_to_default": (got.float() - ref.float()).abs().max().item(),
           "graph_ms": graph_ms(kernel), "wrapper_ms": wrapper_ms(kernel),
           "route_graph_ms": graph_ms(route), "default_graph_ms": graph_ms(default)}
    print(f"{name} {info} {row['dtype']} {tuple(x.shape)}: {1e3 * row['graph_ms']:.2f} us a call "
          f"(graph), {1e3 * row['wrapper_ms']:.2f} us through the wrapper; the route's site "
          f"{1e3 * row['route_graph_ms']:.2f} us, the default route's "
          f"{1e3 * row['default_graph_ms']:.2f} us; max diff {row['max_abs_diff_to_default']:.3e}",
          flush=True)
    return row


def probe_rows(dev, gen, batches) -> list:
    import torch.nn.functional as F

    from hvi_cidnet_torch.models.layers import heads_view
    from hvi_cidnet_torch.ops import attention_cuda, batched_qk_cuda, head_attention_cuda
    from hvi_cidnet_torch.ops import im2col_cuda
    from hvi_cidnet_torch.ops.conv import conv1x1

    def rnd(shape, lo, hi, dt):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev, dt)

    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for b in batches:
            for level, c, heads, h, w in ATTENTION_SITES:
                q, k, v = (rnd((b, c, h, w), -1.0, 1.0, dt) for _ in range(3))
                temp = rnd((heads, 1, 1), 1.0, 2.0, torch.float32)
                wp = rnd((c, c, 1, 1), -c**-0.5, c**-0.5, dt)
                qh, kh, vh = (heads_view(t, heads) for t in (q, k, v))
                temps = temp.reshape(heads)

                def p1_site():
                    out = head_attention_cuda.head_attention_kernel(qh, kh, vh, temps)
                    return conv1x1(out.view(q.shape), wp)

                def qk_site():
                    s = batched_qk_cuda.batched_qk_kernel(qh, kh).view(b, heads, c // heads, -1)
                    attn = torch.softmax(s * temp, dim=-1).to(dt).flatten(0, 1)
                    return conv1x1(torch.bmm(attn, vh).view(q.shape), wp)

                rows.append(measure_probe(
                    "P1", lambda: head_attention_cuda.head_attention_kernel(qh, kh, vh, temps),
                    p1_site, lambda: attention_cuda.channel_attention_kernel(
                        q, k, v, temp, heads, w_proj=wp), q, level=level, batch=b))
                rows.append(measure_probe(
                    "P10/P15", lambda: batched_qk_cuda.batched_qk_kernel(qh, kh), qk_site,
                    lambda: attention_cuda.channel_attention_kernel(
                        q, k, v, temp, heads, normalize_qk=False, w_proj=wp), q, level=level,
                    batch=b))
            for site, cin, cout, h, w, pad in P4_SITES + tuple(
                    (s, ci, co, h, w, "zero") for s, ci, co, h, w in P5_SITES):
                x = rnd((b, cin, h, w), -1.0, 1.0, dt)
                wt = rnd((cout, cin, 3, 3), -cin**-0.5 / 3, cin**-0.5 / 3, dt)
                a = im2col_cuda.stage_3x3(x, pad)
                wmat = wt.reshape(cout, cin * 9)
                rows.append(measure_probe(
                    "P6", lambda: im2col_cuda.im2col_dots_kernel(a, wmat),
                    lambda: im2col_cuda.conv3x3_im2col(x, wt, pad),
                    lambda: F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), wt)
                    if pad == "edge" else F.conv2d(x, wt, padding=1), x, site=site, batch=b))
                del a
    return rows


# (row, site, function, input shape at batch b, kwargs) of the relayout rows
RELAYOUT_SITES = (
    ("P14", "HWCB entry", "pack_blocked", lambda b: (H * W, 3, b), {"n_blk": H * W}),
    ("P8/P9/P11", "HWCB exit", "relayout_t2_rev", lambda b: (b, 1, 3 * H * W), {}),
    ("P8/P9/P11", "P8 level 1", "relayout_t3", lambda b: (60000, 36, b), {}),
    ("P7", "steps 3 level 1", "transpose_steps", lambda b: (60000, 36, b), {"steps": 3}),
    ("P12/P13", "P12 level 1", "t3_blocked", lambda b: (60000, 36, b), {"n_blk": 1000}),
)


def relayout_rows(dev, gen, dt, b) -> list:
    rows = []
    for name, site, fn, shape, kw in RELAYOUT_SITES:
        x = (torch.rand(shape(b), generator=gen) * 2 - 1).to(dev, dt)
        rows.append(measure(name, lambda: getattr(relayout_cuda, fn)(x, **kw),
                            lambda: getattr(relayout, fn)(x, **kw), x,
                            2 * x.numel() * x.element_size(), site=site, batch=b))
    return rows


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    if args.fused or args.probe:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rows = (fused_rows if args.fused else probe_rows)(dev, gen, args.batch)
        result = {"device": torch.cuda.get_device_name(0), "package": hvi_cidnet_torch.__file__,
                  "rows": rows}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return result
    alpha = torch.full((1,), ALPHA, device=dev)
    k = torch.full((1,), K, device=dev)
    result = {"device": torch.cuda.get_device_name(0), "package": hvi_cidnet_torch.__file__,
              "rows": []}
    print(f"{result['device']}: K3, K1, K2 and the relayout of {result['package']}")
    for dt in (torch.bfloat16, torch.float32):
        for b in args.batch:
            for site, c, h, w in K3_SITES:
                x = (torch.rand((b, c, h, w), generator=gen) * 2 - 1).to(dev, dt)
                result["rows"].append(measure(
                    "K3", lambda: resize_cuda.half_prelu_kernel(x, alpha),
                    lambda: resize_cuda.half_prelu_plain(x, alpha), x,
                    x.numel() * x.element_size() * 5 // 4, site=site, batch=b))
            img = torch.rand((b, H, W, 3), generator=gen).to(dev)
            rgb = img.to(dt)
            result["rows"].append(measure(
                "K1", lambda: hvi_cuda.rgb_to_hvi_kernel(rgb, k, dt),
                lambda: hvi_cuda.rgb_to_hvi_plain(rgb, k, dt), rgb,
                2 * rgb.numel() * rgb.element_size(), batch=b))
            hvi = hvi_cuda.rgb_to_hvi_plain(img, k, torch.float32)
            hvi = (hvi + 0.05 * torch.randn(hvi.shape, generator=gen).to(dev)).to(dt).contiguous()
            result["rows"].append(measure(
                "K2", lambda: hvi_cuda.hvi_to_rgb_kernel(hvi, k),
                lambda: hvi_cuda.hvi_to_rgb_plain(hvi, k), hvi,
                2 * hvi.numel() * hvi.element_size(), batch=b))
            result["rows"] += relayout_rows(dev, gen, dt, b)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
