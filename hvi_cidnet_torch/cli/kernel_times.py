"""Device time per call of K3 (bilinear x0.5 + PReLU), K1 (RGB -> HVI), K2
(HVI -> RGB) and the relayout (P7, P8/P9/P11, P12/P13, P14) at the 600 x
400 base forward's shapes; with ``--fused``,
of the fused block route's kernels P2/P3, P4 and P5 instead; with
``--probe``, of the probe route's P1, P6 and P10/P15.

    python -m hvi_cidnet_torch.cli.kernel_times [--batch 8 1] [--fused | --probe | --arms]
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
TNSM's HWCB noise map (P11 on (B, 3, H W)), and, at level 1 ((60000, 36, B)), P8, P7 at steps 3 and 1 and P12 in
blocks of 1000 rows, P14 in blocks of 1000 rows, and P11 at the three
LCA levels ((B, C, N)), each through its dispatcher beside its plain
version (one ``permute(...).contiguous()``); beside the warm graph, its
device time with L2 cold (``cold_graph_ms``: one graph over a ring of
distinct tensors past 100 MB) and its host time a call (``host_us``).

With ``--arms``: the relayout rows alone, and at each site each arm of
``csrc/relayout.cu`` that the site's shape lets run (the bulk arm, the
cp.async arm), launched through the C entry with that arm's plan and
timed warm and cold in alternating rounds, beside the arm the plan picks;
for a bulk plan with tensor maps, the host time of one
``cuTensorMapEncodeTiled`` (libcuda through ctypes, less a ctypes call of
``cuDriverGetVersion``) and of the wrapper's cached plan lookup.

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
import ctypes
import json
import math
import statistics
import sys
import time

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
    p.add_argument("--arms", action="store_true",
                   help="the relayout alone, each arm its shapes allow timed beside the plan's")
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


# bytes a ring of distinct inputs and outputs passes, so that each call of a
# cold-L2 graph finds its tensors evicted from the 50 MB L2
COLD_RING_BYTES = 100e6


def cold_graph_ms(fn, x: torch.Tensor) -> float:
    """Device time a call of ``fn(t)`` with L2 cold: one CUDA graph over a
    ring of distinct copies of ``x`` whose inputs and outputs pass
    COLD_RING_BYTES (the outputs kept alive through the capture, so each has
    its own memory), replayed; the time a call."""
    pairs = max(2, math.ceil(COLD_RING_BYTES / (2 * x.numel() * x.element_size())))
    ring = [x.clone() for _ in range(pairs)]
    for t in ring[:2]:
        fn(t)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(t) for t in ring]
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del outs, graph, ring
    return start.elapsed_time(end) / (REPLAYS * pairs)


def host_us(fn, calls: int = 200, rounds: int = 7) -> float:
    """Host time a call of ``fn`` (``time.perf_counter`` around ``calls``
    calls, the device not waited for inside a round): the median of
    ``rounds`` rounds."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


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
    ("P8/P9/P11", "TNSM noise map", "relayout_t2_rev", lambda b: (b, 3, H * W), {}),
    ("P8/P9/P11", "P8 level 1", "relayout_t3", lambda b: (60000, 36, b), {}),
    ("P7", "steps 3 level 1", "transpose_steps", lambda b: (60000, 36, b), {"steps": 3}),
    ("P12/P13", "P12 level 1", "t3_blocked", lambda b: (60000, 36, b), {"n_blk": 1000}),
    ("P8/P9/P11", "P11 level 1", "relayout_t2_rev", lambda b: (b, 36, 60000), {}),
    ("P8/P9/P11", "P11 level 2", "relayout_t2_rev", lambda b: (b, 72, 15000), {}),
    ("P8/P9/P11", "P11 level 3", "relayout_t2_rev", lambda b: (b, 144, 3750), {}),
    ("P7", "steps 1 level 1", "transpose_steps", lambda b: (60000, 36, b), {"steps": 1}),
    ("P14", "P14 level 1", "pack_blocked", lambda b: (60000, 36, b), {"n_blk": 1000}),
)
NAMES = {"transpose_steps": "P7", "relayout_t3": "P8", "relayout_t2_rev": "P11",
         "t3_blocked": "P12", "pack_blocked": "P14"}


def relayout_rows(dev, gen, dt, b, arms: bool = False) -> list:
    rows = []
    for name, site, fn, shape, kw in RELAYOUT_SITES:
        x = (torch.rand(shape(b), generator=gen) * 2 - 1).to(dev, dt)
        run = lambda t: getattr(relayout_cuda, fn)(t, **kw)
        row = measure(name, lambda: run(x), lambda: getattr(relayout, fn)(x, **kw), x,
                      2 * x.numel() * x.element_size(), site=site, batch=b)
        row["cold_ms"], row["host_us"] = cold_graph_ms(run, x), host_us(lambda: run(x))
        print(f"  L2 cold {1e3 * row['cold_ms']:.2f} us a call, host {row['host_us']:.2f} us a "
              "call", flush=True)
        if arms:
            geo = {k: v for k, v in kw.items() if k != "hwt"}
            row["arms"] = arm_times(x, *relayout_cuda.geometry(NAMES[fn], tuple(x.shape), **geo),
                                    lambda: getattr(relayout, fn)(x, **kw))
        rows.append(row)
        del x
    return rows


def arm_times(x: torch.Tensor, gxmy: tuple, out_shape: tuple, plain) -> dict:
    """Each arm of the relayout that (G, X, M, Y) lets run, launched through
    the C entry with that arm's plan: bitwise against ``plain``, device time
    warm and cold in alternating rounds (bulk, cp.async, cp.async, bulk),
    the plan's items, blocks and stages; for the bulk arm's tensor maps,
    the host time of their encode; the arm the plan picks."""
    rl, dev, e = relayout_cuda, x.device, x.element_size()
    sms = relayout_cuda.sm_count(dev)
    canon = rl.canonical(*gxmy)
    if canon[1] == 1:  # a copy: one arm
        return {}
    plans = {"bulk": rl.bulk_plan(*canon, e, sms), "cp.async": rl.async_plan(*canon, e, 0, 0, sms)}
    plans = {k: p for k, p in plans.items() if p is not None}
    ref = plain()

    def launcher(p):
        c = p.c_plan()

        def launch(t):
            out = torch.empty(out_shape, dtype=t.dtype, device=dev)
            rl.P7(dev, t.data_ptr(), out.data_ptr(), e, p.g, p.x, p.m, p.y, c)
            return out
        return launch

    res = {k: {"plan": p.name, "items": p.work, "blocks": p.blocks, "stages": p.stages,
               "bitwise": bool(torch.equal(launcher(p)(x), ref)), "ms": [], "cold_ms": []}
           for k, p in plans.items()}
    order = list(plans)
    for r in range(4):
        for k in order if r % 3 == 0 else order[::-1]:
            res[k]["ms"].append(graph_ms(lambda: launcher(plans[k])(x)))
            res[k]["cold_ms"].append(cold_graph_ms(launcher(plans[k]), x))
    picked = rl.relayout_plan(*gxmy, e, 0, 0, sms)
    res["picked"] = "bulk" if picked.arm == rl.BULK else "cp.async"
    if "bulk" in plans:
        res["bulk"]["encode_us"] = encode_us(plans["bulk"], e)
        res["lookup_us"] = host_us(lambda: rl._launch_args(gxmy, e, 0, 0, dev), calls=2000)
    for k in order:
        a = res[k]
        print(f"  {k} arm ({a['plan']}, {a['items']} items, {a['blocks']} blocks, "
              f"{a['stages']} stages): bitwise {a['bitwise']}, warm "
              + " / ".join(f"{1e3 * t:.2f}" for t in a["ms"]) + " us, cold "
              + " / ".join(f"{1e3 * t:.2f}" for t in a["cold_ms"]) + " us"
              + (f", encode {a['encode_us']:.2f} us a map" if a.get("encode_us") else ""),
              flush=True)
    print(f"  the plan picks {res['picked']}" + (f"; its lookup {res['lookup_us']:.3f} us"
                                                 if "lookup_us" in res else ""), flush=True)
    return res


def encode_us(p, itemsize: int, calls: int = 2000):
    """Host time of one ``cuTensorMapEncodeTiled`` as ``csrc/relayout.cu:
    encode_side`` calls it for the bulk plan ``p``'s first box side (libcuda
    through ctypes, less a ctypes call of ``cuDriverGetVersion``); None
    where the plan has no box side."""
    rl = relayout_cuda
    sides = [(p.in_box, p.x, p.y, p.tx, p.in_pr), (p.out_box, p.y, p.x, p.ty, p.out_pr)]
    sides = [sd for sd in sides if sd[0]]
    if not sides:
        return None
    box, a_ext, b_ext, ta, pr = sides[0]
    cuda = ctypes.CDLL("libcuda.so.1")
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    narrow = box == rl.NARROW_BOX
    dims = (u64 * 4)(b_ext, p.m, a_ext, p.g)
    strides = (u64 * 3)(b_ext * itemsize, p.m * b_ext * itemsize, a_ext * p.m * b_ext * itemsize)
    extent = (u32 * 4)((pr if narrow else rl.LINE) // itemsize, p.tmb,
                       min(ta, rl.BOX_ROWS) if narrow else ta, 1)
    unit = (u32 * 4)(1, 1, 1, 1)
    buf = torch.empty(p.g * a_ext * p.m * b_ext, dtype=torch.int16 if itemsize == 2 else
                      torch.int32, device="cuda")
    raw = ctypes.create_string_buffer(128 + 64)  # a CUtensorMap: 128 bytes, 64-byte aligned
    tmap = ctypes.c_void_p((ctypes.addressof(raw) + 63) // 64 * 64)
    args = (tmap, 1 if itemsize == 2 else 2, 4, ctypes.c_void_p(buf.data_ptr()), dims, strides,
            extent, unit, 0, 0 if narrow else 3, 3, 0)
    if cuda.cuTensorMapEncodeTiled(*args) != 0:
        return None
    version = ctypes.c_int()
    per_call = []
    for fn, a in ((cuda.cuTensorMapEncodeTiled, args), (cuda.cuDriverGetVersion,
                                                         (ctypes.byref(version),))):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*a)
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    return per_call[0] - per_call[1]


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
            if args.arms:
                result["rows"] += relayout_rows(dev, gen, dt, b, arms=True)
                continue
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
