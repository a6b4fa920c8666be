"""What bounds the bf16 kernels P4, P5, P6, P2/P3, P1 and P10/P15, and the
relayout in bf16 and fp32, on the card: each timed with one phase taken out.

    python -m hvi_cidnet_torch.cli.conv_phases [--out build/conv_phases]
        [--only relayout]

Runs on the card. Builds variants of ``csrc/conv3x3.cu``,
``csrc/im2col_gemm.cu``, ``csrc/ln_iel.cu``, ``csrc/head_attention.cu`` and
``csrc/batched_qk.cu`` (with their score core, ``csrc/qk_scores.cuh``) in
which one phase does no work, each into its own
library under ``--out`` with the kernels' flags, and times each variant
against the kernel as built from the unchanged source, at the sites of the
600 x 400 batch-8 forward, bf16, as device time per call from CUDA graphs
(``kernel_times.graph_ms``). A variant's output is wrong by design: only its
time is read. A phase whose removal saves little does not bound the kernel;
phases whose savings add up to the whole time run one after the other.

* P4 (the tensor-core arm at the stems and NormUpsamples, the CUDA-core arm
  at the heads): ``no_products`` (no mma.sync; the CUDA-core arm's fmaf
  products, and with them its window reads, gone), ``no_transpose`` (the
  staged rows not turned into the channel-minor tile), ``no_copies`` (no
  cp.async of x's rows), ``no_stores`` (no tile written out).
* P5 (its tensor-core arm, the variants of P4's source): ``no_products``,
  ``no_transpose``, ``no_copies`` as P4's, ``no_stores`` (no output written,
  and with it the x0.5 and the PReLU, dead code then).
* P6: ``no_products`` (no wgmma), ``no_copies`` (no TMA, bulk or cp.async
  copy of the operand or W; the barriers still complete), ``no_stores``.
* P2/P3 (its tensor-core arm, residual on): ``no_stage`` (x not read into
  A, no LayerNorm: A keeps what it held), ``no_expansion`` (no products of
  the expansion), ``no_dw1`` (no first depthwise conv), ``no_gates`` (no
  gate conv, tanh or product), ``no_tanh`` (the gate's conv itself in place
  of its tanh), ``no_project`` (no products of project_out), ``no_stores``
  (no output written). A phase taken out can change the values downstream
  (zeros after ``no_expansion``), and tanhf's time depends on its argument:
  read ``no_tanh`` beside ``no_gates``.
* P1 (its tensor-core arm): ``no_products`` (no mma.sync, scores, norms or
  apply; their ldmatrix loads go too), ``no_copies`` (no cp.async of q, k
  or v: the stages keep what they held), ``no_apply`` (no apply at all: v
  not copied, no products, nothing written), ``no_stores`` (the output
  tile not written out).
* P10/P15 (its tensor-core arm): ``no_products``, ``no_copies`` as P1's
  scores, ``no_stores`` (the cluster's sums not written out).
* The relayout (``csrc/relayout.cu``, every arm): ``no_loads`` (no bulk,
  box, cp.async or register load into shared memory; the bulk arm's
  barriers expect no bytes), ``no_transpose`` (no ldmatrix / stmatrix or shuffles; the
  cp.async arm stores zeros in place of the tile's columns), ``no_stores``
  (nothing written out), at the HWCB ends (batch 8 and 32), P8 and P11 at
  the three levels and P7 at steps 1 (batch 8).
At the attention sites the rows at level 3 (N = 3,750) are realigned; a
phase taken out can change the softmax's input, not its cost.

Beside them, half of a ``Tensor.clone`` of the site's input: one read of
its bytes. Prints a line a site and writes them as JSON under ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from hvi_cidnet_torch.cli.kernel_times import H, W, graph_ms
from hvi_cidnet_torch.ops import _build
from hvi_cidnet_torch.ops import batched_qk_cuda as bq
from hvi_cidnet_torch.ops import conv3x3_cuda as cc
from hvi_cidnet_torch.ops import head_attention_cuda as ha
from hvi_cidnet_torch.ops import im2col_cuda as icol
from hvi_cidnet_torch.ops import ln_iel_cuda as lc
from hvi_cidnet_torch.ops import relayout_cuda as rl

BATCH = 8
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the score core's phases (csrc/qk_scores.cuh), shared by P1 and P10/P15;
# without copies the stages' waits go too (bulk copies complete an mbarrier)
_NO_SCORE_PRODUCTS = [("qk_scores.cuh",
                       "    for (int kk = 16 * warp; kk < width; kk += 16 * kWarps) {",
                       "    for (int kk = 16 * warp; kk < 0; kk += 16 * kWarps) {")]
_NO_SCORE_COPIES = [
    ("qk_scores.cuh", "        bulk_stage(st, q, k, c, sm.rowbase, n0, stop, sm.bars + slot);", ""),
    ("qk_scores.cuh", "      mbar_wait(sm.bars + s % stages, (s / stages) & 1);", "      ;"),
    ("qk_scores.cuh", "        qs.issue(st, n0, stop, false);\n        ks.issue(",
     "        if (false) qs.issue(st, n0, stop, false);\n        if (false) ks.issue(")]
# (source, variant) -> the substitutions that take the phase out, in the
# source or, as (header, old, new), in a header beside it; each must apply,
# so a change to the sources that moves a phase fails here loudly
VARIANTS = {
    ("conv3x3.cu", "base"): [],
    ("conv3x3.cu", "no_products"): [
        ("    for (int tap = 0; tap < 9; ++tap) {\n      const int dy = tap / 3, dx = tap % 3, d",
         "    for (int tap = 0; tap < 0; ++tap) {\n      const int dy = tap / 3, dx = tap % 3, d"),
        ("            acc[p][o] = fmaf(wv[o], v[dy + (p >> 1)][dx + (p & 1)], acc[p][o]);",
         "            acc[p][o] += 0.0f * wv[o];"),
        ("      if (!one) break;\n      const int off = (tap / 3) * kDnHaloW",
         "      if (true) break;\n      const int off = (tap / 3) * kDnHaloW")],
    ("conv3x3.cu", "no_transpose"): [("    transpose(cur);\n", "")],
    ("conv3x3.cu", "no_copies"): [
        ("    if (g0 < a1) cp_async16(rs + cr * kRawPitch + 8 * gi,",
         "    if (false) cp_async16(rs + cr * kRawPitch + 8 * gi,")],
    ("conv3x3.cu", "no_stores"): [
        ("      if (gy >= h || gx >= w) continue;\n      bf16* dst",
         "      if (true) continue;\n      bf16* dst"),
        ("          if (gy >= h || gx >= w) continue;\n          bf16* ob",
         "          if (true) continue;\n          bf16* ob"),
        ("        ob[(static_cast<int64_t>(8 * j0 + n) * ho + oi) * wo + oj] =",
         "        if (false) ob[(static_cast<int64_t>(8 * j0 + n) * ho + oi) * wo + oj] =")],
    ("im2col_gemm.cu", "base"): [],
    ("im2col_gemm.cu", "no_products"): [
        ("    for (int j = 0; j < kKsB / 16; ++j) {\n      // B: columns",
         "    for (int j = 0; j < 0; ++j) {\n      // B: columns")],
    ("im2col_gemm.cu", "no_copies"): [
        ("        mbar_arrive_expect(bars + st, kStageBytes);",
         "        mbar_arrive_expect(bars + st, 0u);"),
        ("          tma_load_3d(sb + at", "          if (false) tma_load_3d(sb + at"),
        ("        bulk_copy(sb + kOpBytesB, wsrc, kWBytes, bars + st);",
         "        if (false) bulk_copy(sb + kOpBytesB, wsrc, kWBytes, bars + st);"),
        ("          cp_async_zfill<2 * VEC>(", "          if (false) cp_async_zfill<2 * VEC>("),
        ("          cp_async16(sb + kOpBytesB + 16 * i, wsrc + 16 * i);",
         "          if (false) cp_async16(sb + kOpBytesB + 16 * i, wsrc + 16 * i);")],
    ("im2col_gemm.cu", "no_stores"): [
        ("          bulk_store(ob + ", "          if (false) bulk_store(ob + "),
        ("          store_m64(acc[mr],", "          if (false) store_m64(acc[mr],")],
    ("ln_iel.cu", "base"): [],
    ("ln_iel.cu", "no_stage"): [
        ("    for (int i = tid; i < cp * (kMTileH + 4); i += THREADS) {",
         "    for (int i = tid; i < 0; i += THREADS) {"),
        ("    for (int p = tid; p < G::P2; p += THREADS) {",
         "    for (int p = tid; p < 0; p += THREADS) {")],
    ("ln_iel.cu", "no_expansion"): [
        ("      for (int kk = 0; kk < cp; kk += 16) {", "      for (int kk = 0; kk < 0; kk += 16) {")],
    ("ln_iel.cu", "no_dw1"): [
        ("      const int c_lo = qi * G::RW1 / Q, c_hi = (qi + 1) * G::RW1 / Q;",
         "      const int c_lo = qi * G::RW1 / Q, c_hi = c_lo;")],
    ("ln_iel.cu", "no_gates"): [
        ("      for (int k = 0; k < TW / Q; ++k) {  // every range TW / Q columns",
         "      for (int k = 0; k < 0; ++k) {")],
    ("ln_iel.cu", "no_tanh"): [
        ("          const float g = tanhf(a) + win[r + 1][1];",
         "          const float g = a + win[r + 1][1];")],
    ("ln_iel.cu", "no_project"): [
        ("      for (int j = 0; j < NTW; j += 2) {\n        const bf16* bp = wpo",
         "      for (int j = 0; j < 0; j += 2) {\n        const bf16* bp = wpo")],
    ("ln_iel.cu", "no_stores"): [
        ("  for (int i = tid; i < c * kMTileH * per_row; i += THREADS) {",
         "  for (int i = tid; i < 0; i += THREADS) {")],
    ("head_attention.cu", "base"): [],
    ("head_attention.cu", "no_products"): _NO_SCORE_PRODUCTS + [
        ("      for (int ks = 0; ks < MT; ++ks) {\n        uint32_t bv[4][2];",
         "      for (int ks = 0; ks < 0; ++ks) {\n        uint32_t bv[4][2];")],
    ("head_attention.cu", "no_copies"): _NO_SCORE_COPIES + [
        ("        qk::bulk_stage(st, v, nullptr, c, sm.rowbase, n0, stop, sm.bars + qk::kMaxStages "
         "+ slot);", "        ;"),
        ("      mbar_wait(sm.bars + qk::kMaxStages + s % as, (s / as) & 1);", "      ;"),
        ("        vs.issue(st, n0, stop, false);", "        ;")],
    ("head_attention.cu", "no_apply"): [
        ("for (int s = 0; s < as - 1; ++s) issue_v(s);", "for (int s = 0; s < 0; ++s) issue_v(s);"),
        ("  for (int s = 0; s < steps; ++s) {\n    bf16* os = sm.aux",
         "  for (int s = 0; s < 0; ++s) {\n    bf16* os = sm.aux")],
    ("head_attention.cu", "no_stores"): [
        ("      if (lo >= hi) continue;", "      if (true) continue;")],
    ("batched_qk.cu", "base"): [],
    ("batched_qk.cu", "no_products"): _NO_SCORE_PRODUCTS,
    ("batched_qk.cu", "no_copies"): _NO_SCORE_COPIES,
    ("batched_qk.cu", "no_stores"): [("[&](int e, float s) { og[e] = s; });",
                                      "[&](int e, float s) { if (false) og[e] = s; });")],
    ("relayout.cu", "base"): [],
    ("relayout.cu", "no_loads"): [
        ("    if (lane == 0) mbar_arrive_expect(bar, load_bytes<E>(a.in_side, it));",
         "    if (lane == 0) mbar_arrive_expect(bar, 0u);"),
        ("    move_side<E, true>(a.in_side,", "    if (false) move_side<E, true>(a.in_side,"),
        ("      for (int v = l_col * VI; v < tl.ny; v += l_step)",
         "      for (int v = l_col * VI; false; v += l_step)"),
        ("      for (int v = l_col * VI; v < ny; v += l_step) {",
         "      for (int v = l_col * VI; false; v += l_step) {")],
    ("relayout.cu", "no_transpose"): [
        ("      transpose_b16(a, dv.tmb, it, sin, sout, warp, lane);", "      ;"),
        ("      transpose_b32(a, dv.tmb, it, sin, sout, warp, lane);", "      ;"),
        ("        for (int k = 0; k < VO; ++k) vals.v[k] = tile[(v + k) * pitch + r];",
         "        for (int k = 0; k < VO; ++k) vals.v[k] = E(0);")],
    ("relayout.cu", "no_stores"): [
        ("      move_side<E, false>(a.out_side,", "      if (false) move_side<E, false>(a.out_side,"),
        ("        store_vec<VO * sizeof(E)>(row + v, vals.v);",
         "        if (false) store_vec<VO * sizeof(E)>(row + v, vals.v);")],
}
# (site, C_in, C_out, h, w, pad) at 600 x 400: P4's, and P6's (P4's and the
# NormDownsamples', zero pad)
P4_SITES = [("stem_hv", 3, 36, H, W, "edge"), ("stem_i", 1, 36, H, W, "edge"),
            ("head_hv", 36, 2, H, W, "edge"), ("head_i", 36, 1, H, W, "edge"),
            ("up3", 144, 72, H // 8, W // 8, "zero"), ("up2", 72, 36, H // 4, W // 4, "zero"),
            ("up1", 36, 36, H // 2, W // 2, "zero")]
P6_SITES = P4_SITES + [("down1", 36, 36, H, W, "zero"), ("down2", 36, 72, H // 2, W // 2, "zero"),
                       ("down3", 72, 144, H // 4, W // 4, "zero")]
P5_SITES = [site[:5] + (None,) for site in P6_SITES[-3:]]
# (site, C, h, w) of P2/P3: the LCA levels
P23_SITES = [("level1", 36, H // 2, W // 2), ("level2", 72, H // 4, W // 4),
             ("level3", 144, H // 8, W // 8)]
# (site, heads, h, w) of P1 and P10/P15: the LCA levels, c = 18 rows a head
ATTN_SITES = [("level1", 2, H // 2, W // 2), ("level2", 4, H // 4, W // 4),
              ("level3", 8, H // 8, W // 8)]
# (site, relayout, input shape at batch b, kwargs): the relayout's
RELAYOUT_SITES = [("HWCB entry", "P14", lambda b: (H * W, 3, b), {"n_blk": H * W}),
                  ("HWCB exit", "P11", lambda b: (b, 1, 3 * H * W), {})]
RELAYOUT_SITES += [(f"{p} level {lv}", p, shape, {})
                   for lv, n, c in ((1, 60000, 36), (2, 15000, 72), (3, 3750, 144))
                   for p, shape in (("P8", lambda b, n=n, c=c: (n, c, b)),
                                    ("P11", lambda b, n=n, c=c: (b, c, n)))]
RELAYOUT_SITES += [("P7 steps 1 level 1", "P7", lambda b: (60000, 36, b), {"steps": 1})]


def ln_iel_weights(c: int, dev, rnd) -> tuple:
    """The LayerNorm's fp32 weight and bias and the IEL's bf16 weights of a
    C-channel LCA (hidden int(2.66 C)), at the scale of a 1/sqrt(fan-in)
    init."""
    hid = int(c * 2.66)
    return (torch.rand(c, device=dev) + 0.5, torch.rand(c, device=dev) * 0.6 - 0.3,
            rnd((2 * hid, c, 1, 1), -c**-0.5, c**-0.5), rnd((2 * hid, 1, 3, 3), -1 / 3, 1 / 3),
            rnd((hid, 1, 3, 3), -1 / 3, 1 / 3), rnd((hid, 1, 3, 3), -1 / 3, 1 / 3),
            rnd((c, hid, 1, 1), -hid**-0.5, hid**-0.5))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="P4's, P5's, P6's, P2/P3's, P1's and P10/P15's "
                                            "phases timed one at a time")
    p.add_argument("--out", type=str, default="build/conv_phases",
                   help="the JSON's directory; the variants build under build/conv_phases")
    p.add_argument("--only", choices=["relayout"], default=None,
                   help="time the relayout's variants alone")
    return p.parse_args(argv)


def build_variants(out: str, only=None) -> dict:
    """Every variant's library (of ``only``'s source), built in parallel:
    (source, variant) -> CDLL."""
    procs = {}
    for (src, name), subs in VARIANTS.items():
        if only is not None and src != only:
            continue
        d = os.path.join(out, f"{src.split('.')[0]}_{name}")
        os.makedirs(d, exist_ok=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, d)
        texts = {src: (_build.CSRC_DIR / src).read_text()}
        for sub in subs:
            file, old, new = sub if len(sub) == 3 else (src, *sub)
            text = texts.setdefault(file, (_build.CSRC_DIR / file).read_text())
            if old not in text:
                raise RuntimeError(f"{src} {name}: the phase moved ({file}: {old[:60]!r})")
            texts[file] = text.replace(old, new)
        for file, text in texts.items():
            with open(os.path.join(d, file), "w") as f:
                f.write(text)
        lib = os.path.join(d, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, os.path.join(d, src)]
        procs[src, name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(lib)
    return libs


def bind(kernel: _build.CudaKernel, lib: ctypes.CDLL) -> None:
    """Launch ``kernel``'s C entry from ``lib`` (its count still counts)."""
    fn = getattr(lib, kernel.name)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    kernel._fn = fn


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_phases: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    libs = build_variants(os.path.join(ROOT, "build", "conv_phases"),
                          "relayout.cu" if args.only else None)
    gen = torch.Generator().manual_seed(0)
    rnd = lambda shape, lo, hi: (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(
        dev, torch.bfloat16)
    rows = []

    def time_variants(key, kernel, src, site, run, data):
        """``run`` on each variant's library, beside one read of ``data``."""
        names = [name for s, name in VARIANTS if s == src]
        row = {"kernel": key, "site": site, "shape": list(data.shape), "device": smi}
        for name in names:
            bind(kernel, libs[src, name])
            row[name] = graph_ms(run)
        row["one_read"] = graph_ms(lambda: data.clone()) / 2
        rows.append(row)
        print(f"{key} {site} {tuple(data.shape)}: " + "  ".join(
            f"{n} {row[n]:.4f}" for n in names + ["one_read"]) + " ms", flush=True)

    for dt in (torch.bfloat16, torch.float32):
        for site, name, shape, kw in RELAYOUT_SITES:
            for b in (BATCH, 32) if site.startswith("HWCB") else (BATCH,):
                x = (torch.rand(shape(b), generator=gen) * 4 - 2).to(dev, dt)
                gxmy, out_shape = rl.geometry(name, tuple(x.shape), **kw)
                plan = rl.relayout_plan(*gxmy, x.element_size())
                time_variants(f"relayout {str(dt)[6:]}", rl.P7, "relayout.cu",
                              f"{site} batch {b} ({plan.name})",
                              lambda: rl.relayout_kernel(x, rl.P7, gxmy, out_shape), x)
                del x
    rl.P7._fn = None
    if args.only:
        return write_rows(args.out, rows)
    alpha = torch.full((1,), 0.25, device=dev)
    for key, kernel, src, sites in (
            ("P4", cc.CONV3X3, "conv3x3.cu", P4_SITES),
            ("P5", cc.CONV3X3_HALF_PRELU, "conv3x3.cu", P5_SITES),
            ("P6", icol.IM2COL_DOTS, "im2col_gemm.cu", P6_SITES),
            ("P2/P3", lc.LN_IEL, "ln_iel.cu", [s[:2] + (0,) + s[2:] + (None,) for s in P23_SITES])):
        for site, cin, cout, h, w, pad in sites:
            x = rnd((BATCH, cin, h, w), -1.0, 1.0)
            wt = rnd((cout, cin, 3, 3), -cin**-0.5, cin**-0.5)
            if key == "P4":
                run, data = (lambda: cc.conv3x3_kernel(x, wt, pad)), x
            elif key == "P5":
                run, data = (lambda: cc.conv3x3_half_prelu_kernel(x, wt, alpha)), x
            elif key == "P2/P3":
                wts = ln_iel_weights(cin, dev, rnd)
                run, data = (lambda: lc.ln_iel_kernel(x, *wts, True)), x
            else:
                a, wmat = icol.stage_3x3(x, pad), wt.reshape(cout, cin * 9)
                run, data = (lambda: icol.im2col_dots_kernel(a, wmat)), a
            time_variants(key, kernel, src, site, run, data)
            del x, data, run
            if key == "P6":
                del a
            torch.cuda.empty_cache()
    for key, kernel, src in (("P1", ha.HEAD_ATTENTION, "head_attention.cu"),
                             ("P10/P15", bq.BATCHED_QK, "batched_qk.cu")):
        for site, heads, h, w in ATTN_SITES:
            q, k, v = (rnd((BATCH * heads, 18, h * w), -1.0, 1.0) for _ in range(3))
            temps = torch.full((heads,), 4.0, device=dev)
            run = ((lambda: ha.head_attention_kernel(q, k, v, temps)) if key == "P1"
                   else (lambda: bq.batched_qk_kernel(q, k)))
            time_variants(key, kernel, src, site, run, q)
            del q, k, v, run
            torch.cuda.empty_cache()
    for kernel in (cc.CONV3X3, cc.CONV3X3_HALF_PRELU, icol.IM2COL_DOTS, lc.LN_IEL,
                   ha.HEAD_ATTENTION, bq.BATCHED_QK):
        kernel._fn = None  # the next call binds the kernels' own library again
    return write_rows(args.out, rows)


def write_rows(out: str, rows: list) -> int:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "conv_phases.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
