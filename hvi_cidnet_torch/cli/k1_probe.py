"""Step 0 of K1 (RGB -> HVI): what bounds it on the card, bytes or issue.

    python -m hvi_cidnet_torch.cli.k1_probe [--out build/k1_probe]

Runs on the card. Builds the variants of ``csrc/probe/k1_probe.cu`` beside
the kernels' library and times, at the 600 x 400 image, batch 8, bf16 and
fp32, each as device time per call from CUDA graphs (``kernel_times``),
in turns:

* ``kernel``: K1 as the library has it (``hvi_cuda.rgb_to_hvi_kernel``);
* ``first_cut``: K1's first design (one thread a pixel, 64-bit index
  division, strided scalar loads and stores, three divisions by denom);
* ``copy_old``: the first design's loads, indexing and stores, no math;
* ``math_planar``: the first design's math on planar input and output;
* ``copy_new``: 16-byte loads of NHWC lines through shared memory and
  16-byte plane stores on a 2-D grid, no math.

Also K1 and the first design at batch 1 and 32 in bf16, K1 under plans of
1, 2 and 4 pixels a thread (``sweep``), each variant's agreement with the
plain twin (or, for the copies, with the input), the count of fp32 hues in
[0, 1) at which ``sincosf`` differs in bits from ``sinf`` and ``cosf``, and
each kernel's SASS (``cuobjdump -sass``) and registers (``cuobjdump
-res-usage``), written under ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import hashlib
import io
import json
import os
import re
import subprocess
import sys

import torch

from hvi_cidnet_torch.cli.kernel_times import H, K, W, graph_ms
from hvi_cidnet_torch.ops import _build
from hvi_cidnet_torch.ops import hvi_cuda as hc

PROBE_SRC = _build.CSRC_DIR / "probe" / "k1_probe.cu"
MODES = {"first_cut": 0, "copy_old": 1, "math_planar": 2, "copy_new": 3}
RUN = 512  # pixels a block of copy_new
HBM_BYTES_PER_S = 3.35e12


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="step 0 of K1: variants, SASS and sincosf on the card")
    p.add_argument("--out", type=str, default="build/k1_probe")
    return p.parse_args(argv)


def build_probe() -> tuple:
    """The probe library (path, ptxas log), built with the kernels' flags."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode() + PROBE_SRC.read_bytes())
    h.update((_build.CSRC_DIR / "common.cuh").read_bytes())
    out = _build.BUILD_DIR.parent / "probe" / f"libk1probe_{h.hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(out),
           str(PROBE_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stderr}")
    return out, proc.stderr


def sass(path, out_dir: str, name: str) -> dict:
    """Instructions per kernel in ``path``'s SASS, which goes to ``out_dir``
    with the registers of each kernel (``{name}.res``)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for flag, ext in (("-res-usage", "res"), ("-sass", "sass")):
        text = subprocess.run([cuobjdump, flag, str(path)], capture_output=True, text=True,
                              check=True).stdout
        with open(os.path.join(out_dir, f"{name}.{ext}"), "w") as f:
            f.write(text)
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            counts[cur] += 1
    return counts


def sweep(img: torch.Tensor, k: torch.Tensor, code: int) -> tuple:
    """K1 launched under plans of 1, 2 and 4 pixels a thread: (the calls by
    name, their output tensor)."""
    b, h, w, _ = img.shape
    out = torch.empty((b, 3, h, w), dtype=img.dtype, device=img.device)
    plan = hc.rgb_to_hvi_plan(b, h * w, img.element_size(), out.element_size())
    fns = {}
    for per_thread in hc.RGB_PIXELS:
        run = hc.RGB_THREADS * per_thread
        fns[f"kernel_{per_thread}px"] = functools.partial(
            hc.RGB_TO_HVI, img.device, img.data_ptr(), code, out.data_ptr(), code, k.data_ptr(),
            b, h * w, plan.vec, run, -(-h * w // run))
    return fns, out


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_probe: needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib_path, _ = _build.build(verbose=True)
    probe_path, probe_log = build_probe()
    with open(os.path.join(args.out, "ptxas.txt"), "w") as f:
        f.write(log.getvalue() + probe_log)
    result = {"card": smi, "sass": {"library": sass(lib_path, args.out, "library"),
                                    "probe": sass(probe_path, args.out, "probe")}}
    for lib, counts in result["sass"].items():
        for fn, n in counts.items():
            if "rgb_to_hvi" in fn or "probe" == lib:
                print(f"SASS {lib} {n:6d} {fn}")

    probe = ctypes.CDLL(str(probe_path))
    variant = probe.k1_probe_variant
    variant.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    variant.restype = ctypes.c_int
    probe.k1_probe_sincos.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    probe.k1_probe_sincos.restype = ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream

    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    assert probe.k1_probe_sincos(bad.data_ptr(), stream()) == 0
    result["sincosf_mismatches"] = int(bad.item())
    print(f"sincosf vs sinf/cosf: {result['sincosf_mismatches']} of 2**30 - 2**23 fp32 hues "
          f"in [0, 1) differ", flush=True)

    k = torch.full((1,), K, device=dev)
    gen = torch.Generator().manual_seed(0)
    hw = H * W
    rows = []
    for dt, batches in ((torch.bfloat16, (8, 1, 32)), (torch.float32, (8,))):
        code = _build.DTYPE_CODES[dt]
        for b in batches:
            img = torch.rand((b, H, W, 3), generator=gen).to(dev, dt)
            planar = img.permute(3, 0, 1, 2).contiguous()  # (3, B, H, W)
            ref = hc.rgb_to_hvi_plain(img, k, dt)
            outs = {m: torch.empty((b, 3, H, W), dtype=dt, device=dev) for m in MODES}
            outs["math_planar"] = torch.empty((3, b, H, W), dtype=dt, device=dev)

            def run(m):
                src = planar if m == "math_planar" else img

                def go():
                    err = variant(MODES[m], src.data_ptr(), code, outs[m].data_ptr(), code,
                                  k.data_ptr(), b, hw, RUN, stream())
                    assert err == 0, f"{m}: cudaError {err}"
                return go

            fns = {"kernel": lambda: hc.rgb_to_hvi_kernel(img, k, dt)}
            if b == 8:
                fns.update({m: run(m) for m in MODES})
            else:
                fns["first_cut"] = run("first_cut")
            swept, swept_out = sweep(img, k, code)
            fns.update(swept)
            for name, fn in fns.items():
                fn()
                if name in swept:
                    assert torch.equal(swept_out, ref), f"{name}: not equal to the twin"
            torch.cuda.synchronize()
            check = {"kernel_equal": bool(torch.equal(fns["kernel"](), ref)),
                     "kernel_err": (fns["kernel"]().float() - ref.float()).abs().max().item(),
                     "first_cut_err": (outs["first_cut"].float() - ref.float()).abs().max().item()}
            if b == 8:
                copy = img.permute(0, 3, 1, 2)
                check["copy_old_equal"] = bool(torch.equal(outs["copy_old"], copy))
                check["copy_new_equal"] = bool(torch.equal(outs["copy_new"], copy))
                check["math_planar_err"] = (outs["math_planar"].permute(1, 0, 2, 3).float()
                                            - ref.float()).abs().max().item()
            order = list(fns) + list(fns)[::-1]
            times = {m: [] for m in fns}
            for m in order:
                times[m].append(1e3 * graph_ms(fns[m]))
            row = {"dtype": str(dt).removeprefix("torch."), "batch": b, "us": times,
                   "bound_us": 1e6 * 2 * img.numel() * img.element_size() / HBM_BYTES_PER_S,
                   **check}
            rows.append(row)
            print(json.dumps(row), flush=True)
    result["rows"] = rows
    print(f"card: {smi}")
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
