#!/usr/bin/env python3
"""Where the int8 and int4 span scans' time goes, on one NVIDIA GPU.

    python3 probe_span_scan.py     (from the repository root; needs nvcc)

Builds `csrc/quant_topk.cu` four times into mmrs_tpu_torch/_build/probe/,
each from a copy of `csrc/` with `span_scan.cuh` cut back by text
replacement, and times the int8 (K4) and int4 (K5) scan passes alone (no
query prep, no merge passes; CUDA events around 20 launches) over a
seeded 1,048,576 x 512 gallery at Q = 8, k = 10, for spans of 256 to
4096 rows:
  - full: the kernel as it is;
  - noselect: the scores are computed (the epilogue writes the first
    chunk's to shared memory) but no threshold test, append, seed or final
    select runs: what the select costs;
  - loads: the ring alone (no mma, no select): the floor of this
    structure's loads and barriers;
  - stages5: the full kernel with the 5-stage ring of one block an SM (its
    own choice at D = 512 is 2 stages, two blocks an SM).
(noselect and loads cut the code shared by both row kinds.)
The variants' partials are meaningless; only their times are printed, one
line each, then the card's name and power limit.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from mmrs_tpu_torch.ops import _cuda  # noqa: E402
from mmrs_tpu_torch.ops.quant import quantize_rows  # noqa: E402
from mmrs_tpu_torch.ops.quant4 import prep_queries, quantize_rows_int4  # noqa: E402

N, D, Q, K = 1 << 20, 512, 8, 10
SPANS = (256, 512, 1024, 2048, 4096)

SEED_SELECT = "    if (warp < nq) {\n      if (c == 0) {"
APPEND = "          } else if (live && qi < nq && s > th[j]) {"
FINAL = "  if (warp < nq) {\n    const int cnt = cnt_s[warp]"
CODE_KSTEP = ("          if (ks >= ksteps) break;\n"
              "          const unsigned char* ql")
STAGES = "  return scan_smem<KIND>(D, 2) <= kScanSmemPair ? 2 : 5;"


def variants(src: str) -> dict:
    for cut in (SEED_SELECT, APPEND, FINAL, CODE_KSTEP, STAGES):
        if cut not in src:
            raise SystemExit(f"span_scan.cuh changed; update the probe: {cut!r}")
    noselect = (src.replace(SEED_SELECT, SEED_SELECT.replace("warp < nq", "false"))
                .replace(APPEND, APPEND.replace("live && qi < nq && s > th[j]",
                                                "false"))
                .replace(FINAL, FINAL.replace("warp < nq", "false")))
    loads = noselect.replace(CODE_KSTEP, CODE_KSTEP.replace("ks >= ksteps",
                                                            "ks >= 0"), 1)
    return {"full": src, "noselect": noselect, "loads": loads,
            "stages5": src.replace(STAGES, "  return 5;")}


def build(out_dir: str) -> dict:
    with open(os.path.join(_cuda.CSRC_DIR, "span_scan.cuh")) as f:
        src = f.read()
    jobs = {}
    for name, text in variants(src).items():
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda.CSRC_DIR, d)
        with open(os.path.join(d, "span_scan.cuh"), "w") as f:
            f.write(text)
        lib = os.path.join(d, "lib.so")
        jobs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-o", lib,
             os.path.join(d, "quant_topk.cu")]))
    for name, (_, proc) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for {name}")
    return {name: lib for name, (lib, _) in jobs.items()}


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_span_scan: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build(os.path.join(_cuda.BUILD_DIR, "probe"))
    gen = torch.Generator(device=dev).manual_seed(9)
    g = torch.randn((N, D), device=dev, generator=gen)
    g = g / g.norm(dim=1, keepdim=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    # (entry point, its argtypes, the arguments before Q, N, D, k, span)
    qq, qsc, qrs = prep_queries(g[:Q])
    q8, s8 = quantize_rows(g[:Q])
    kinds = {
        "int8": ("mmrs_topk_scan_q8", [P] * 4 + [I] * 5 + [P] * 3,
                 (q8, s8, *quantize_rows(g))),
        "int4": ("mmrs_topk_scan_q4", [P] * 5 + [I] * 5 + [P] * 3,
                 (qq, qsc, qrs, *quantize_rows_int4(g)))}
    del g
    stream = torch.cuda.current_stream(dev).cuda_stream
    for kind, (entry, argtypes, tensors) in kinds.items():
        for name, path in libs.items():
            scan = getattr(ctypes.CDLL(path), entry)
            scan.argtypes = argtypes
            scan.restype = I
            for span in SPANS:
                parts = -(-N // span)
                pv = torch.empty((Q, parts, K), device=dev)
                pi = torch.empty((Q, parts, K), dtype=torch.int32, device=dev)

                def call():
                    err = scan(*(t.data_ptr() for t in tensors), Q, N, D, K,
                               span, pv.data_ptr(), pi.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"{kind} {name} span {span}: CUDA "
                                           f"error {err}")

                print(f"{kind} scan {name} span {span} ({N}x{D}, Q={Q}, "
                      f"k={K}): {time_ms(call):.4f} ms", flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
