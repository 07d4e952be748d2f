"""Time this checkout's EDT kernel against a baseline ``edt.cu``, in turns,
on one CUDA card.

The baseline is another version of ``csrc/edt.cu`` (for example
``git show <commit>:nvfpcc_tpu_torch/csrc/edt.cu``), with either the first
C entry point ``nvfpcc_edt3d(occ, out, scratch_int32, D, H, W, radius,
stream)`` or the current one, which adds ``lane_bits`` after ``radius``. Both are
built with the same nvcc flags; at each (shape, radius) both results are
held against each other and the kernel against the plain version, then the
two are timed baseline, kernel, kernel, baseline with CUDA events, and
``torch.profiler`` splits the kernel's time by launch (one per pass). Also
prints each kernel's SASS count of min/add instructions (``cuobjdump``).

    python -m nvfpcc_tpu_torch.tools.edt_ab --baseline .work/baseline/edt.cu

One JSON line per case on stdout; the whole report also goes to
``--out`` (default ``.work/edt_ab.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

CASES = [((688, 688, 688), 55), ((688, 688, 688), 27), ((656, 656, 672), 63)]


def sass_counts(lib: str) -> dict:
    """{kernel: {opcode: count}} for the min/add opcodes of each kernel."""
    from torch.utils.cpp_extension import CUDA_HOME

    r = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib],
                       capture_output=True, text=True, check=True)
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if fn and m:
            op = m.group(1).split(".")[0]
            if any(k in op for k in ("MNMX", "VIADD", "IADD", "LDS", "MIN", "MAX")):
                counts[fn][op] = counts[fn].get(op, 0) + 1
    return counts


def pass_split(fn, reps: int = 5) -> dict:
    """Device microseconds per call of each CUDA kernel that ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if t and "edt_pass" in ev.key:
            out[ev.key[:90]] = t / reps
    return out


def build_baseline(src: str) -> str:
    from nvfpcc_tpu_torch.kernels import edt as K
    from torch.utils.cpp_extension import CUDA_HOME

    os.makedirs(K.BUILD_DIR, exist_ok=True)
    lib = os.path.join(K.BUILD_DIR, f"libedt_baseline_{os.getpid()}.so")
    r = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *K.NVCC_FLAGS, "-o", lib, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"baseline nvcc failed:\n{r.stdout}\n{r.stderr}")
    print("baseline ptxas:", *(ln for ln in (r.stdout + r.stderr).splitlines()
                               if "Compiling entry" in ln or "registers" in ln), sep="\n")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="path of the baseline edt.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(".work", "edt_ab.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("edt_ab: no CUDA card", file=sys.stderr)
        return 1
    from nvfpcc_tpu_torch.device import card_line
    from nvfpcc_tpu_torch.kernels import edt as K

    smi = card_line("cuda")
    print(smi, flush=True)
    lib_new = K.build_library()
    with open(lib_new + ".log") as f:
        print(f.read(), flush=True)
    base_path = build_baseline(args.baseline)
    with open(args.baseline) as f:
        lanes_abi = "int lane_bits" in f.read()
    base = ctypes.CDLL(base_path)
    base.nvfpcc_edt3d.restype = ctypes.c_int
    base.nvfpcc_edt3d.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int] * (2 if lanes_abi else 1) + [ctypes.c_void_p]
    report = {"device": smi, "sass": {"kernel": sass_counts(lib_new), "baseline": sass_counts(base_path)},
              "cases": []}
    print(json.dumps({"sass": report["sass"]}), flush=True)

    def run_base(occ, radius):
        out = torch.empty(occ.shape, dtype=torch.int32, device="cuda")
        bits = K.lane_bits(radius) if lanes_abi else 32
        scratch = torch.empty(occ.shape, dtype=torch.int16 if bits == 16 else torch.int32, device="cuda")
        d, h, w = occ.shape
        lanes = (bits,) if lanes_abi else ()
        rc = base.nvfpcc_edt3d(occ.data_ptr(), out.data_ptr(), scratch.data_ptr(), d, h, w, radius,
                               *lanes, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"baseline launch failed: {rc}")
        return out

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / args.reps

    for shape, radius in CASES:
        occ = torch.as_tensor(np.random.default_rng(7).uniform(0, 1, shape) < 0.003, device="cuda")
        got, old = K.squared_edt_3d(occ, radius), run_base(occ, radius)
        same = bool(torch.equal(got, old) and torch.equal(got, K.squared_edt_3d_ref(occ, radius)))
        del got, old
        b1 = ms(lambda: run_base(occ, radius))
        k1 = ms(lambda: K.squared_edt_3d(occ, radius))
        k2 = ms(lambda: K.squared_edt_3d(occ, radius))
        b2 = ms(lambda: run_base(occ, radius))
        row = {"shape": list(shape), "radius": radius, "equal": same,
               "baseline_ms": [b1, b2], "kernel_ms": [k1, k2],
               "kernel_us_by_launch": pass_split(lambda: K.squared_edt_3d(occ, radius)),
               "baseline_us_by_launch": pass_split(lambda: run_base(occ, radius))}
        report["cases"].append(row)
        print(json.dumps(row), flush=True)
        del occ
        torch.cuda.empty_cache()
        if not same:
            print("edt_ab: kernel disagrees with the baseline or the plain version", file=sys.stderr)
            return 1
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
