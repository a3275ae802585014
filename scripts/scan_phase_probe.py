#!/usr/bin/env python3
"""Where the scan kernel's wide path (K > 8) spends its time, on a CUDA card.

    python3 scripts/scan_phase_probe.py [--reps 5]

Builds four variants of the wide kernels of ``csrc/ds_scan.cu`` side by
side, each from a patched copy of the source with the K <= 8 instances
dropped from its dispatch (so nvcc takes a minute, not three), into
``raht3dgs_tpu_torch/_build/probe/``:

- ``kernel``: the wide kernels unchanged;
- ``stamps``: the scan pass records ``%globaltimer`` at eight points of
  every block (start, copies issued, carry, copies landed, thread sums and
  block scan, row scan, hi stored, end) and the block's SM;
- ``memory_only``: the copies in and out, without the arithmetic (carry,
  thread sums, block scans, row scan);
- ``arithmetic_only``: the arithmetic on the staged words, without the
  copies.

Each variant is timed (CUDA events, ``--reps`` rounds of 10 calls; the
median and the range of the rounds) on the same seeded inputs: the pack at
(2^19, 57) and (2e6, 60), the transposed layout at (57, 2^19). The stamped
variant's output is checked bitwise against the unchanged one. Prints one
JSON line: the card, ptxas registers, the times, and for the stamped run
the scan pass's span, the median and 90th percentile of each phase in us,
and the mean number of blocks resident on an SM. The variants are made by
patching the source's text; an assertion names any anchor the source no
longer has.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAMP = """
__device__ unsigned long long* g_stamps = nullptr;
__device__ __forceinline__ void stamp(int p) {
  if (threadIdx.x == 0 && g_stamps != nullptr) {
    unsigned long long t;
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[blockIdx.x * 10ull + p] = t;
    if (p == 0) g_stamps[blockIdx.x * 10ull + 9] = sm;
  }
}
"""
PHASES = ["issue", "carry", "copies_land", "sums_block_scan", "row_scan", "hi_out",
          "lo_out"]


def replaced(text: str, old: str, new: str) -> str:
    assert old in text, f"anchor not found: {old[:70]!r}"
    return text.replace(old, new, 1)


def patched_source(src: str, variant: str) -> str:
    """The source of one variant (see the module docstring)."""
    # the wide path alone
    a, b = src.index("#define DS_SCAN_CASE(K)"), src.index("#undef DS_SCAN_CASE")
    src = src[:a] + src[b + len("#undef DS_SCAN_CASE"):]
    scan = src.index("    ds_wide_scan(const float* __restrict__ in_hi,")
    head, body = src[:scan], src[scan:]

    def rep_body(old: str, new: str) -> None:
        nonlocal body
        body = replaced(body, old, new)

    issue = "  wide_issue<kPair>(in_hi, in_lo, row_major, rs, cs, w, s_wide, s2);\n"
    carry = ("  carry_at<kWide>(w.b, carry, carry_hi, carry_lo, ncol, w.c0, w.kv, run_h,\n"
             "                  run_l);\n")
    land = "  cp_async_wait_all();\n  __syncthreads();\n"
    sums = ("  {\n    float hi[kWide], lo[kWide], ph[kWide], pl[kWide], th[kWide], tl[kWide];\n"
            "    wide_row_sums<kPair>(s_wide, s2, row_major, hi, lo);\n"
            "    block_scan<kWide>(hi, lo, ph, pl, th, tl);\n#pragma unroll\n"
            "    for (int k = 0; k < kWide; ++k) ds_add(run_h[k], run_l[k], ph[k], pl[k]);\n"
            "  }\n")
    rows = ("  float lo_out[kItems][kWide];\n"
            "  wide_scan_rows<kPair>(s_wide, s2, row_major, run_h, run_l, lo_out);\n")
    hi_out = "  wide_stage_out(s_wide, row_major, out_hi + o, ors, ocs, w.R, w.kv);\n"
    lo_out = ("  __syncthreads();\n  wide_stage_out(s_wide, row_major, out_lo + o, ors, ocs, "
              "w.R, w.kv);\n}\n")
    if variant == "stamps":
        src = replaced(src, "constexpr int kWide = 8;", "constexpr int kWide = 8;\n" + STAMP)
        head = src[:src.index("    ds_wide_scan(const float* __restrict__ in_hi,")]
        rep_body("  extern __shared__ __align__(16) float s_wide[];\n",
                 "  extern __shared__ __align__(16) float s_wide[];\n  stamp(0);\n")
        rep_body(issue, issue + "  stamp(1);\n")
        rep_body(carry, carry + "  stamp(2);\n")
        rep_body(land, land + "  stamp(3);\n")
        rep_body(sums, sums + "  stamp(4);\n")
        rep_body(rows, rows + "  stamp(5);\n")
        rep_body(hi_out, hi_out + "  stamp(6);\n")
        rep_body(lo_out, lo_out[:-2] + "  stamp(7);\n}\n")
    elif variant == "memory_only":
        rep_body(carry, "")
        rep_body(sums, "")
        rep_body(rows, "  float lo_out[kItems][kWide] = {};\n")
        head = replaced(head, "  float hi[kWide], lo[kWide], ph[kWide], pl[kWide], th[kWide], "
                              "tl[kWide];\n  wide_row_sums<kPair>(s_wide, s2, row_major, hi, lo);\n"
                              "  block_scan<kWide>(hi, lo, ph, pl, th, tl);\n",
                        "  float th[kWide] = {}, tl[kWide] = {};\n")
    elif variant == "arithmetic_only":
        rep_body(issue, "")
        rep_body(hi_out, "  if (run_h[0] == 12345.f) out_hi[0] = lo_out[3][2];\n  return;\n")
        head = replaced(head, issue + "  cp_async_wait_all();\n", "")
    src = head + body
    if variant == "stamps":
        src = replaced(src, 'extern "C" {', 'extern "C" {\nint probe_stamps(void* p) {\n'
                       '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n')
    return src


def build(variants, out_dir):
    """nvcc every variant in parallel; returns {variant: (lib path, ptxas log)}."""
    from raht3dgs_tpu_torch.codec._native import nvcc_command
    from raht3dgs_tpu_torch.ops.ds_scan import _SRC

    os.makedirs(out_dir, exist_ok=True)
    src = open(_SRC).read()
    done, errors = {}, []

    def one(v):
        cu = os.path.join(out_dir, f"{v}.cu")
        lib = os.path.join(out_dir, f"lib_{v}.so")
        with open(cu, "w") as f:
            f.write(patched_source(src, v))
        p = subprocess.run(nvcc_command(cu, lib), capture_output=True, text=True, timeout=900)
        if p.returncode:
            errors.append(f"{v}: {p.stderr[-2000:]}")
        done[v] = (lib, p.stderr)

    threads = [threading.Thread(target=one, args=(v,)) for v in variants]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("scan_phase_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import gpu_line, ptxas_summary
    from raht3dgs_tpu_torch.codec._native import BUILD_DIR
    from raht3dgs_tpu_torch.ops.ds_scan import scratch_floats

    variants = ["kernel", "stamps", "memory_only", "arithmetic_only"]
    built = build(variants, os.path.join(BUILD_DIR, "probe"))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {}
    for v, (path, _) in built.items():
        lib = ctypes.CDLL(path)
        lib.ds_cumsum_f32.argtypes = [vp, ll, i32, ll, ll, i32, vp, vp, ll, vp]
        lib.ds_cumsum_f32.restype = i32
        libs[v] = lib
    libs["stamps"].probe_stamps.argtypes = [vp]

    g = torch.Generator().manual_seed(0)
    cases = {"pack (524288, 57)": (torch.rand(1 << 19, 57, generator=g), True),
             "pack (2000000, 60)": (torch.rand(2_000_000, 60, generator=g), True),
             "transposed (57, 524288)": (torch.rand(57, 1 << 19, generator=g), False)}
    out = {"card": gpu_line(),
           "ptxas": {v: {k: r for k, r in ptxas_summary(log).items() if k.endswith(",0>")}
                     for v, (_, log) in built.items()},
           "ms": {}, "stamps": {}}
    for name, (x, pack) in cases.items():
        x = x.cuda()
        if pack:
            n, k = x.shape
            rs, cs, out_floats = k, 1, (n + 1) * 2 * k
        else:
            k, n = x.shape
            rs, cs, out_floats = 1, n, 2 * n * k
        need = scratch_floats(n, k)
        buf = torch.empty(out_floats + need, device="cuda")

        def call(lib):
            rc = lib.ds_cumsum_f32(x.data_ptr(), n, k, rs, cs, int(pack), buf.data_ptr(),
                                   buf.data_ptr() + 4 * out_floats, need, None)
            assert rc == 0, f"launch failed ({rc})"

        call(libs["kernel"])
        ref = buf[:out_floats].clone()
        call(libs["stamps"])
        assert torch.equal(buf[:out_floats], ref), f"{name}: stamped variant's bits differ"
        out["ms"][name] = {}
        for v in variants:
            for _ in range(3):
                call(libs[v])
            rounds = []
            for _ in range(args.reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(10):
                    call(libs[v])
                e1.record()
                e1.synchronize()
                rounds.append(e0.elapsed_time(e1) / 10)
            out["ms"][name][v] = {"median": statistics.median(rounds),
                                  "range": [min(rounds), max(rounds)]}
        t = -(-n // 2048)
        blocks = t * -(-k // 8)
        if t > 1:  # the scan pass is the second launch; stamp it alone
            stamps = torch.zeros(blocks * 10, dtype=torch.int64, device="cuda")
            libs["stamps"].probe_stamps(stamps.data_ptr())
            call(libs["stamps"])
            torch.cuda.synchronize()
            libs["stamps"].probe_stamps(None)
            a = stamps.view(blocks, 10).cpu().numpy().astype(np.float64)
            ts = (a[:, :8] - a[:, 0].min()) / 1e3
            life = ts[:, 7] - ts[:, 0]
            span = float(ts[:, 7].max())
            d = np.diff(ts, axis=1)
            out["stamps"][name] = {
                "scan_pass_span_us": span, "blocks": blocks,
                "block_life_us_median": float(np.median(life)),
                "phase_us_median": {p: float(np.median(d[:, i])) for i, p in enumerate(PHASES)},
                "phase_us_p90": {p: float(np.percentile(d[:, i], 90))
                                 for i, p in enumerate(PHASES)},
                "resident_blocks_per_sm": float(life.sum() / span / len(set(a[:, 9]))),
            }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
