#!/usr/bin/env python3
"""Time text-edited variants of one of the port's CUDA kernels on one GPU.

Each variant is a kernel source with some literal replacements applied
(every replaced text must occur in the source, or the script stops). All
variants build at once, one nvcc each with the flags of
``localmd_tpu_torch/ops/_build.py``, into ``localmd_tpu_torch/_build/variants/``
(git-ignored), and are timed with CUDA events on the same inputs, in
alternating rounds, so that they share the card's state. Variants that
drop work give wrong results: they are timings of what is left, not
kernels.

    python3 kernel_variants.py {k4-cta,k4,k3} [--source FILE] [--rounds 20]

``k4-cta`` takes K4's first design (one CTA per matrix, a global pair
schedule, atan2f/sincosf, two CTA barriers a step); ``--source`` names a
copy of that source, since the tree holds the redesigned kernel. ``k4`` and ``k3`` take the sources in
``localmd_tpu_torch/csrc``. Prints one line per variant and shape (median
and quartiles in ms) and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "localmd_tpu_torch", "csrc")

_P, _I = ctypes.c_void_p, ctypes.c_int

# ---------------------------------------------------------------------------
# K4's first design: lmd_jacobi_eigh(sym, n, k, sched, sweeps, vals, vecs, stream)
# ---------------------------------------------------------------------------

_CTA_TANGENT = (
    "          const float theta = 0.5f * atan2f(d >= 0.0f ? 2.0f * apq : -2.0f * apq, fabsf(d));\n"
    "          sincosf(theta, &s, &c);\n",
    "          const float tau = d / (2.0f * apq);\n"
    "          const float sg = ((d >= 0.0f) == (apq > 0.0f)) ? 1.0f : -1.0f;\n"
    "          const float tt = sg / (fabsf(tau) + sqrtf(1.0f + tau * tau));\n"
    "          c = 1.0f / sqrtf(1.0f + tt * tt);\n"
    "          s = tt * c;\n",
)
_CTA_ARITH_PAIRS = (
    "        const int p = __ldg(sched + (t * h + tid) * 2);\n"
    "        const int q = __ldg(sched + (t * h + tid) * 2 + 1);\n",
    "        const int m1 = kp - 1;\n"
    "        const int x = tid == 0 ? 0 : ((tid - 1 - t) % m1 + m1) % m1 + 1;\n"
    "        const int y = ((kp - 2 - tid - t) % m1 + m1) % m1 + 1;\n"
    "        const int p = min(x, y), q = max(x, y);\n",
)
_CTA_ONE_BARRIER = (
    "        v[i * ld + q] = c * vq + s * vp;\n      }\n      __syncthreads();\n",
    "        v[i * ld + q] = c * vq + s * vp;\n      }\n",
)
K4_CTA_VARIANTS = {
    "as is": [],
    "tangent form, no trig": [_CTA_TANGENT],
    "pairs by arithmetic, no schedule load": [_CTA_ARITH_PAIRS],
    "one barrier a step (races)": [_CTA_ONE_BARRIER],
    "all three": [_CTA_TANGENT, _CTA_ARITH_PAIRS, _CTA_ONE_BARRIER],
    "no 2x2 or V update (rotation chain and barriers)": [
        ("for (int idx = tid; idx < h * h; idx += nt) {", "for (int idx = tid; idx < 0; idx += nt) {"),
        ("for (int idx = tid; idx < kp * h; idx += nt) {", "for (int idx = tid; idx < 0; idx += nt) {"),
    ],
    "identity rotation (updates, barriers, schedule loads)": [
        ("const float apq = a[p * ld + q];", "const float apq = 0.0f * a[p * ld + q];"),
    ],
    "no rotation, no updates (barriers and loop)": [
        ("const float apq = a[p * ld + q];", "const float apq = 0.0f * a[p * ld + q];"),
        ("for (int idx = tid; idx < h * h; idx += nt) {", "for (int idx = tid; idx < 0; idx += nt) {"),
        ("for (int idx = tid; idx < kp * h; idx += nt) {", "for (int idx = tid; idx < 0; idx += nt) {"),
    ],
}
K4_SHAPES = ((256, 30), (131, 11))


def _k4_inputs(n, k, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, k, k + 3, generator=g, device=dev)
    sym = (a @ a.transpose(1, 2)).contiguous()
    vals = torch.empty(n, k, device=dev)
    vecs = torch.empty(n, k, k, device=dev)
    return sym, vals, vecs


def _k4_cta_call(dev):
    import torch

    from localmd_tpu_torch.ops.linalg import _jacobi_tables, jacobi_sweeps

    calls = {}
    for n, k in K4_SHAPES:
        sym, vals, vecs = _k4_inputs(n, k, dev)
        sched = torch.from_numpy(_jacobi_tables(k + k % 2)).to(dev)
        calls[f"({n}, {k}, {k})"] = (
            lambda fn, sym=sym, vals=vals, vecs=vecs, sched=sched, n=n, k=k: fn(
                sym.data_ptr(), n, k, sched.data_ptr(), jacobi_sweeps(k), vals.data_ptr(),
                vecs.data_ptr(), torch.cuda.current_stream().cuda_stream)
        )
    return calls


# ---------------------------------------------------------------------------
# K4 now: lmd_jacobi_eigh(sym, n, k, sweeps, vals, vecs, stream)
# ---------------------------------------------------------------------------

_NO_UPDATE = ("} else if (warp < v_warp) {", "} else if (warp < 0) {")
_NO_V = ("        const float other = __shfl_sync(0xffffffffu, v[i], av.partner);\n"
         "        v[i] = av.cf * v[i] + av.sf * other;\n", "")
_NO_LOOKAHEAD = ("if (lane < h && t + 1 < total) {", "if (false) {")
_C32 = (
    "    const float u = __fmul_rn(t, t);\n"
    "    const float w = __fadd_rn(1.0f, u);\n"
    "    const float ew = __fadd_rn(__fsub_rn(u, __fsub_rn(w, 1.0f)), __fmaf_rn(t, t, -u));\n"
    "    const float c0 = rsqrtf(w);\n"
    "    const float y = __fmul_rn(c0, c0);\n"
    "    float res = __fmaf_rn(-w, y, 1.0f);\n"
    "    res = __fmaf_rn(-w, __fmaf_rn(c0, c0, -y), res);\n"
    "    res = __fmaf_rn(-ew, y, res);\n"
    "    c = __fmaf_rn(0.5f * c0, res, c0);\n")
_UW = "constexpr int UPDATE_WARPS = 2;"
K4_VARIANTS = {
    "as is": [],
    "4 update warps": [(_UW, "constexpr int UPDATE_WARPS = 4;")],
    "8 update warps": [(_UW, "constexpr int UPDATE_WARPS = 8;")],
    "4 update warps, look-ahead warp only": [(_UW, "constexpr int UPDATE_WARPS = 4;"), _NO_UPDATE, _NO_V],
    "4 update warps, look-ahead warp idle": [(_UW, "constexpr int UPDATE_WARPS = 4;"), _NO_LOOKAHEAD],
    "c in float64 (IEEE double sqrt and division)": [(_C32, (
        "    const double td = t;\n"
        "    c = __double2float_rn(__ddiv_rn(1.0, __dsqrt_rn(__fma_rn(td, td, 1.0))));\n"))],
    "identity rotation (look-ahead loads kept)": [(
        "rotation(x_is_p ? axx : ayy, x_is_p ? ayy : axx, axy, c, s);",
        "c = 1.0f; s = 0.0f * axy;")],
    "look-ahead warp idle (update, V, barrier)": [_NO_LOOKAHEAD],
    "update warps idle (look-ahead, V, barrier)": [_NO_UPDATE],
    "V warp idle (look-ahead, update, barrier)": [_NO_V],
    "look-ahead warp only (barrier)": [_NO_UPDATE, _NO_V],
    "barrier and loop only": [_NO_LOOKAHEAD, _NO_UPDATE, _NO_V],
}
# the paths' shapes (chip_smoke.K4_SHAPES without the k = 64 check)
K4_PATH_SHAPES = ((256, 30), (256, 20), (131, 11), (225, 30), (1, 25))


def _k4_call(dev):
    import torch

    from localmd_tpu_torch.ops.linalg import jacobi_sweeps

    calls = {}
    for n, k in K4_PATH_SHAPES:
        sym, vals, vecs = _k4_inputs(n, k, dev)
        calls[f"({n}, {k}, {k})"] = (
            lambda fn, sym=sym, vals=vals, vecs=vecs, n=n, k=k: fn(
                sym.data_ptr(), n, k, jacobi_sweeps(k), vals.data_ptr(), vecs.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        )
    return calls


# ---------------------------------------------------------------------------
# K3: lmd_block_reconstruct(panels, temporal, starts, tile_offsets,
#     tile_blocks, d1, d2, b1, b2, S, f, out, stream)
# ---------------------------------------------------------------------------

_K3_TWO_SMALL = ("        mma_tf32(acc[j], a_lo, b0_hi, b1_hi);\n"
                 "        mma_tf32(acc[j], a_hi, b0_lo, b1_lo);\n", "")
_K3_BIG = ("        mma_tf32(acc[j], a_hi, b0_hi, b1_hi);\n", "")
_K3_NO_STAGE = [("idx < PIX * ucols; idx += THREADS", "idx < 0; idx += THREADS"),
                ("idx < s_pad * vcols; idx += THREADS", "idx < 0; idx += THREADS")]
K3_VARIANTS = {
    "as is (3xTF32)": [],
    "64 frames a CTA (4 warps)": [("constexpr int FT = 128;", "constexpr int FT = 64;")],
    "one MMA chain across the tile's blocks (no restart)": [
        ("      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;\n", "      for (int e = 0; e < 4; ++e) acc[j][e] = sum[j][e];\n"),
        ("      for (int e = 0; e < 4; ++e) sum[j][e] += acc[j][e];\n", "      for (int e = 0; e < 4; ++e) sum[j][e] = acc[j][e];\n")],
    "one TF32 pass (hi * hi only)": [_K3_TWO_SMALL],
    "no MMA": [_K3_TWO_SMALL, _K3_BIG],
    "no staging loads": _K3_NO_STAGE,
    "no output stores": [("*reinterpret_cast<float2*>(dst + fr) = make_float2(lo, hi);",
                          "if (lo == 1234.5f) *reinterpret_cast<float2*>(dst + fr) = make_float2(lo, hi);")],
}
# the checked 512^2 case and chip_smoke.py's S = 40 case
K3_CASES = ((512, 512, 32, 20, 512), (512, 512, 32, 40, 512))


def _k3_call(dev):
    import torch

    from localmd_tpu_torch.ops import kernels
    from localmd_tpu_torch.ops.tiling import BlockGrid

    calls = {}
    for d1, d2, b, s, f in K3_CASES:
        grid = BlockGrid(d1, d2, (b, b))
        g = torch.Generator(device=dev).manual_seed(0)
        panels = torch.randn(grid.n_blocks, b * b, s, generator=g, device=dev)
        temporal = torch.randn(grid.n_blocks, s, f, generator=g, device=dev)
        plan = kernels.prepare_reconstruct(grid.starts, [ids for ids, _ in grid.cosets()],
                                           (d1, d2), (b, b), dev)
        out = torch.empty(d1, d2, f, device=dev)
        calls[f"{grid.n_blocks} blocks of {b}^2 on {d1}x{d2}, S={s}, f={f}"] = (
            lambda fn, panels=panels, temporal=temporal, plan=plan, out=out, d1=d1, d2=d2, b=b,
            s=s, f=f: fn(
                panels.data_ptr(), temporal.data_ptr(), plan.starts.data_ptr(),
                plan.tile_offsets.data_ptr(), plan.tile_blocks.data_ptr(), d1, d2, b, b, s, f,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        )
    return calls


FAMILIES = {
    "k3": dict(source=os.path.join(CSRC, "block_reconstruct.cu"), entry="lmd_block_reconstruct",
               argtypes=(_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
               variants=K3_VARIANTS, calls=_k3_call),
    "k4-cta": dict(source=None, entry="lmd_jacobi_eigh",
                   argtypes=(_P, _I, _I, _P, _I, _P, _P, _P),
                   variants=K4_CTA_VARIANTS, calls=_k4_cta_call),
    "k4": dict(source=os.path.join(CSRC, "jacobi_eigh.cu"), entry="lmd_jacobi_eigh",
               argtypes=(_P, _I, _I, _I, _P, _P, _P), variants=K4_VARIANTS, calls=_k4_call),
}


# ---------------------------------------------------------------------------
# build and time
# ---------------------------------------------------------------------------

def build_variants(source: str, variants: dict, out_dir: str) -> dict:
    """Apply each variant's replacements to ``source`` and build all
    variants at once; returns name -> path of its shared library."""
    from localmd_tpu_torch.ops import _build

    text = open(source).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        body = text
        for old, new in edits:
            if old not in body:
                raise SystemExit(f"variant {name!r}: text not found in {source}:\n{old}")
            body = body.replace(old, new)
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as fh:
            fh.write(body)
        lib = os.path.join(out_dir, f"v{i}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared", "-o", lib, cu]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(f"built {name!r}: {'; '.join(regs)}", flush=True)
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", choices=sorted(FAMILIES))
    ap.add_argument("--source", help="kernel source to edit (default: the family's)")
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from bench_torch import card_line

    fam = FAMILIES[args.family]
    source = args.source or fam["source"]
    if source is None:
        raise SystemExit(f"{args.family}: --source is required")
    out_dir = os.path.join(HERE, "localmd_tpu_torch", "_build", "variants", args.family)
    libs = build_variants(source, fam["variants"], out_dir)
    fns = {}
    for name, path in libs.items():
        fn = getattr(ctypes.CDLL(path), fam["entry"])
        fn.argtypes = list(fam["argtypes"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda")
    for label, call in fam["calls"](dev).items():
        for fn in fns.values():                        # warm-up, and a launch check
            code = call(fn)
            if code != 0:
                raise SystemExit(f"launch failed with cudaError {code}")
        torch.cuda.synchronize()
        times = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name, fn in fns.items():
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                call(fn)
                stop.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(stop))
        for name, ts in times.items():
            q1, med, q3 = np.percentile(ts, [25, 50, 75])
            print(f"{args.family} {label} {name}: median {med:.4f} ms (quartiles {q1:.4f}-{q3:.4f})",
                  flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
