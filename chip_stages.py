#!/usr/bin/env python3
"""Measure the flash kernels on the 64-wide head tile (B1 forward, B2
dK/dV, B3 dQ) by stages on one NVIDIA GPU, where no profiler reads a
kernel's stalls.

    python3 chip_stages.py write TREE OUT [VARIANT ...]
    python3 chip_smoke.py --against OUT/VARIANT --variant --may-differ flash_bwd
    python3 chip_smoke.py --against OUT/VARIANT --variant --may-differ flash_fwd
    python3 chip_stages.py wgmma
    python3 chip_stages.py tf32
    python3 chip_stages.py sass TREE OUT PART [PART ...]
    python3 chip_stages.py timeline OUT/fwd64-timeline

``write`` copies the kernel sources of TREE (a checkout, or a parent
unpacked with ``git archive`` into a git-ignored directory such as
``_archive/``) into OUT/VARIANT/dlrover_tpu_torch/csrc, each with one
stage of the 64-wide head tile's kernels compiled out (VARIANTS; when
none is named, the sets that fit TREE's kernels). ``chip_smoke.py
--against`` then times the variant in turns against the checkout it
runs from, and reports how far the variant's outputs moved. The
``bf16-`` set fits B2 and B3 from before the 64-wide head tile had
kernels of their own (the D = 64 instantiations of
``flash_bwd_dkv_bf16_kernel`` and ``flash_bwd_dq_bf16_kernel``), the
``d64-`` set their own kernels; the ``fwd-`` set fits B1's D = 64
instantiations of ``flash_fwd_bf16_kernel``, the ``fwd64-`` set
``flash_fwd_d64_kernel``.

``wgmma`` builds and runs a microbenchmark of single warpgroup products
(the shapes the kernels issue, shared memory or register A operands,
K- or MN-major B; tf32 with both operands K-major) with one and two
warpgroups an SM, and prints the clocks each takes (and, for tf32, the
rate a warpgroup and an SM). ``tf32`` holds a 3xTF32 warpgroup product
(split, then big*small + small*big + big*big: the design the f32
grouped kernels were measured for and did not take) against the f64
product over K = 4096 and 11008, beside the parent's FFMA loop and
cuBLAS SGEMM with TF32 off. ``sass`` writes the SASS of TREE's flash
and grouped kernels whose mangled names hold a PART and prints their
instruction counts.
``timeline`` runs the ``fwd64-timeline`` variant of B1 at GLM's shape;
one thread of each consumer warpgroup of block 0 keeps its clock at
each item's start, tile and epilogue, and prints the stamps at its end.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("dlrover_tpu_torch", "csrc")
FWD, DKV, DQ = "flash_fwd.cu", "flash_bwd_dkv.cu", "flash_bwd_dq.cu"
GROUPED = ("grouped_matmul_fwd.cu", "grouped_matmul_dw.cu",
           "grouped_matmul_fwd_quant.cu")


def _zero(acc, n):
    return f"    for (int x = 0; x < {n}; ++x) {acc}[x] = 0.f;"


# name: {source: [(text, replacement), ...]}; every text must occur
VARIANTS = {
    "bf16-noexp": {
        DKV: [("float p = hop::ex2(fmaf(sacc[x], scale_log2, (e & 1) ? -l1 "
               ": -l0));",
               "float p = fmaf(sacc[x], scale_log2, (e & 1) ? -l1 : -l0);")],
        DQ: [("float p = hop::ex2(fmaf(sacc[x], scale_log2, (x & 2) ? nl1 : "
              "nl0));",
              "float p = fmaf(sacc[x], scale_log2, (x & 2) ? nl1 : nl0);")],
    },
    "bf16-noscores": {
        DKV: [("    scores<DP>(sacc, sKw, sQ(s));", _zero("sacc", 32)),
              ("    scores<DP>(dpacc, sVw, sdO(s));", _zero("dpacc", 32))],
        DQ: [("    scores<DP>(sacc, sQw, sK(s));", _zero("sacc", "NS")),
             ("    scores<DP>(dpacc, sdOw, sV(s));", _zero("dpacc", "NS"))],
    },
    "bf16-nograds": {
        DKV: [("    grads<DP>(dvacc, pa, sdO(s));\n", ""),
              ("    grads<DP>(dkacc, da, sQ(s));\n", "")],
        DQ: [("    dq_update<DP>(dqacc, da, sK(s));\n", "")],
    },
    "bf16-noring": {  # the first kStages stages loaded once, no waits after
        DKV: [("      for (int t = 0; t < steps; ++t) {\n"
               "        const int s = t % kStages;\n"
               "        const int h = hk * group",
               "      for (int t = 0; t < (SEG ? steps : min(steps, "
               "kStages)); ++t) {\n        const int s = t % kStages;\n"
               "        const int h = hk * group"),
              ("    hop::mbar_wait(&bar.full[s], phase);\n    // keys all "
               "past Sk",
               "    if (SEG || t < kStages) hop::mbar_wait(&bar.full[s], "
               "phase);\n    // keys all past Sk")],
        DQ: [("      for (int j = 0; j < nkt; ++j) {\n"
              "        const int s = j % kStages, jt = k_tile(j);",
              "      for (int j = 0; j < (SEG ? nkt : min(nkt, kStages)); "
              "++j) {\n        const int s = j % kStages, jt = k_tile(j);"),
             ("hop::mbar_wait(&bar.k_full[s], phase);",
              "if (SEG || j < kStages) hop::mbar_wait(&bar.k_full[s], "
              "phase);"),
             ("hop::mbar_wait(&bar.v_full[s], phase);",
              "if (SEG || j < kStages) hop::mbar_wait(&bar.v_full[s], "
              "phase);")],
    },
    "d64-noexp": {
        DKV: [("hop::ex2(fmaf(sacc[x], scale_log2, (e & 1) ? -l1 : -l0))",
               "fmaf(sacc[x], scale_log2, (e & 1) ? -l1 : -l0)")],
        DQ: [("hop::ex2(fmaf(sacc[x], scale_log2, (x & 2) ? nl1 : nl0))",
              "fmaf(sacc[x], scale_log2, (x & 2) ? nl1 : nl0)")],
    },
    "d64-noscores": {
        DKV: [("    scores(sacc, sKw, sQ(s));", _zero("sacc", 64)),
              ("    scores(dpacc, sVw, sdO(s));", _zero("dpacc", 64))],
        DQ: [("    scores<64>(sacc, sQw, sK(s));", _zero("sacc", "NS")),
             ("    scores<64>(dpacc, sdOw, sV(s));", _zero("dpacc", "NS"))],
    },
    "d64-nograds": {
        DKV: [("    grads(dvacc, pa, sdO(s));\n", ""),
              ("    grads(dkacc, da, sQ(s));\n", "")],
        DQ: [("    dq_update<64>(dqacc, da, sK(s));\n", "")],
    },
    "d64-noring": {
        DKV: [("      for (int t = 0; t < steps; ++t) {\n"
               "        const int s = t % kStages;\n"
               "        const int h = hk * group + t / per_head, i = i0 + t "
               "% per_head;",
               "      for (int t = 0; t < min(steps, kStages); ++t) {\n"
               "        const int s = t % kStages;\n"
               "        const int h = hk * group + t / per_head, i = i0 + t "
               "% per_head;"),
              ("    hop::mbar_wait(&bar.full[s], phase);\n"
               "    if (t % per_head < n_skip) {",
               "    if (t < kStages) hop::mbar_wait(&bar.full[s], phase);\n"
               "    if (t % per_head < n_skip) {")],
        DQ: [("      for (int j = 0; j < nkt; ++j) {\n"
              "        const int s = j % kStages;\n",
              "      for (int j = 0; j < min(nkt, kStages); ++j) {\n"
              "        const int s = j % kStages;\n"),
             ("  auto wait_tile = [&](int j) {\n",
              "  auto wait_tile = [&](int j) {\n    if (j >= kStages) return;"
              "\n")],
    },
    # B1 before the 64-wide head tile had a kernel of its own (the D = 64
    # instantiations of flash_fwd_bf16_kernel)
    "fwd-noexp": {
        FWD: [(f"= hop::ex2(fmaf(sacc[4 * c{e}], scale_log2, -ms{r}));",
               f"= fmaf(sacc[4 * c{e}], scale_log2, -ms{r});")
              for e, r in (("", 0), (" + 1", 0), (" + 2", 1), (" + 3", 1))],
    },
    "fwd-noscores": {  # the zeros pass fence_regs: opaque to the compiler
        FWD: [("      hop::wgmma_ss_m64n128k16<0>(\n"
               "          sacc, hop::desc_sw128(sQw + off, 16, 1024),\n"
               "          hop::desc_sw128(sK(s) + off, 16, 1024), kk > 0);",
               "      if (kk == 0) {\n#pragma unroll\n" + _zero("sacc", 64)
               + "\n      }")],
    },
    "fwd-nopv": {  # P's fragments are still made
        FWD: [(f"    pv<DP, {half}>(oacc, pa, sV(s));\n",
               f"#pragma unroll\n    for (int kk = {4 * half}; kk < "
               f"{4 * half + 4}; ++kk) hop::fence_regs(pa[kk]);\n")
              for half in (0, 1)],
    },
    "fwd-nomask": {  # the diagonal, prompt and ragged-end masks
        FWD: [("      if ((jt + 1) * BK > Sk ||\n"
               "          (jt * BK + BK - 1 > i * BQ + wg * 64 && jt * BK + "
               "BK > plen)) {", "      if (false) {"),
              ("    } else if ((jt + 1) * BK > Sk ||\n"
               "               (causal && jt * BK + BK - 1 > i * BQ + wg * "
               "64)) {", "    } else if (false) {")],
    },
    "fwd-noring": {
        FWD: [("      for (int j = 0; j < nkt; ++j) {\n"
               "        const int s = j % kStages, jt = k_tile(j);\n"
               "        int v[BK / 32];",
               "      for (int j = 0; j < (SEG ? nkt : min(nkt, kStages)); "
               "++j) {\n        const int s = j % kStages, jt = k_tile(j);"
               "\n        int v[BK / 32];"),
              ("    hop::mbar_wait(&bar.k_full[s], phase);\n"
               "    hop::wgmma_fence();",
               "    if (SEG || j < kStages) hop::mbar_wait(&bar.k_full[s], "
               "phase);\n    hop::wgmma_fence();"),
              ("    hop::mbar_wait(&bar.v_full[s], phase);\n"
               "    pv<DP, 0>",
               "    if (SEG || j < kStages) hop::mbar_wait(&bar.v_full[s], "
               "phase);\n    pv<DP, 0>")],
    },
    "fwd-onetile": {  # a block's fixed cost: Q, the first K/V, the epilogue
        FWD: [("  if constexpr (SEG) nkt = bar.count;\n",
               "  if constexpr (SEG) nkt = bar.count;\n"
               "  nkt = min(nkt, 1);\n")],
    },
    # B1's own kernel on the 64-wide head tile (flash_fwd_d64_kernel)
    "fwd64-noscores": {
        FWD: [("      hop::wgmma_ss_m64n128k16<0>(\n"
               "          sacc, hop::desc_sw128(sQ(n) + wg * 64 * 128 + kk * "
               "32, 16, 1024),\n"
               "          hop::desc_sw128(sK(s) + kk * 32, 16, 1024), kk > "
               "0);",
               "      if (kk == 0) {\n#pragma unroll\n" + _zero("sacc", 64)
               + "\n      }")],
    },
    "fwd64-nopv": {
        FWD: [(f"pv<64, {half}>(oacc, pa, sV(s));",
               " ".join(f"hop::fence_regs(pa[{kk}]);"
                        for kk in range(4 * half, 4 * half + 4)))
              for half in (0, 1)],
    },
    "fwd64-nomask": {
        FWD: [("if (k_lo + BK > Sk ||", "if (false && (k_lo + BK > Sk ||"),
              ("&& !(PFX && k_lo + BK <= it.plen))) {",
               "&& !(PFX && k_lo + BK <= it.plen)))) {")],
    },
    "fwd64-noring": {  # each block's first kStages tiles loaded once
        FWD: [("          const int s = g % kStages;\n",
               "          const int s = g % kStages;\n"
               "          if (g >= kStages) continue;\n"),
              ("hop::mbar_wait(&bar.v_full[s], phase);\n      pv<64, 0>",
               "if (g + j < kStages) hop::mbar_wait(&bar.v_full[s], phase);"
               "\n      pv<64, 0>"),
              ("hop::mbar_wait(&bar.k_full[gn % kStages], (gn / kStages) & "
               "1);",
               "if (gn < kStages) hop::mbar_wait(&bar.k_full[gn % kStages],"
               " (gn / kStages) & 1);"),
              ("    hop::mbar_wait(&bar.k_full[g % kStages], (g / kStages) & "
               "1);",
               "    if (g < kStages) hop::mbar_wait(&bar.k_full[g % kStages],"
               " (g / kStages) & 1);")],
    },
    "fwd64-onetile": {  # an item's fixed cost: its first tile, its epilogue
        FWD: [("    if (pfx) nkt = max(nkt, (min(max(plen, 0), Sk) + BK - 1) "
               "/ BK);\n",
               "    if (pfx) nkt = max(nkt, (min(max(plen, 0), Sk) + BK - 1) "
               "/ BK);\n    nkt = min(nkt, 1);\n")],
    },
    # P's rounding to bf16: truncated by one byte permute a pair (the
    # conversions' cost; outputs move), or rounded to nearest even on the
    # integer pipes (bit for bit for P's finite values >= 0)
    "fwd64-truncp": {
        FWD: [("hop::acc_to_a(sacc, kk, pa[kk]);",
               "{\n#pragma unroll\n  for (int r = 0; r < 4; ++r) "
               "pa[kk][r] = __byte_perm(__float_as_uint(sacc[8 * kk + 2 * "
               "r]), __float_as_uint(sacc[8 * kk + 2 * r + 1]), 0x7632);\n}")],
    },
    "fwd64-introundp": {
        FWD: [("hop::acc_to_a(sacc, kk, pa[kk]);",
               "{\n#pragma unroll\n  for (int r = 0; r < 4; ++r) {\n"
               "    uint32_t lo = __float_as_uint(sacc[8 * kk + 2 * r]), hi "
               "= __float_as_uint(sacc[8 * kk + 2 * r + 1]);\n"
               "    lo += 0x7fffu + ((lo >> 16) & 1u);\n"
               "    hi += 0x7fffu + ((hi >> 16) & 1u);\n"
               "    pa[kk][r] = __byte_perm(lo, hi, 0x7632);\n  }\n}")],
    },
    # one thread of each consumer warpgroup of block 0 keeps the clock at
    # each item's start, each tile and each epilogue, and prints them
    # after its last item (``timeline``, not ``--against``)
    "fwd64-timeline": {
        FWD: [("#include <type_traits>\n",
               "#include <cstdio>\n#include <type_traits>\n"),
              ("  float sacc[64];        // S of the tile, then its P\n",
               "  float sacc[64];        // S of the tile, then its P\n"
               "  constexpr int kStamps = 512;\n"
               "  long long stamps[kStamps];\n  int tags[kStamps], ns = 0;\n"
               "  auto stamp = [&](int what) {\n"
               "    if (blockIdx.x == 0 && t == 0 && ns < kStamps) {\n"
               "      stamps[ns] = clock64();\n      tags[ns++] = what;\n"
               "    }\n  };\n"),
              ("    const Item it(w, H, Sq, Sk, causal, prefix_len, PFX);\n"
               "    const int q_lo",
               "    const Item it(w, H, Sq, Sk, causal, prefix_len, PFX);\n"
               "    stamp(2);\n    const int q_lo"),
              ("      const int s = (g + j) % kStages, phase = ((g + j) / "
               "kStages) & 1;\n",
               "      const int s = (g + j) % kStages, phase = ((g + j) / "
               "kStages) & 1;\n      stamp(0);\n"),
              ("    g += it.nkt;\n", "    g += it.nkt;\n    stamp(1);\n"),
              ("    }\n  }\n}\n\ntemplate <bool PFX>\nint launch(",
               "    }\n  }\n  for (int k = 0; k < ns; ++k) {\n"
               "    printf(\"T %d %d %lld\\n\", wg, tags[k], stamps[k]);\n"
               "  }\n}\n\ntemplate <bool PFX>\nint launch(")],
    },
    "d64-noturns": {  # B3's warpgroups issue whenever they are ready
        DQ: [("  auto turn = [&]() { hop::bar_sync(kTurnBar + wg, 256); };\n"
              "  auto pass = [&]() { hop::bar_arrive(kTurnBar + 1 - wg, "
              "256); };\n",
              "  auto turn = [&]() {};\n  auto pass = [&]() {};\n")],
    },
}


def _merged(*names):
    """The variant with every stage of ``names`` compiled out."""
    out = {}
    for name in names:
        for source, pairs in VARIANTS[name].items():
            out.setdefault(source, []).extend(pairs)
    return out


VARIANTS["fwd64-noexp"] = VARIANTS["fwd-noexp"]  # softmax_step is shared
# no products at all; nor exponentials
for _set, _products in (("bf16", "nograds"), ("d64", "nograds"),
                        ("fwd", "nopv"), ("fwd64", "nopv")):
    VARIANTS[f"{_set}-noproducts"] = _merged(f"{_set}-noscores",
                                             f"{_set}-{_products}")
    VARIANTS[f"{_set}-nothing"] = _merged(f"{_set}-noproducts",
                                          f"{_set}-noexp")


def fitting_sets(tree):
    """The variant sets that fit TREE's kernels: ``d64-`` where the
    64-wide head tile's backward has kernels of its own, else ``bf16-``;
    ``fwd64-`` where its forward has, else ``fwd-``."""
    def has(source, kernel):
        with open(os.path.join(tree, CSRC, source)) as f:
            return kernel in f.read()

    return ("d64-" if has(DKV, "flash_bwd_dkv_d64_kernel") else "bf16-",
            "fwd64-" if has(FWD, "flash_fwd_d64_kernel") else "fwd-")


def write(tree, out, names):
    if not names:  # the sets that fit TREE's kernels
        names = [n for n in VARIANTS if n.startswith(fitting_sets(tree))]
    for name in names:
        dst = os.path.join(out, name, CSRC)
        shutil.rmtree(os.path.join(out, name), ignore_errors=True)
        shutil.copytree(os.path.join(tree, CSRC), dst,
                        ignore=shutil.ignore_patterns("_build"))
        for source, pairs in VARIANTS[name].items():
            path = os.path.join(dst, source)
            with open(path) as f:
                text = f.read()
            for old, new in pairs:
                if old not in text:
                    sys.exit(f"{name}: {source} has no {old!r}")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
        print(os.path.join(out, name))


TF32_WGMMA = r"""
namespace dlr {
namespace hop {

// tf32 wgmma, for the microbenchmarks below (no kernel of the port uses it).
//
// D[64 x N] += A[64 x 8] B[8 x N] with tf32 operands (an f32 bit pattern
// whose low 13 mantissa bits the tensor core ignores) and f32
// accumulation. PTX gives .tf32 no transpose bit: both shared-memory
// operands are K-major, a row of 32 f32 of k = 128 bytes, the SW128
// layout of a bf16 tile with 64 k (desc_sw128(addr + kk * 32, 16, 1024)
// is k8 step kk, as a k16 step of bf16). The register A fragment
// (m64k8, four b32 a thread) holds, for thread t of the warpgroup, warp
// w = t / 32, lane l: a[0] row 16 w + l / 4, column l % 4; a[1] that row
// + 8; a[2] and a[3] the same rows at column l % 4 + 4.

__device__ __forceinline__ void wgmma_ss_m64n128k8_tf32(float (&d)[64],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63},\n"
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_m64n128k8_tf32(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63},\n"
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_m64n256k8_tf32(float (&d)[128],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63,\n"
      "%64, %65, %66, %67, %68, %69, %70, %71,\n"
      "%72, %73, %74, %75, %76, %77, %78, %79,\n"
      "%80, %81, %82, %83, %84, %85, %86, %87,\n"
      "%88, %89, %90, %91, %92, %93, %94, %95,\n"
      "%96, %97, %98, %99, %100, %101, %102, %103,\n"
      "%104, %105, %106, %107, %108, %109, %110, %111,\n"
      "%112, %113, %114, %115, %116, %117, %118, %119,\n"
      "%120, %121, %122, %123, %124, %125, %126, %127},\n"
      "%128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_m64n256k8_tf32(float (&d)[128],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63,\n"
      "%64, %65, %66, %67, %68, %69, %70, %71,\n"
      "%72, %73, %74, %75, %76, %77, %78, %79,\n"
      "%80, %81, %82, %83, %84, %85, %86, %87,\n"
      "%88, %89, %90, %91, %92, %93, %94, %95,\n"
      "%96, %97, %98, %99, %100, %101, %102, %103,\n"
      "%104, %105, %106, %107, %108, %109, %110, %111,\n"
      "%112, %113, %114, %115, %116, %117, %118, %119,\n"
      "%120, %121, %122, %123, %124, %125, %126, %127},\n"
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// x rounded to tf32 (10 explicit mantissa bits), to nearest, ties away
// from zero: its low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}


}  // namespace hop
}  // namespace dlr
"""


WGMMA_BENCH = r"""
#include <cstdio>
#include "hopper_common.cuh"
%s
using namespace dlr;
constexpr int ITERS = 512;

// KIND: 0 SS m64n64k16, 1 SS m64n128k16 (both K-major), 2 RS m64n64k16
// and 3 SS m64n64k16 with B MN-major, 4 RS m64n128k16 B MN-major, 5 RS
// m64n64k16 B K-major; tf32, both K-major: 6 SS m64n128k8, 7 SS
// m64n256k8, 8 RS m64n128k8, 9 RS m64n256k8; CHAINS accumulators taken
// in turn
template <int KIND, int CHAINS>
__global__ void bench(long long* out, int wgs) {
  extern __shared__ __align__(1024) unsigned char smem[];
  for (int i = threadIdx.x; i < 65536 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(smem)[i] = 0;
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg >= wgs) return;
  const uint32_t s = hop::smem_u32(smem), b = s + 16384;
  float acc[2][64];
  for (int c = 0; c < 2; ++c)
    for (int x = 0; x < 64; ++x) acc[c][x] = 0.f;
  const uint32_t a[4] = {0, 0, 0, 0};
  const long long t0 = clock64();
  for (int it = 0; it < ITERS; ++it) {
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float (&d)[64] = acc[CHAINS == 2 ? (kk & 1) : 0];
      float (&h)[32] = *reinterpret_cast<float(*)[32]>(&d);
      float (&w)[128] = *reinterpret_cast<float(*)[128]>(&acc[0][0]);
      const uint64_t ka = hop::desc_sw128(s + (kk % 4) * 32, 16, 1024);
      const uint64_t kb = hop::desc_sw128(b + (kk % 4) * 32, 16, 1024);
      const uint64_t mb = hop::desc_sw128(b + kk * 2048, 8192, 1024);
      if constexpr (KIND == 0) hop::wgmma_ss_m64n64k16<0>(h, ka, kb, 1);
      if constexpr (KIND == 1) hop::wgmma_ss_m64n128k16<0>(d, ka, kb, 1);
      if constexpr (KIND == 2) hop::wgmma_rs_m64n64k16<1>(h, a, mb, 1);
      if constexpr (KIND == 3) hop::wgmma_ss_m64n64k16<1>(h, ka, mb, 1);
      if constexpr (KIND == 4) hop::wgmma_rs_m64n128k16<1>(d, a, mb, 1);
      if constexpr (KIND == 5) hop::wgmma_rs_m64n64k16<0>(h, a, kb, 1);
      if constexpr (KIND == 6) hop::wgmma_ss_m64n128k8_tf32(d, ka, kb, 1);
      if constexpr (KIND == 7) hop::wgmma_ss_m64n256k8_tf32(w, ka, kb, 1);
      if constexpr (KIND == 8) hop::wgmma_rs_m64n128k8_tf32(d, a, kb, 1);
      if constexpr (KIND == 9) hop::wgmma_rs_m64n256k8_tf32(w, a, kb, 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    for (int c = 0; c < 2; ++c) hop::fence_regs(acc[c]);
  }
  const long long t1 = clock64();
  float sum = 0.f;
  for (int c = 0; c < 2; ++c)
    for (int x = 0; x < 64; ++x) sum += acc[c][x];
  if (threadIdx.x % 128 == 0)
    out[blockIdx.x * 2 + wg] = (t1 - t0) + (sum != 0.f);
}

template <int KIND, int CHAINS>
void run(const char* name, long long* d, int sms, int wgs, double flop = 0) {
  auto k = bench<KIND, CHAINS>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 66560);
  k<<<sms, 256, 66560>>>(d, wgs);
  cudaDeviceSynchronize();
  long long h[2 * 132];
  cudaMemcpy(h, d, sizeof(long long) * 2 * sms, cudaMemcpyDeviceToHost);
  double mean = 0;
  for (int i = 0; i < sms; ++i) mean += h[2 * i];
  const double clocks = mean / sms / (ITERS * 8.0);
  printf("%-28s %d accumulator(s), %d warpgroup(s) an SM: %.1f clocks a "
         "wgmma a warpgroup", name, CHAINS, wgs, clocks);
  if (flop > 0) {
    // the rate at the SM clock the device reports, every SM issuing
    int khz = 0, all = 0;
    cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
    cudaDeviceGetAttribute(&all, cudaDevAttrMultiProcessorCount, 0);
    const double per_sm = wgs * flop / clocks;  // FLOP a clock an SM
    printf(" (%.0f FLOP a clock a warpgroup, %.0f an SM; %.1f TFLOP/s on "
           "%d SMs at %d MHz)", flop / clocks, per_sm,
           per_sm * all * khz * 1e3 / 1e12, all, khz / 1000);
  }
  printf("\n");
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  sms = sms > 132 ? 132 : sms;
  long long* d;
  cudaMalloc(&d, 2 * 132 * sizeof(long long));
  for (int wgs = 1; wgs <= 2; ++wgs) {
    run<0, 1>("SS m64n64k16, K-major", d, sms, wgs);
    run<0, 2>("SS m64n64k16, K-major", d, sms, wgs);
    run<1, 1>("SS m64n128k16, K-major", d, sms, wgs);
    run<3, 1>("SS m64n64k16, B MN-major", d, sms, wgs);
    run<2, 1>("RS m64n64k16, B MN-major", d, sms, wgs);
    run<2, 2>("RS m64n64k16, B MN-major", d, sms, wgs);
    run<5, 1>("RS m64n64k16, B K-major", d, sms, wgs);
    run<4, 1>("RS m64n128k16, B MN-major", d, sms, wgs);
    run<6, 1>("tf32 SS m64n128k8", d, sms, wgs, 2.0 * 64 * 128 * 8);
    run<7, 1>("tf32 SS m64n256k8", d, sms, wgs, 2.0 * 64 * 256 * 8);
    run<8, 1>("tf32 RS m64n128k8", d, sms, wgs, 2.0 * 64 * 128 * 8);
    run<9, 1>("tf32 RS m64n256k8", d, sms, wgs, 2.0 * 64 * 256 * 8);
  }
  const cudaError_t err = cudaGetLastError();
  printf("cuda: %s\n", cudaGetErrorString(err));
  return err != cudaSuccess;
}
"""


TF32_CHECK = r"""
#include "hopper_common.cuh"
%s
using namespace dlr;

// C [64 gridDim.x, 128] = A [64 gridDim.x, K] B [K, 128], A K-major, B
// N-major (the layout of w in y = x w[e]): block b owns rows 64 b + [0,
// 64). Each k block of 32 is split into tf32 big = rna(x) and small =
// rna(x - big) and written K-major in the SW128 layout (B transposed);
// one warpgroup then accumulates, for each k8 step, big*small +
// small*big + big*big (MODE 0, in the wgmma accumulator; MODE 1, each
// k block's products in a fresh accumulator added to a register total
// with FADD; MODE 3, each product of each k8 step alone in a fresh
// accumulator, added with FADD; MODE 4, each k8 step's big*big alone in
// a fresh accumulator added with FADD, the small products of a k block
// in a second fresh accumulator added once) or big*big alone (MODE 2,
// 1xTF32). RS takes A's fragments
// from registers, else from shared memory.
template <int RS, int MODE>
__global__ void __launch_bounds__(128) tf32_tile(const float* A,
                                                 const float* B, float* C,
                                                 int K) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint32_t* ab = reinterpret_cast<uint32_t*>(smem);  // [64][32]
  uint32_t* as = ab + 2048;
  uint32_t* bb = as + 2048;  // [128][32]
  uint32_t* bs = bb + 4096;
  const uint32_t s_ab = hop::smem_u32(ab), s_as = hop::smem_u32(as);
  const uint32_t s_bb = hop::smem_u32(bb), s_bs = hop::smem_u32(bs);
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  const float* a = A + (size_t)blockIdx.x * 64 * K;
  float acc[64], part[64];
  for (int x = 0; x < 64; ++x) acc[x] = part[x] = 0.f;
  auto at = [](int row, int k) {  // word offset in an SW128 K-major tile
    return row * 32 + (((k / 4) ^ (row % 8)) * 4) + k % 4;
  };
  for (int k0 = 0; k0 < K; k0 += 32) {
    __syncthreads();
    for (int i = t; i < 32 * 128; i += 128) {
      const int k = i / 128, n = i % 128;
      const float x = k0 + k < K ? B[(size_t)(k0 + k) * 128 + n] : 0.f;
      const uint32_t big = hop::tf32_rna(x);
      bb[at(n, k)] = big;
      bs[at(n, k)] = hop::tf32_rna(x - __uint_as_float(big));
    }
    for (int i = t; i < 64 * 32; i += 128) {
      const int m = i / 32, k = i % 32;
      const float x = k0 + k < K ? a[(size_t)m * K + k0 + k] : 0.f;
      const uint32_t big = hop::tf32_rna(x);
      ab[at(m, k)] = big;
      as[at(m, k)] = hop::tf32_rna(x - __uint_as_float(big));
    }
    hop::fence_async_shared();
    __syncthreads();
    uint32_t fb[4][4], fs[4][4];
    for (int kk = 0; kk < 4; ++kk) {
      for (int j = 0; j < 4; ++j) {
        const int row = 16 * w + l / 4 + 8 * (j % 2);
        const int k = 8 * kk + l % 4 + 4 * (j / 2);
        fb[kk][j] = ab[at(row, k)];
        fs[kk][j] = as[at(row, k)];
      }
    }
    if constexpr (MODE == 3 || MODE == 4) {
      float sm[64];
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = hop::desc_sw128(s_bb + kk * 32, 16, 1024);
        const uint64_t ds = hop::desc_sw128(s_bs + kk * 32, 16, 1024);
        for (int p = MODE == 3 ? 0 : 2; p < 3; ++p) {
          hop::wgmma_fence();
          hop::fence_regs(part);
          if (p == 0) hop::wgmma_rs_m64n128k8_tf32(part, fb[kk], ds, 0);
          if (p == 1) hop::wgmma_rs_m64n128k8_tf32(part, fs[kk], db, 0);
          if (p == 2) hop::wgmma_rs_m64n128k8_tf32(part, fb[kk], db, 0);
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::fence_regs(part);
          for (int x = 0; x < 64; ++x) acc[x] += part[x];
        }
        if constexpr (MODE == 4) {
          hop::wgmma_fence();
          hop::fence_regs(sm);
          hop::wgmma_rs_m64n128k8_tf32(sm, fb[kk], ds, kk > 0);
          hop::wgmma_rs_m64n128k8_tf32(sm, fs[kk], db, 1);
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::fence_regs(sm);
        }
      }
      if constexpr (MODE == 4) {
        for (int x = 0; x < 64; ++x) acc[x] += sm[x];
      }
      continue;
    }
    float (&d)[64] = MODE == 1 ? part : acc;
    hop::wgmma_fence();
    hop::fence_regs(d);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = hop::desc_sw128(s_bb + kk * 32, 16, 1024);
      const uint64_t ds = hop::desc_sw128(s_bs + kk * 32, 16, 1024);
      const uint64_t da = hop::desc_sw128(s_ab + kk * 32, 16, 1024);
      const uint64_t da_s = hop::desc_sw128(s_as + kk * 32, 16, 1024);
      const int fresh = MODE == 1 && kk == 0 ? 0 : 1;
      if constexpr (MODE != 2) {
        if constexpr (RS) {
          hop::wgmma_rs_m64n128k8_tf32(d, fb[kk], ds, fresh);
          hop::wgmma_rs_m64n128k8_tf32(d, fs[kk], db, 1);
        } else {
          hop::wgmma_ss_m64n128k8_tf32(d, da, ds, fresh);
          hop::wgmma_ss_m64n128k8_tf32(d, da_s, db, 1);
        }
      }
      const int again = MODE == 2 ? fresh : 1;
      if constexpr (RS) {
        hop::wgmma_rs_m64n128k8_tf32(d, fb[kk], db, again);
      } else {
        hop::wgmma_ss_m64n128k8_tf32(d, da, db, again);
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(d);
    if constexpr (MODE == 1) {
      for (int x = 0; x < 64; ++x) acc[x] += part[x];
    }
  }
  float* c = C + (size_t)blockIdx.x * 64 * 128;
  for (int i = 0; i < 16; ++i) {
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w + l / 4 + 8 * h, col = 8 * i + 2 * (l % 4);
      c[row * 128 + col] = acc[4 * i + 2 * h];
      c[row * 128 + col + 1] = acc[4 * i + 2 * h + 1];
    }
  }
}

// The f32 grouped kernels' arithmetic: each output a chain of fmaf over
// k in order (stage_fma of grouped_common.cuh).
__global__ void ffma_tile(const float* A, const float* B, float* C, int K) {
  const int m = blockIdx.x, n = threadIdx.x;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    acc = fmaf(A[(size_t)m * K + k], B[(size_t)k * 128 + n], acc);
  }
  C[(size_t)m * 128 + n] = acc;
}

template <int RS, int MODE>
int run(const float* A, const float* B, float* C, int M, int K) {
  auto k = tf32_tile<RS, MODE>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       49152 + 1024);
  k<<<M / 64, 128, 49152 + 1024>>>(A, B, C, K);
  return (int)cudaGetLastError();
}

extern "C" int tf32_check(const float* A, const float* B, float* C, int M,
                          int K, int variant) {
  switch (variant) {
    case 0: return run<1, 0>(A, B, C, M, K);
    case 1: return run<0, 0>(A, B, C, M, K);
    case 2: return run<1, 1>(A, B, C, M, K);
    case 3: return run<1, 2>(A, B, C, M, K);
    case 5: return run<1, 3>(A, B, C, M, K);
    case 6: return run<1, 4>(A, B, C, M, K);
    default:
      ffma_tile<<<M, 128>>>(A, B, C, K);
      return (int)cudaGetLastError();
  }
}
"""
# (variant of tf32_check, what it computes)
TF32_VARIANTS = (
    (0, "3xTF32, A from registers (RS), wgmma accumulator"),
    (1, "3xTF32, A from shared memory (SS), wgmma accumulator"),
    (2, "3xTF32, RS, each k block of 32 into a fresh accumulator, FADD "
        "into a register total"),
    (3, "1xTF32 (big*big alone), RS"),
    (4, "the parent's FFMA loop (fmaf over k in order)"),
    (5, "3xTF32, RS, each product of each k8 step in a fresh accumulator, "
        "FADD into a register total"),
    (6, "3xTF32, RS, each k8 step's big*big in a fresh accumulator, FADD; "
        "a k block's small products in another, FADD once"),
)


def tf32():
    """Build TF32_CHECK for sm_90a and hold each variant, the parent's
    FFMA loop and cuBLAS SGEMM (TF32 off) against the f64 product of the
    same f32 inputs at K = 4096 and 11008: norm ratio, bias
    (``flash_check.bias``) and largest error. A ~ N(0, 1) [1024, K] (the
    x of y = x w[e]), B ~ N(0, 1 / K) [K, 128] (a slice of w)."""
    import ctypes

    import torch

    sys.path.insert(0, ROOT)
    from dlrover_tpu_torch.ops import flash_check, kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "tf32.cu"), os.path.join(tmp, "tf32.so")
        with open(src, "w") as f:
            f.write(TF32_CHECK.replace("%s", TF32_WGMMA, 1))
        subprocess.run([kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS,
                        "-I", os.path.join(ROOT, CSRC), "-o", lib, src],
                       check=True)
        fn = ctypes.CDLL(lib).tf32_check
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        gen = torch.Generator(device="cuda").manual_seed(0)
        m = 1024
        for k in (4096, 11008):
            a = torch.randn(m, k, device="cuda", generator=gen)
            b = torch.randn(k, 128, device="cuda", generator=gen) * k ** -0.5
            ref = a.double() @ b.double()
            got = {"cuBLAS SGEMM, TF32 off": a @ b}
            for variant, label in TF32_VARIANTS:
                c = torch.empty(m, 128, device="cuda")
                code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, k,
                          variant)
                torch.cuda.synchronize()
                if code:
                    sys.exit(f"{label}: launch failed ({code})")
                got[label] = c
            for label, c in got.items():
                err = c.double() - ref
                print(f"K={k} {label}: norm ratio "
                      f"{(err.norm() / ref.norm()).item():.3e}, bias "
                      f"{flash_check.bias(c, ref):.3e}, max abs err "
                      f"{err.abs().max().item():.3e}", flush=True)


def wgmma():
    """Build WGMMA_BENCH with nvcc for sm_90a and run it."""
    sys.path.insert(0, ROOT)
    from dlrover_tpu_torch.ops import kernel_build

    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "wgmma_bench.cu"), os.path.join(tmp, "wb")
        with open(src, "w") as f:
            f.write(WGMMA_BENCH.replace("%s", TF32_WGMMA, 1))
        subprocess.run([kernel_build.nvcc_path(),
                        *kernel_build.NVCC_FLAGS[:4], "-I",
                        os.path.join(ROOT, CSRC), "-o", exe, src], check=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        return subprocess.run([exe], timeout=120).returncode


def sass(tree, out, parts):
    """Build TREE's flash and grouped sources into cubins, write the SASS
    of each kernel whose mangled name holds one of ``parts`` to
    OUT/<name>.sass and print, for each, its instructions, those under a
    predicate, its branches, exponentials, wgmma, FFMA, shared-memory
    loads (all, and the 16-byte ones) and stores, and what ptxas reports
    of it."""
    import re

    sys.path.insert(0, ROOT)
    from dlrover_tpu_torch.ops import kernel_build

    nvcc = kernel_build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    os.makedirs(out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for source in (FWD, DKV, DQ, *GROUPED):
            cubin = os.path.join(tmp, source + ".cubin")
            built = subprocess.run(
                [nvcc, "-cubin", *kernel_build.NVCC_FLAGS[:4], "-Xptxas",
                 "-v", "-o", cubin, os.path.join(tree, CSRC, source)],
                capture_output=True, text=True, check=True)
            text = subprocess.run([cuobjdump, "-sass", cubin],
                                  capture_output=True, text=True,
                                  check=True).stdout
            for part in text.split("Function : ")[1:]:
                name, _, body = part.partition("\n")
                name = name.strip()
                if not any(p in name for p in parts):
                    continue
                key = name.split("EEv")[0]
                with open(os.path.join(out, key + ".sass"), "w") as f:
                    f.write(body)
                ins = [line.split("*/", 1)[1].strip()
                       for line in body.splitlines()
                       if re.match(r"\s*/\*[0-9a-f]{4}\*/", line)]
                count = {
                    "instructions": len(ins),
                    "predicated": sum(i.startswith("@") for i in ins),
                    "branches": sum(" BRA " in f" {i} " for i in ins),
                    "exponentials": sum("MUFU.EX2" in i for i in ins),
                    "wgmma": sum("HGMMA" in i for i in ins),
                    "ffma": sum(i.startswith("FFMA") or " FFMA" in i
                                for i in ins),
                    "lds": sum("LDS" in i for i in ins),
                    "lds128": sum("LDS.128" in i for i in ins),
                    "sts": sum("STS" in i for i in ins),
                }
                ptxas = [line.strip() for line in (
                    built.stdout + built.stderr).split(
                        "Compiling entry function")
                         if f"'{name}'" in line]
                print(f"{key}: " + ", ".join(
                    f"{n} {v}" for n, v in count.items()), flush=True)
                for line in ptxas[:1]:
                    for detail in line.splitlines()[1:]:
                        if "registers" in detail or "spill" in detail:
                            print(f"  {detail.strip()}", flush=True)


def _timeline_launch(tree):
    """Build TREE's flash_fwd.cu (a ``fwd64-timeline`` variant) and run
    B1 twice at GLM's shape, [4, 64, 2048, 64] bf16, causal; the kernel
    prints its own clock stamps."""
    import ctypes

    import torch

    sys.path.insert(0, ROOT)
    from dlrover_tpu_torch.ops import kernel_build

    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "fwd.so")
        built = subprocess.run(
            [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, "-o", lib,
             os.path.join(tree, CSRC, FWD)], capture_output=True, text=True)
        if built.returncode:
            sys.exit(built.stdout + built.stderr)
        fn = ctypes.CDLL(lib).dlr_flash_fwd_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(4, 64, 2048, 64, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        o, lse = torch.empty_like(q), torch.empty(4, 64, 2048,
                                                   device="cuda")
        for _ in range(2):  # the second launch's stamps are warm
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      lse.data_ptr(), 4, 64, 64, 2048, 2048, 64, 0.125, 1,
                      torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            print(f"launch rc={code}", flush=True)


def timeline(tree):
    """Run ``_timeline_launch`` in a child (the kernel's stamps reach the
    child's standard output) and print, for each consumer warpgroup of
    block 0 in the second launch, the median clocks from an item's start
    to its first tile, of a tile, and from an epilogue to the next
    item's start, and each one's share of the block."""
    import statistics

    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "timeline-launch", tree], capture_output=True,
                         text=True, timeout=300)
    print(out.stdout + out.stderr, end="", flush=True)
    launches = out.stdout.split("launch rc=")
    if out.returncode or len(launches) < 3:
        sys.exit("the timeline launch failed")
    stamps = [tuple(map(int, line.split()[1:])) for line in
              launches[1].splitlines()[1:] if line.startswith("T ")]
    for wg in sorted({w for w, _, _ in stamps}):
        mine = [(tag, clock) for w, tag, clock in stamps if w == wg]
        spans = {0: [], 1: [], 2: []}  # tile, epilogue, item start
        for (tag, clock), (_, after) in zip(mine, mine[1:]):
            spans[tag].append(after - clock)
        total = mine[-1][1] - mine[0][1]
        print(f"warpgroup {wg}: {total} clocks; " + "; ".join(
            f"{name} median {statistics.median(spans[tag]):.0f} clocks "
            f"(x {len(spans[tag])}, {sum(spans[tag]) / total:.3f})"
            for tag, name in ((2, "item start to its first tile"),
                              (0, "tile"), (1, "epilogue to next item"))
            if spans[tag]), flush=True)


def main():
    if len(sys.argv) >= 4 and sys.argv[1] == "write":
        write(sys.argv[2], sys.argv[3], sys.argv[4:])
    elif len(sys.argv) >= 5 and sys.argv[1] == "sass":
        sass(sys.argv[2], sys.argv[3], sys.argv[4:])
    elif len(sys.argv) == 3 and sys.argv[1] == "timeline":
        timeline(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "timeline-launch":
        _timeline_launch(sys.argv[2])
    elif sys.argv[1:] == ["wgmma"]:
        sys.exit(wgmma())
    elif sys.argv[1:] == ["tf32"]:
        tf32()
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
