#!/usr/bin/env python3
"""Measure the flash kernels on the 64-wide head tile (B1 forward, B2
dK/dV, B3 dQ) by stages on one NVIDIA GPU, where no profiler reads a
kernel's stalls.

    python3 chip_stages.py write TREE OUT [VARIANT ...]
    python3 chip_smoke.py --against OUT/VARIANT --variant --may-differ flash_bwd
    python3 chip_smoke.py --against OUT/VARIANT --variant --may-differ flash_fwd
    python3 chip_stages.py wgmma
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
K- or MN-major B) with one and two warpgroups an SM, and prints the
clocks each takes. ``sass`` writes the SASS of TREE's flash kernels
whose mangled names hold a PART and prints their instruction counts.
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


WGMMA_BENCH = r"""
#include <cstdio>
#include "hopper_common.cuh"
using namespace dlr;
constexpr int ITERS = 512;

// KIND: 0 SS m64n64k16, 1 SS m64n128k16 (both K-major), 2 RS m64n64k16
// and 3 SS m64n64k16 with B MN-major, 4 RS m64n128k16 B MN-major, 5 RS
// m64n64k16 B K-major; CHAINS accumulators taken in turn
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
      const uint64_t ka = hop::desc_sw128(s + (kk % 4) * 32, 16, 1024);
      const uint64_t kb = hop::desc_sw128(b + (kk % 4) * 32, 16, 1024);
      const uint64_t mb = hop::desc_sw128(b + kk * 2048, 8192, 1024);
      if constexpr (KIND == 0) hop::wgmma_ss_m64n64k16<0>(h, ka, kb, 1);
      if constexpr (KIND == 1) hop::wgmma_ss_m64n128k16<0>(d, ka, kb, 1);
      if constexpr (KIND == 2) hop::wgmma_rs_m64n64k16<1>(h, a, mb, 1);
      if constexpr (KIND == 3) hop::wgmma_ss_m64n64k16<1>(h, ka, mb, 1);
      if constexpr (KIND == 4) hop::wgmma_rs_m64n128k16<1>(d, a, mb, 1);
      if constexpr (KIND == 5) hop::wgmma_rs_m64n64k16<0>(h, a, kb, 1);
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
void run(const char* name, long long* d, int sms, int wgs) {
  auto k = bench<KIND, CHAINS>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 66560);
  k<<<sms, 256, 66560>>>(d, wgs);
  cudaDeviceSynchronize();
  long long h[2 * 132];
  cudaMemcpy(h, d, sizeof(long long) * 2 * sms, cudaMemcpyDeviceToHost);
  double mean = 0;
  for (int i = 0; i < sms; ++i) mean += h[2 * i];
  printf("%-28s %d accumulator(s), %d warpgroup(s) an SM: %.1f clocks a "
         "wgmma a warpgroup\n", name, CHAINS, wgs, mean / sms / (ITERS * 8.0));
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
  }
  const cudaError_t err = cudaGetLastError();
  printf("cuda: %s\n", cudaGetErrorString(err));
  return err != cudaSuccess;
}
"""


def wgmma():
    """Build WGMMA_BENCH with nvcc for sm_90a and run it."""
    sys.path.insert(0, ROOT)
    from dlrover_tpu_torch.ops import kernel_build

    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "wgmma_bench.cu"), os.path.join(tmp, "wb")
        with open(src, "w") as f:
            f.write(WGMMA_BENCH)
        subprocess.run([kernel_build.nvcc_path(),
                        *kernel_build.NVCC_FLAGS[:4], "-I",
                        os.path.join(ROOT, CSRC), "-o", exe, src], check=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        return subprocess.run([exe], timeout=120).returncode


def sass(tree, out, parts):
    """Build TREE's flash sources into cubins, write the SASS of each
    kernel whose mangled name holds one of ``parts`` to OUT/<name>.sass
    and print, for each, its instructions, those under a predicate, its
    branches, exponentials and wgmma, and what ptxas reports of it."""
    import re

    sys.path.insert(0, ROOT)
    from dlrover_tpu_torch.ops import kernel_build

    nvcc = kernel_build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    os.makedirs(out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for source in (FWD, DKV, DQ):
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
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
