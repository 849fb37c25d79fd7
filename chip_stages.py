#!/usr/bin/env python3
"""Measure the flash backward kernels (B2 dK/dV, B3 dQ) by stages on one
NVIDIA GPU, where no profiler reads a kernel's stalls.

    python3 chip_stages.py write TREE OUT [VARIANT ...]
    python3 chip_smoke.py --against OUT/VARIANT --variant --may-differ flash_bwd
    python3 chip_stages.py wgmma

``write`` copies the kernel sources of TREE (a checkout, or a parent
unpacked with ``git archive`` into a git-ignored directory such as
``_archive/``) into OUT/VARIANT/dlrover_tpu_torch/csrc, each with one
stage of the 64-wide head tile's kernels compiled out (VARIANTS; when
none is named, the set that fits TREE's kernels). ``chip_smoke.py
--against`` then times the variant in turns against the checkout it
runs from, and reports how far the variant's outputs moved. The
``bf16-`` set fits the kernels from before the 64-wide head tile had
kernels of its own (the D = 64 instantiations of
``flash_bwd_dkv_bf16_kernel`` and ``flash_bwd_dq_bf16_kernel``), the
``d64-`` set the 64-wide head tile's own kernels.

``wgmma`` builds and runs a microbenchmark of single warpgroup products
(the shapes the kernels issue, shared memory or register A operands,
K- or MN-major B) with one and two warpgroups an SM, and prints the
clocks each takes.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("dlrover_tpu_torch", "csrc")
DKV, DQ = "flash_bwd_dkv.cu", "flash_bwd_dq.cu"


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


for _set in ("bf16", "d64"):  # no products at all; nor exponentials
    VARIANTS[f"{_set}-noproducts"] = _merged(f"{_set}-noscores",
                                             f"{_set}-nograds")
    VARIANTS[f"{_set}-nothing"] = _merged(f"{_set}-noproducts",
                                          f"{_set}-noexp")


def write(tree, out, names):
    if not names:  # the set that fits TREE's kernels
        with open(os.path.join(tree, CSRC, DKV)) as f:
            own = "flash_bwd_dkv_d64_kernel" in f.read()
        names = [n for n in VARIANTS if n.startswith("d64-" if own else
                                                      "bf16-")]
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


def main():
    if len(sys.argv) >= 4 and sys.argv[1] == "write":
        write(sys.argv[2], sys.argv[3], sys.argv[4:])
    elif sys.argv[1:] == ["wgmma"]:
        sys.exit(wgmma())
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
