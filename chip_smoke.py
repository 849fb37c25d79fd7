#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]   # from the root of a checkout
    python3 chip_smoke.py --only-serving [--json PATH]
    python3 chip_smoke.py --against DIR [--may-differ PART ...]
                          [--variant] [--stress N]

Phases, each of which fails the run (exit code 1) when it goes wrong:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every kernel from dlrover_tpu_torch/csrc with nvcc, one
     process per source, all at once;
  3. hold each flash kernel (B1 forward, B2 dK/dV, B3 dQ) against its
     plain PyTorch version on the card: at the main path's shape (bf16,
     causal GQA 32/8, S=4096, D=128), on ragged f32 and bf16 GQA cases,
     and on the edges of B1's bf16 tiles (D=64, D=80 padded to 128, D=16,
     32 and 48 below the 64-wide tile, a ragged q tile beside a head
     boundary, cross attention, S=129, B2's GQA groups of 1 and 8, and
     B3's q tile of 40 rows),
     at the MoE path's 32/32 heads (S=4096, and an expert-parallel
     rank's 1024), and at S=8192 and 16384 (group 4), every bf16 output
     row by row and by its bias (the signed error projected on the plain
     output); and show that the row rule rejects outputs with planted
     faults and the bias rule outputs with P, P^T, dS^T or dS truncated
     to bf16;
  4. time each flash kernel (median of 10 device samples; beside it,
     ``device_ms``, the same with the device spinning while the host
     queues the calls, which reads the kernels alone), its plain
     version and PyTorch's scaled_dot_product_attention (a yardstick the
     port never calls), beside the least time the card could take, as a
     share of that bound and a ratio to SDPA's forward or backward: at
     the main path's 32/8 heads and at the MoE cell's 32/32;
  5. train Llama-3-8B at full width (4 layers, batch 1, seq 4096) for a
     few steps through TrainExecutor + ElasticTrainer with the flash
     kernels and the default dispatch window, counting their launches,
     with the attribution record (FLOPs and bytes counted on the meta
     device) and the live MFU gauge; then profile a few more steps: the
     trace exported and read by telemetry.attribution (device-time
     buckets, kernel groups, each flash kernel's device time per step,
     the device's gaps), its busy time within 1 % of key_averages';
  6. one forward and backward of the same model with use_flash=True
     against the reference attention (use_flash=False): every gradient
     on one batch; then the FSDP wire variants (fsdp_precision fp8,
     fp8_qdq and bf16 on the same weights and batch): the fp8 probe
     passing on the card and each run's effective precision the one
     asked for, fp8 and fp8_qdq bit for bit (loss and every gradient),
     bf16 against fp8 within WIRE_DRIFT, gradients finite, B1-B3
     launches pinned in each, and the wires' device time (the stack's
     quantize, each layer's decode, the gradient wire's error feedback);
     then the loss of each path, and of forwards with planted faults,
     against an exact (f32) attention's over 64 batches: the sound paths
     within the limits, the faulty ones beyond them;
  7. the grouped-matmul kernels (B4 forward and dX, B5 dW) against their
     plain versions at the MoE path's shape (llama2_7b+moe8: 4096 tokens
     routed top-2 over 8 experts, D=4096, F=11008), on a skewed routing
     and on a ragged f32 case, every bf16 output row by row and by its
     bias; the planted faults an expert boundary invites, and truncation
     controls the bias rule must reject; one MoE layer's forward and
     backward with host syncs forbidden; the kernels' times at the up
     and the down projection beside their bound, their plain versions
     and torch._grouped_mm (a yardstick the port never calls);
  8. train llama2_7b with 8 experts (top-2, dropless grouped dispatch)
     at full width (2 layers, batch 1, seq 4096) for a few steps the
     same way, counting the launches of all five kernels; profile;
  9. one forward and backward of that model, grouped dispatch against
     the capacity "gather" dispatch at a capacity nothing overflows;
 10. B6, the dequant-in-kernel grouped matmul of the expert-parallel fp8
     wire, against its plain version and bit for bit against dequantize
     + B4's f32 path, without and with the layout's live_rows (rows past
     it zero), on the rows rank 0 of 4 receives (llama2_7b+moe8 widths,
     4 x 1024 tokens top-2, 2 local experts), on a skewed routing and a
     ragged case, each followed by a stress loop (STRESS_CALLS calls of
     B6 and of B4's f32 path, every output bit for bit and within 1e-4 of
     the plain version); its planted faults; on the main layout B6, B4's
     four f32 forms (the up and down projections' y, dx through w_down^T
     and w_up^T) and B5's two (dw at the up and the down projection),
     each checked against its plain version with and without live_rows,
     their errors against an f64 product beside the plain versions', and
     their times (both clocks, with and without live_rows) beside the
     plain version, a per-expert cuBLAS loop (TF32 off) over the rows
     given and the live rows, and two bounds (FFMA at 67 TFLOP/s, the
     design kept, and 3xTF32 at 494.7) over the rows given and the live
     rows;
 11. one full-width MoE layer over 4 ranks sharing the card (gloo),
     forward and backward: the fp8 wire bitwise equal to fp8_qdq at 1
     and 2 chunks; the unquantized wire against the one-rank grouped
     dispatch;
 12. the expert-parallel main path: examples/train_llama.py on 4 ranks
     (llama2_7b+moe8 x 2 layers, grouped_ep, fp8 wire, global batch
     4 x 1024; the example's mesh, (data, fsdp) = (2, 2)), four steps (rank 0's last under torch.profiler), every
     rank's launches of all six kernels pinned;
 13. packed documents (segment ids): B1-B3 in their segment-id mode
     against their plain versions at the main shape, row by row and by
     the bias rule, on the packed training layout, on documents of 512
     tokens (boundaries on tile edges) and of 700 (inside tiles), on a
     row with a -1 pad tail, on the row's documents shuffled under
     permuted ids (one recurring far apart), on the row cut to 4000
     tokens, on a pair-form case whose rows partly see no key, on one
     whose later keys carry ids no row has (blocks of B1, B2 and B3
     with empty tile lists; B1's rows there must read out 0 and lse
     NEG_INF), and in f32 on a ragged case, with the tiles B1, B2 and
     B3 list on each layout against the causal tiles (counted on the
     host from the same table); planted
     controls (a segment mask shifted by one key, ids ignored) the row
     rule must reject; each segmented kernel's time beside the same
     kernel unsegmented (through its wrapper, which builds the ids'
     tile table, and given the table as the autograd function launches
     it), its bound over the causal pairs and over the
     within-document pairs, SDPA with the block-diagonal causal mask and
     a varlen flash call (yardsticks the port never calls), and on other
     layouts beside the share of tiles listed, with a line fitted
     through them; the data path: a corpus written from PACK_SEED (line
     i holds L_i - 1 printable bytes, L_i the log-uniform document
     lengths over 64-4096 tokens) read by the port's LineIndexedFile and
     packed by its ShardedTextBatches (batch 1, seq 4096, pack=True)
     into rows whose segment ids must equal packed_segment_rows'; the
     same corpus packed by one coworker process through the native shm
     ring (ShmDataLoader) and DevicePrefetcher onto the card, its rows
     bit for bit the in-process packer's; Llama-3-8B x4 layers trained
     on the packer's rows, which reach the step through DevicePreloader
     (pinned arena, copy stream, prefetch 2), every batch on the card
     and the first and last bit for bit their host rows, with the
     segmented launches pinned, the executor's input wait and the
     preloader's queue depth, producer wait and H2D bytes a step
     printed, then profiled; one batch's gradients
     against the reference path with the segment bias, and the loss of
     each path against an exact attention's over 64 packed batches;
 14. GLM prefix-LM (``glm_10b`` widths: 64 heads of 64, MHA): B1-B3 in
     their prefix-LM mode against their plain versions at q, k, v
     [4, 64, 2048, 64] bf16 on the training batch's prompts, row by row
     and by the bias rule, with planted faults the row rule must reject
     (the prefix ignored, one key too wide, the prompt's tiles above the
     diagonal dropped) and truncation controls; edge prompts (127, 128,
     129, 1000, 0, 1, the whole row, half of it); prompts 0 and 1 bit
     for bit the causal kernels', the whole row the non-causal ones'; an
     f32 ragged case; the kernels' times unprefixed at this shape and in
     prefix-LM mode beside the bound over the visible pairs, SDPA with
     the boolean prefix mask and flex_attention with a prefix block mask
     (yardsticks the port never calls), each by both clocks, and B2 + B3
     against flex's and SDPA's whole backward; ``glm_10b`` x6 layers trained
     through ``accelerate`` on the example's instruction rows (4 x 2048
     tokens, Adam 2e-3) for 10 steps, every flash counter pinned (12 / 6
     / 6 prefix-LM launches a step), then profiled; one batch's
     gradients against the reference path with the prefix-LM bias, and
     the loss of each path against an exact attention's over 64 batches
     with the prefix ignored and one key too wide as controls.
  15. checkpoint and restore (``torch.distributed.checkpoint``) of the
     dense and the MoE cell (phases 5 and 8's models, full width, at 2
     and 1 layers: ``CKPT_LAYERS``) through ElasticTrainer and
     TrainExecutor with ``ckpt_dir`` in a temporary directory: the free
     disk, /dev/shm and host RAM first (a cell whose three host copies
     or two steps on disk do not fit runs 1 layer and says so), the host
     link's and the disk's rates; a
     HostSnapshot after step 3 and step 4 run twice from it, bit for bit;
     a forced async save at step 3 and steps 4-6 run on; a fresh trainer
     restoring in ``prepare`` from the /dev/shm staging mirror and, the
     mirror cleared, another from disk, each running steps 4-6 on the
     same batches (losses and every bit of the state equal); on the
     last, a NaN planted at step 5 under ``on_nonfinite="rollback"``:
     the executor restores step 3 onto the built trainer and finishes
     on the uninterrupted run's losses; the state bytes and the seconds
     of the snapshot, its restore, the save's stage and commit and each
     restore, beside the link's bound, on one line a cell.
 16. in-process recovery: (a) the expert-parallel cell (phase 12's) through
     ElasticTrainer on 4 ranks sharing the card: 2 steps, a snapshot
     laid out for the world of ranks 0 and 1 (into fresh host buffers,
     then into the same ones again), ``live_reshard`` onto it (ranks 2
     and 3 leave, the group re-formed in the processes), 2 steps at 2
     ranks with grad accumulation doubled; the survivors' expert leaves
     held against their slices of the pre-change leaves, and the live
     path against a cold trainer built for 2 ranks and restored from the
     same snapshot (losses and every state bit); every rank's launches
     pinned, no kernel module built or loaded again; the seconds of the
     snapshot, re-form, rebuild and restore, host bytes and peak memory;
     (b) the dense cell: ``prewarm(steps_per_call=4)`` and the ``retune``
     after it (a cache hit) beside a retune without one, two K = 4 calls
     through the executor's window and, from the same snapshot, 8 single
     steps, bit for bit; the step and the device's idle share at K = 1
     and K = 4 (readings).
 17. attribution on the dense cell (phase 5's) through TrainExecutor's
     window: the record counted on the meta device beside
     llama.flops_per_token x tokens, B1-B3's reported FLOPs equal to
     their Bound column's, a capture leaving every state bit and the
     rng stream as they were, the live MFU gauge within 1 % of
     derived_mfu over the CUDA events' time of the steps its samples
     time (a sample at step s is the device's step s + train_window:
     the host materializes s after its dispatch of s + window, which
     waits for room in the launch queue), each sample printed beside
     the events' step, the peak-memory and
     headroom gauges beside torch.cuda's, a profile through the
     package's trace parser, and the gauges' per-step cost (paired runs
     with attribution on and off). Phases 8 and 14 print their records
     too.
 18. FSDP: (a) Llama-3-8B at its published widths (2 layers, global
     batch 2 x 2048, AdamW, rule set "llama") on 2 ranks sharing the
     card over gloo, 2 steps at (data, fsdp) = (1, 2) and again at
     (2, 1) on the same batches: the losses within FSDP_LOSS_RTOL, each
     rank's parameter and moment bytes on the leaves the rules shard
     halved, the all-gather and reduce-scatter bytes equal to the
     formula (each sharded leaf's global bytes once a step each), B1-B3
     launches pinned, peak memory and the host step beside the
     exchanges' seconds; then one step at each mesh under the fp8 FSDP
     and gradient wires: the losses within FSDP_LOSS_RTOL, the trainer's
     effective precisions the ones asked for, the all-gather bytes at
     (1, 2) equal to the planner's formula (1 + 4/32 B a wired element,
     4 B every other gathered one), the residual nonzero and in the
     parameters' layout. Before the train runs, the ring leg (long
     context, ring attention over the seq axis): the ring body at seq =
     2 (Llama's attention at 4096 tokens a rank, causal and on phase
     13's packed layout; GLM's [4, 64, 1024, 64] a rank on phase 14's
     prompts and on prompts straddling and on the bound), forward and
     backward with host syncs forbidden, each rank's out, dq, dk, dv
     against the plain versions over the whole sequence by the row and
     bias rules, B1-B3's launches by mode pinned to the schedule, the
     shifts' bytes equal to the formula, and planted controls (a future
     shard attended, a past shard merged twice) the row rule rejects;
     and one step at (data, fsdp, seq) = (1, 1, 2) on the same batch,
     its loss within FSDP_LOSS_RTOL of the (2, 1) step's and its
     gradients within GRAD_GAP_LIMIT of them (phase 6's cross-check
     gap); (b) phase 12's run, which the
     example makes at (2, 2) on its 4 ranks, against the same
     configuration at (4, 1) through ElasticTrainer for 2 steps: losses
     within FSDP_MOE_RTOL, every rank's B1-B6 launches pinned, peak
     memory.

 19. serving, right after phase 5 on its trained weights (a HostSnapshot
     of the parameters promoted through ``ServeEngine.load_from_snapshot``,
     the trainer freed first): (a) ``prefill_sequence`` of one 4096-token
     prompt into a one-slot f32 pool 4096 deep, B1 launched once a layer
     and nothing else, the last hidden row ``apply_hidden``'s and the K/V
     rows ``_attention_block``'s ``return_kv`` bit for bit, the first
     token ``apply``'s argmax, the one-row head beside ``apply``'s; (b) 12
     requests (prompts log-uniform over 64-1536 tokens, 48 new each)
     through ServeExecutor (8 slots, f32 pool 2048 deep, page 16, chunk
     256, window 2), each request's decode logits within
     SERVE_LOGIT_LIMIT of one teacher-forced ``llama.apply`` and its
     tokens apply's argmax where the top-2 margin exceeds the limit, a
     decode mask ``t < pos`` and RoPE at ``pos + 1`` planted beyond it;
     (c) the prefix pool on (8 requests sharing a 512-token lead) token
     for token and page for page the pool off, and speculative decode (K
     = 4; n-gram, always right, always wrong, alternating and mixed
     drafts) token for token plain greedy on the f32 and the int8 pool;
     (d) the bf16 and int8 pools' logits against the f32 pool's on 4
     requests (int8 within 0.25); (e) decode, verify and prefill chunk
     with host syncs forbidden, every engine's program built once; the
     decode step's time at 8 active slots beside its bound from the bytes
     ``CostCounter`` counts on the meta device, a profile of 5 decode
     steps, the prefill chunk's and the verify step's times, TTFT, TPOT,
     tokens/s, the slot ledger's shares, pool bytes and peak memory.
     Then elastic serving on the same engine: (d) the 12 requests again
     under a stub master's plans (16 slots prewarmed after the first
     decode steps, chunk 128 while prompts are mid-prefill, chunk 300
     negative-acked, 8 slots once at most 8 are live): the acks, no
     build in a prewarmed retune, the pool's 1,073,741,824 B at 16 slots,
     every request through the same logit check, the tokens that differ
     from the unretuned run; (e) a live resize onto the same card after
     12 decode steps, every continuation token for token the resize-free
     run's, ``serve_resize_done`` with recompiled 0, the snapshot's
     bytes and its take and restore seconds; (f) ``planner.
     estimate_decode`` for the phase's geometry beside the measured step,
     and the host's ms a layer to queue one step beside the planner's.

The line before the last is a JSON object listing each kernel; the last
is {"ok": true, "device": {...}}. The whole script's time is printed
before them. ``--json PATH`` also writes every
number the run measured to PATH.

``--only-serving`` builds the kernels and runs phases 5 and 19 alone
(phase 19 on phase 5's trained weights, its elastic legs included); its
last line is {"ok": true, "only": "serving"}.

``--against DIR`` runs none of the phases above: it holds this tree's
flash and grouped kernels against the tree under DIR (``against``: SASS
of every kernel of the six sources but those named by ``--may-differ``,
the bf16 outputs of B1's, B2's and B3's segment-id entry points bit for
bit on phase 13's layouts and of their prefix-LM and unprefixed ones on
GLM's shape and ragged 64-wide-head layouts, their times in turns; B4's
four f32 forms, B5's two and B6 on phase 10's expert-parallel layout,
outputs and f64 errors side by side and times in turns, B5's outputs on
the skewed and ragged layouts too), for a change to a kernel
against its parent (``git archive`` into a git-ignored directory
such as ``_archive/``); with ``--variant`` DIR is a copy with a stage
compiled out, and outputs that differ are reported, not failed.
``--stress N`` adds N calls of both trees' B6 and B4-f32 on each of phase
10's layouts, each held bit for bit (a copy of B6 without a barrier, say,
and how often it goes wrong).
Needs one GPU; exits non-zero without one, or without the repository.
Phases 11 and 12 spawn their ranks (``trainer.run.run_local``) and stop
them before the script goes on.
"""

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.monotonic()
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
STEPS = 10
LAYERS = 4
SEQ = 4096
MOE_LAYERS = 2  # llama2_7b+moe8 at 2 layers: 1.84 B params, ~30 GB of state
MOE_EXPERTS, MOE_TOP_K, BLOCK_T = 8, 2, 128
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 on the CUDA cores (B4 f32, B6)
PEAK_TF32_FLOPS = 494.7e12  # H100 SXM dense TF32 tensor cores, data sheet
# expert parallel: 4 ranks sharing the one card over gloo, 1024 tokens
# each (the 4096 tokens per step of the one-card MoE cell), 2 experts each
# 4 steps (5 before the ring leg of phase 18 (a) needed the room): the
# last step profiled, steps 2-3 the steady ones
EP_RANKS, EP_TOKENS, EP_STEPS = 4, 1024, 4
EP_TIMEOUT = 600  # seconds a 4-rank phase may take
# packed documents: lengths log-uniform over [DOC_MIN, DOC_MAX] tokens
DOC_MIN, DOC_MAX, PACK_SEED = 64, 4096, 0
# the 64-wide head tile's own kernels (head dims up to 64, unsegmented)
B1_D64_DESIGN = ("on the 64-wide head tile a kernel of its own, "
                 "flash_fwd_d64_kernel: the 128-row blocks, tiles and 64-key "
                 "steps as the items of persistent blocks (one an SM), in "
                 "the same order, Q double-buffered so each item's first "
                 "tiles load under the last item's, each tile's next S "
                 "issued behind its first P.V, the masks a branch only "
                 "tiles crossing them take, a 4-stage ring")
B1_DESIGN = ("stage B: wgmma m64n128k16 for S and P.V with S, P and O in "
             "registers, two consumer warpgroups over 128 q rows, a "
             "producer warp keeping TMA loads of 128-key K/V tiles in a "
             "2-stage mbarrier ring, online softmax in 64-key steps; "
             + B1_D64_DESIGN)
B2_D64_DESIGN = ("on the 64-wide head tile a kernel of its own: 128 q rows a "
                 "step, wgmma m64n128k16 for S^T and dP^T, eight RS "
                 "m64n64k16 k16 steps each for dV and dK, the masks a "
                 "branch only steps crossing them take, a 4-stage ring")
B3_D64_DESIGN = ("on the 64-wide head tile a kernel of its own: the two "
                 "consumer warpgroups take turns (two named barriers) to "
                 "issue their products, each turn the last tile's dQ "
                 "product and this tile's S and dP, so one warpgroup's "
                 "exponentials run under the other's products; the masks a "
                 "branch only tiles crossing them take; a 4-stage ring")
B2_DESIGN = ("stage C: transposed scores, wgmma m64n64k16 for S^T = K Q^T "
             "and dP^T = V dO^T (dP^T issued before P^T's exponentials), "
             "RS m64n128k16 for dV += P^T dO and dK += dS^T Q with P^T and "
             "dS^T as register A fragments, dK and dV in registers, two "
             "consumer warpgroups over 128 keys, a producer warp keeping "
             "TMA loads of Q, dO, lse and delta in a 2-stage mbarrier "
             "ring, setmaxnreg 240/24; " + B2_D64_DESIGN)
B3_DESIGN = ("stage C: BK=128, wgmma m64n128k16 for S = Q K^T and dP = dO "
             "V^T (dP issued before P's exponentials), RS m64n128k16 for dQ "
             "+= dS K with dS as register A fragments and K read MN-major, "
             "dQ in registers, two consumer warpgroups over 128 q rows, a "
             "producer warp keeping TMA loads of 128-key K/V tiles in a "
             "2-stage mbarrier ring, setmaxnreg 240/24; " + B3_D64_DESIGN)
B4_DESIGN = ("wgmma SS m64n256k16 from TMA-loaded 128-byte-swizzled shared "
             "memory (x K-major; w[e] MN-major for y, K-major for dx, read "
             "in place), 128x256x64 tiles, a producer warp keeping a "
             "4-stage mbarrier ring, two consumer warpgroups of 64 rows, "
             "setmaxnreg 240/24, a persistent grid (one block an SM) in "
             "groups of 8 row tiles, each warp's output staged through two "
             "swizzled 2 KB boxes and written by TMA stores")
F32_DESIGN = ("f32 on the CUDA cores (3xTF32 wgmma reads biased: "
              "chip_stages.py tf32): a persistent grid, a producer warp "
              "keeping TMA loads of 128 x 32 A and B tiles in a 4-stage "
              "mbarrier ring, 256 consumer threads each an 8 x 8 block of a "
              "128 x 128 tile from 16-byte shared reads, four k at a time, "
              "the parent's fmaf chain in k order (its outputs bit for bit), "
              "row tiles at or past live_rows written as zeros with no load, "
              "live tiles first")
B5_DESIGN = ("B4's persistent wgmma loop with x^T and dy both MN-major, "
             "128 (D) x 256 (F) tiles expert by expert, each reducing its "
             "expert's rows found by binary search (no atomics), the f32 "
             "tile written by TMA stores from shared memory while the "
             "producer loads the next tile's stages")
B5_F32_DESIGN = ("f32 (the expert-parallel rank's dw): B4's f32 FFMA loop "
                 "with x^T and dy both MN-major (four TMA boxes of 32 rows "
                 "x 32 columns each a stage), each 128 (D) x 128 (F) tile "
                 "of each expert one owner reducing over the expert's rows "
                 "up to live_rows (the rows past it, sentinel tiles, not "
                 "read; a tail inside a stage from global memory), the "
                 "parent's fmaf chain in row order (its outputs bit for "
                 "bit), the experts with the longest range first, tiles "
                 "across the wider of D and F, stores straight from the "
                 "registers")
SEG_DESIGN = {  # the segment-id instantiations of B1-B3
    name: (f"{base}'s kernel; before the role split one warp lists in "
           "shared memory the block's tiles whose [min, max] ids (a per-64 "
           "table built on the device once a layer's forward and shared by "
           "B1-B3) meet its own, and producer and consumers walk only that "
           "list, a warpgroup skipping a listed tile its own 64 ids cannot "
           "meet; one producer warp stages the segment ids of the block and "
           "of each ring stage in shared memory with 'these 64 are one "
           "value' flags (one more mbarrier a stage); from them a consumer "
           "warpgroup masks a listed tile not at all by segment, whole "
           "(-inf scores or exponent offsets), or, where ids change inside "
           "it, by a warp-uniform pass apart from the unsegmented mask")
    for name, base in (("flash_fwd_seg", "B1"), ("flash_bwd_dkv_seg", "B2"),
                       ("flash_bwd_dq_seg", "B3"))
}


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_samples(fn, iters=10, warmup=2, spin=False):
    """Milliseconds of each of ``iters`` calls of ``fn``, each between two
    CUDA events and queued behind the call before it, so that a sample is
    the device's time and not the host's launch gap. With ``spin`` the
    device first spins (``torch.cuda._sleep``) while the host queues
    every call, so that a call the host takes longer to launch than the
    device to run reads its kernels' time alone."""
    import torch

    for _ in range(warmup):
        fn()
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


SPIN_CYCLES = 50_000_000  # ~25 ms of the device's clock: the host queues


def host_ms(fn, iters=10, warmup=2):
    """Median host milliseconds ``fn`` takes to return, each call made
    from an empty queue (the device synchronized first): the time to
    queue its work, where ``fn`` waits for nothing on the device."""
    import torch

    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(samples)


def time_ms(fn, iters=10, warmup=2):
    """Median of ``time_samples``."""
    return statistics.median(time_samples(fn, iters, warmup))


def device_ms(fn, iters=10, warmup=2):
    """Median of ``time_samples`` with the device spinning first: the
    ``device_ms`` beside each kernel's and library call's ``ms``."""
    return statistics.median(time_samples(fn, iters, warmup, spin=True))


def attention_inputs(b, h, hkv, s, d, dtype, seed, sk=None):
    """q, k, v, dO; k and v have ``sk`` rows (default ``s``)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sk = s if sk is None else sk

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    return rnd(b, h, s, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d), \
        rnd(b, h, s, d)


def check_kernels(fa, b, h, hkv, s, d, dtype, causal, seed, tol, sk=None,
                  seg=None, label="", pfx=None):
    """Run each kernel and its plain version on the same inputs; return
    ({kernel: max abs error}, the inputs and the plain results). ``seg``:
    (seg_q, seg_k) int32 on the card, the segment-id mode (its kernels
    named ``<kernel>_seg``); ``pfx``: prefix_len [b] int32 on the card,
    the prefix-LM mode (``<kernel>_pfx``). A bf16 output is held row by row
    (``flash_check.rows_close``: each row's error within 1% of its norm,
    plus 0.1% of the tensor's RMS row norm) and by its bias
    (``flash_check.bias_close``: the signed error projected on the plain
    output within ``BIAS_LIMIT``); an f32 output (every output of an f32
    case, and lse) to ``tol`` absolute."""
    import torch

    from dlrover_tpu_torch.ops import flash_check

    q, k, v, do = attention_inputs(b, h, hkv, s, d, dtype, seed, sk)
    scale = 1.0 / math.sqrt(d)
    ids = {} if seg is None else {"seg_q": seg[0], "seg_k": seg[1]}
    if pfx is not None:
        ids = {"prefix_len": pfx}
    out_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale, **ids)
    out, lse = fa.flash_fwd(q, k, v, causal, scale, **ids)
    delta = (do.float() * out_ref.float()).sum(-1).contiguous()
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta,
                                            causal, scale, **ids)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal, scale,
                              **ids)
    dq_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal,
                                   scale, **ids)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal, scale, **ids)
    torch.cuda.synchronize()
    errs = {}
    label = (f"{dtype} B={b} H={h}/{hkv} S={s}"
             + (f"/{sk}" if sk is not None else "")
             + f" D={d} causal={causal}" + (f" {label}" if label else ""))
    suffix = "_seg" if seg is not None else "_pfx" if pfx is not None else ""
    for kernel, name, got, ref in (
        ("flash_fwd", "out", out, out_ref),
        ("flash_fwd", "lse", lse, lse_ref),
        ("flash_bwd_dkv", "dk", dk, dk_ref),
        ("flash_bwd_dkv", "dv", dv, dv_ref),
        ("flash_bwd_dq", "dq", dq, dq_ref),
    ):
        if got.dtype == torch.bfloat16:
            e = flash_check.row_errors(got, ref)
            bias = flash_check.bias(got, ref)
            err = e["max_abs_err"]
            ok = (flash_check.rows_close(got, ref)
                  and flash_check.bias_close(got, ref))
            detail = (f"worst row {e['worst_row']:.3f} of its limit, "
                      f"norm ratio {e['norm_ratio']:.3e}, bias {bias:+.3e} "
                      f"(limit {flash_check.BIAS_LIMIT:.0e})")
        else:
            err = (got.float() - ref.float()).abs().max().item()
            ok = math.isfinite(err) and err <= tol
            detail = f"limit {tol:.0e}"
        log(f"  {label} {name}: max_abs_err={err:.3e} ({detail}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{kernel}{suffix} disagrees with its plain version on "
                 f"{name} ({label})")
        errs[kernel + suffix] = max(errs.get(kernel + suffix, 0.0), err)
    right = {"out": out_ref, "dk": dk_ref, "dv": dv_ref, "dq": dq_ref}
    return errs, (q, k, v, do, lse_ref, delta, scale), right


def check_planted_faults(inputs, right):
    """The rule that passed the kernels must reject what a kernel with
    a planted fault would return (``flash_check.planted_faults``), on
    the same inputs. Also says whether the looser rule it replaced (max
    error within 2e-2 of the largest value) would have caught each. The
    bias rule must reject the truncation controls
    (``flash_check.bias_controls``); says whether the row rule would."""
    from dlrover_tpu_torch.ops import flash_check

    results = []
    for name, fault, got in flash_check.planted_faults(*inputs):
        ref = right[name]
        e = flash_check.row_errors(got, ref)
        loose = e["max_abs_err"] <= 2e-2 * ref.float().abs().max().item()
        caught = not flash_check.rows_close(got, ref)
        log(f"  planted fault, {name}: {fault}: worst row "
            f"{e['worst_row']:.1f} of its limit, max_abs_err "
            f"{e['max_abs_err']:.3e} -> "
            f"{'rejected' if caught else 'PASSED'} (max-abs rule: "
            f"{'passes it' if loose else 'rejects it'})")
        if not caught:
            fail(f"the kernel check lets a planted fault pass: {fault}")
        results.append({"output": name, "fault": fault, **e,
                        "max_abs_rule_passes": loose})
        del got
    q, k, v, do, lse, delta, scale = inputs
    return results + check_bias_controls(
        flash_check.bias_controls(q, k, v, do, lse, delta, True, scale),
        right)


def check_bias_controls(controls, right):
    """The bias rule must reject each truncation control (output name,
    fault, faulty output) against the right output of that name; says
    whether the row rule would."""
    from dlrover_tpu_torch.ops import flash_check

    results = []
    for name, fault, got in controls:
        ref = right[name]
        bias = flash_check.bias(got, ref)
        caught = not flash_check.bias_close(got, ref)
        rows_pass = flash_check.rows_close(got, ref)
        log(f"  bias control, {name}: {fault}: bias {bias:+.3e} (limit "
            f"{flash_check.BIAS_LIMIT:.0e}) -> "
            f"{'rejected' if caught else 'PASSED'} (row rule: "
            f"{'passes it' if rows_pass else 'rejects it'})")
        if not caught:
            fail(f"the bias rule lets a control pass: {fault}")
        results.append({"output": name, "fault": fault, "bias": bias,
                        "row_rule_passes": rows_pass})
        del got
    return results


def kernel_times(fa, b, h, hkv, s, d):
    """Per kernel, on causal bf16 inputs of this shape: its time (median
    of 10 samples, and the samples), its plain version's, the library's
    and the least time the card could take."""
    import torch
    import torch.nn.functional as F

    q, k, v, do = attention_inputs(b, h, hkv, s, d, torch.bfloat16, 7)
    scale = 1.0 / math.sqrt(d)
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    pairs = s * (s + 1) // 2  # visible (q, k) pairs per head, causal
    io = 2  # bytes per bf16 element
    qb, kb = b * h * s * d * io, b * hkv * s * d * io
    rows = b * h * s * 4  # one f32 per row (lse, delta)
    work = {  # (flops, bytes: inputs read once, outputs written once)
        "flash_fwd": (4 * b * h * d * pairs, qb + 2 * kb + qb + rows),
        "flash_bwd_dkv": (8 * b * h * d * pairs,
                          2 * qb + 2 * kb + 2 * rows + 2 * kb),
        "flash_bwd_dq": (6 * b * h * d * pairs,
                         2 * qb + 2 * kb + 2 * rows + qb),
    }
    calls = {
        "flash_fwd": lambda f: f(q, k, v, True, scale),
        "flash_bwd_dkv": lambda f: f(q, k, v, do, lse, delta, True, scale),
        "flash_bwd_dq": lambda f: f(q, k, v, do, lse, delta, True, scale),
    }
    # the library yardstick: SDPA forward, and its backward (which
    # computes dq, dk and dv together: the work of B2 and B3)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                             enable_gqa=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True))
    lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                       enable_gqa=True), (ql, kl, vl), do))
    lib_dev = {"flash_fwd": device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))}
    lib_dev["flash_bwd_dkv"] = lib_dev["flash_bwd_dq"] = device_ms(
        lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                    retain_graph=True))
    del lib_out
    results = {}
    for name, (flops, nbytes) in work.items():
        samples = time_samples(lambda: calls[name](fa.WRAPPERS[name]))
        kernel_ms = statistics.median(samples)
        dev_ms = device_ms(lambda: calls[name](fa.WRAPPERS[name]))
        plain_ms = time_ms(lambda: calls[name](fa.PLAIN[name]), iters=5,
                           warmup=1)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        results[name] = {
            "ms": kernel_ms, "samples_ms": samples, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd,
            "device_ms": dev_ms, "library_device_ms": lib_dev[name],
            "gflop": flops / 1e9,
            "tflops_achieved": flops / kernel_ms / 1e9,
        }
        r = results[name]
        r["bound_share"] = r["bound_ms"] / kernel_ms
        r["library_ratio"] = kernel_ms / r["library_ms"]
        log(f"  {name}: {kernel_ms:.3f} ms (samples {min(samples):.3f}-"
            f"{max(samples):.3f}, {r['tflops_achieved']:.1f} TFLOP/s; "
            f"device alone {dev_ms:.3f} ms, SDPA's {lib_dev[name]:.3f}), "
            f"plain {plain_ms:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}, {flops / 1e9:.1f} GFLOP): "
            f"{r['bound_share']:.3f} of the bound, {r['library_ratio']:.2f}x "
            f"SDPA's {'forward' if name == 'flash_fwd' else 'backward'} "
            f"({r['library_ms']:.3f} ms)")
    log(f"  sdpa yardstick: fwd {lib_fwd:.3f} ms, bwd {lib_bwd:.3f} ms, "
        f"fwd+bwd {lib_fwd_bwd:.3f} ms")
    return results, {"sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
                     "sdpa_fwd_bwd_ms": lib_fwd_bwd}


def grouped_inputs(moe, t, d, f, e, seed, bias=None, dtype=None):
    """Grouped-matmul operands as the MoE path makes them: ``t`` tokens
    routed top-2 over ``e`` experts by a random router (``bias`` added to
    the logits skews the routing), sorted by expert into tile-padded
    rows. Returns (x [rows, d], w [e, d, f], dy [rows, f], the layout)."""
    import torch

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    xt = rnd(t, d)
    logits = (xt @ rnd(d, e, scale=d ** -0.5)).float()
    if bias is not None:
        logits = logits + torch.tensor(bias, device="cuda")
    rounds, _, _ = moe._routing(logits, t, MOE_TOP_K, None, 0.0)
    lay = moe.grouped_layout(rounds, t, e, BLOCK_T)
    x = torch.cat([xt, xt.new_zeros((1, d))])[lay.row_token]
    return x, rnd(e, d, f, scale=d ** -0.5), rnd(lay.rows, f), lay


def group_sizes(lay, t, e):
    """(tiles, real rows) per expert of a layout."""
    import torch

    te = lay.tile_expert.long()
    real = (lay.row_token < t).view(-1, BLOCK_T).sum(dim=1)
    tiles = torch.zeros(e, dtype=torch.long, device=te.device)
    rows = torch.zeros_like(tiles)
    tiles.index_add_(0, te, torch.ones_like(te))
    rows.index_add_(0, te, real)
    return tiles.tolist(), rows.tolist()


def check_grouped(gm, x, w, dy, lay, label, f32_tol=1e-4):
    """Each grouped kernel (B4 for y and dx, B5 for dw) against its plain
    version on the same inputs; returns ({kernel: max abs error}, the
    plain results). bf16 inputs: every output, B5's f32 one too, by the
    row rule (``flash_check.rows_close``) and by its bias
    (``flash_check.bias_close``); f32 inputs: within ``f32_tol`` absolute
    plus ``f32_tol`` relative, element by element."""
    import torch

    from dlrover_tpu_torch.ops import flash_check

    te, e = lay.tile_expert, w.shape[0]
    right = {"y": gm.grouped_matmul_fwd_plain(x, w, te, BLOCK_T),
             "dx": gm.grouped_matmul_fwd_plain(dy, w, te, BLOCK_T, True),
             "dw": gm.grouped_matmul_dw_plain(x, dy, te, e, BLOCK_T)}
    got = {"y": gm.grouped_matmul_fwd(x, w, te, BLOCK_T),
           "dx": gm.grouped_matmul_fwd(dy, w, te, BLOCK_T,
                                       transpose_w=True),
           "dw": gm.grouped_matmul_dw(x, dy, te, e, BLOCK_T)}
    torch.cuda.synchronize()
    errs = {}
    for name, kernel in (("y", "grouped_matmul_fwd"),
                         ("dx", "grouped_matmul_fwd"),
                         ("dw", "grouped_matmul_dw")):
        g, r = got[name], right[name]
        if x.dtype == torch.bfloat16:
            es = flash_check.row_errors(g, r)
            err = es["max_abs_err"]
            ok = flash_check.rows_close(g, r) and flash_check.bias_close(g, r)
            detail = (f"worst row {es['worst_row']:.3f} of its limit, "
                      f"norm ratio {es['norm_ratio']:.3e}, bias "
                      f"{flash_check.bias(g, r):+.3e} (limit "
                      f"{flash_check.BIAS_LIMIT:.0e})")
        else:
            err = (g - r).abs().max().item()
            ok = bool(torch.allclose(g, r, atol=f32_tol, rtol=f32_tol))
            detail = f"limit {f32_tol:.0e} abs + rel"
        log(f"  {label} {name} {tuple(g.shape)}: max_abs_err={err:.3e} "
            f"({detail}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{kernel} disagrees with its plain version on {name} "
                 f"({label})")
        errs[kernel] = max(errs.get(kernel, 0.0), err)
    return errs, right


def check_grouped_faults(x, w, dy, lay, right):
    """The row rule that passed B4 and B5 must reject what they would
    return with a fault at an expert boundary, and the bias rule the
    truncation controls (``grouped_check``); says whether the row rule
    would reject the controls."""
    from dlrover_tpu_torch.ops import flash_check, grouped_check

    results = []
    for name, fault, got in grouped_check.planted_faults(
            x, w, dy, lay.tile_expert, BLOCK_T):
        e = flash_check.row_errors(got, right[name])
        caught = not flash_check.rows_close(got, right[name])
        log(f"  planted fault, {name}: {fault}: worst row "
            f"{e['worst_row']:.1f} of its limit -> "
            f"{'rejected' if caught else 'PASSED'}")
        if not caught:
            fail(f"the grouped kernel check lets a planted fault pass: "
                 f"{fault}")
        results.append({"output": name, "fault": fault, **e})
        del got
    return results + check_bias_controls(
        grouped_check.truncation_controls(x, w, dy, lay.tile_expert,
                                          BLOCK_T), right)


def check_no_host_sync(moe, d, f, e):
    """One MoE FFN at full width (grouped dispatch, top-2, 4096 tokens),
    forward and backward, under ``torch.cuda.set_sync_debug_mode("error")``:
    any operation that waits for the device raises."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)

    def leaf(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * shape[-2] ** -0.5).to(torch.bfloat16).requires_grad_()

    params = {"router": {"kernel": leaf(d, e)},
              "experts": {"up": {"kernel": leaf(e, d, f)},
                          "down": {"kernel": leaf(e, f, d)}}}
    x = leaf(1, SEQ, d)
    cfg = moe.MoEConfig(num_experts=e, top_k=MOE_TOP_K, dispatch="grouped")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux, _ = moe.moe_ffn(params, x, cfg, activation=F.silu)
        (out.float().square().mean() + aux).backward()
    except RuntimeError as exc:
        fail(f"the grouped MoE path waits for the device: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  one MoE layer (grouped, 4096 tokens) forward and backward with "
        "host syncs forbidden: none")


def grouped_times(gm, x, w, dy, lay):
    """B4 (y, dx) and B5 at one of the main path's shapes (the up
    projection: x [rows, D], w [E, D, F], dy [rows, F]; the down
    projection: the same call with h [rows, F], w [E, F, D] and dy
    [rows, D]): kernel, plain and library times beside the least time
    the card could take. The library yardstick is torch._grouped_mm over
    the groups' row offsets, where this torch has it; the port never
    calls it."""
    import torch

    from dlrover_tpu_torch.ops import flash_check

    rows, d = x.shape
    e, _, f = w.shape
    te = lay.tile_expert
    flops = 2 * rows * d * f
    io, te_bytes = 2, te.numel() * 4
    work = {  # (kernel, flops, bytes: inputs read once, outputs written once)
        "y": ("grouped_matmul_fwd", flops,
              (x.numel() + w.numel() + rows * f) * io + te_bytes),
        "dx": ("grouped_matmul_fwd", flops,
               (dy.numel() + w.numel() + rows * d) * io + te_bytes),
        "dw": ("grouped_matmul_dw", flops,
               (x.numel() + dy.numel()) * io + te_bytes + e * d * f * 4),
    }
    calls = {
        "y": lambda fn: fn(x, w, te, BLOCK_T),
        "dx": lambda fn: fn(dy, w, te, BLOCK_T, transpose_w=True),
        "dw": lambda fn: fn(x, dy, te, e, BLOCK_T),
    }
    plain = {"y": gm.grouped_matmul_fwd_plain,
             "dx": gm.grouped_matmul_fwd_plain,
             "dw": gm.grouped_matmul_dw_plain}
    offs = (torch.searchsorted(te, torch.arange(e, dtype=te.dtype,
                                                device=te.device),
                               right=True) * BLOCK_T).int()
    library = {  # candidate calls, the first that runs and agrees wins
        "y": [("w", lambda: torch._grouped_mm(x, w, offs=offs))],
        "dx": [("w^T view", lambda: torch._grouped_mm(
                    dy, w.transpose(1, 2), offs=offs))],
        # B5's own output is f32; a bf16 one is the fallback
        "dw": [("x^T view, f32 out", lambda: torch._grouped_mm(
                    x.t(), dy, offs=offs, out_dtype=torch.float32)),
               ("x^T view, bf16 out", lambda: torch._grouped_mm(
                   x.t(), dy, offs=offs))],
    }
    ends = [0] + offs.tolist()

    def loop(name):  # the per-expert loop of products, for information
        for i in range(e):
            a, b = ends[i], ends[i + 1]
            if name == "y":
                x[a:b] @ w[i]
            elif name == "dx":
                dy[a:b] @ w[i].t()
            else:
                x[a:b].t() @ dy[a:b]

    results = {}
    for name, (kernel, fl, nbytes) in work.items():
        kernel_ms = time_ms(lambda: calls[name](gm.WRAPPERS[kernel]))
        dev_ms = device_ms(lambda: calls[name](gm.WRAPPERS[kernel]))
        plain_ms = time_ms(lambda: calls[name](plain[name]), iters=5,
                           warmup=1)
        ref = calls[name](plain[name])
        lib_ms, lib_dev, lib_call = None, None, "no single call"
        if hasattr(torch, "_grouped_mm"):
            for label, fn in library[name]:
                try:
                    out = fn()
                    torch.cuda.synchronize()
                except (RuntimeError, TypeError) as exc:
                    log(f"  torch._grouped_mm ({label}) for {name}: "
                        f"{str(exc).splitlines()[0][:160]}")
                    continue
                if not flash_check.rows_close(out, ref):
                    log(f"  torch._grouped_mm ({label}) for {name} "
                        f"disagrees: {flash_check.row_errors(out, ref)}")
                    continue
                lib_ms, lib_call = time_ms(fn), f"torch._grouped_mm ({label})"
                lib_dev = device_ms(fn)
                break
        loop_ms = None if lib_ms is not None else time_ms(lambda: loop(name))
        del ref
        t_ops = fl / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        results[name] = {
            "kernel": kernel, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "library_call": lib_call,
            "device_ms": dev_ms, "library_device_ms": lib_dev,
            "loop_ms": loop_ms, "gflop": fl / 1e9, "bytes": nbytes,
            "tflops_achieved": fl / kernel_ms / 1e9,
        }
        r = results[name]
        log(f"  {name} ({kernel}): {kernel_ms:.3f} ms "
            f"({r['tflops_achieved']:.1f} TFLOP/s; device alone "
            f"{dev_ms:.3f} ms), plain {plain_ms:.3f} ms, library {lib_call}"
            + (f" {lib_ms:.3f} ms (device alone {lib_dev:.3f})"
               if lib_ms is not None else
               f" (per-expert matmul loop {loop_ms:.3f} ms)")
            + f", bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
            f"{fl / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB)")
    return results


def step_record():
    """A TrainHook: a CUDA event before each step's dispatch and one at
    the end (an event fires when the device has finished every step
    before it, so two events bound one step on the device's clock however
    far the dispatch window lets the host run ahead); each step's
    metrics as the window hands them over, and the live MFU gauge as the
    executor set it for that step."""
    import torch

    from dlrover_tpu_torch.telemetry import names as tm
    from dlrover_tpu_torch.telemetry.metrics import process_registry
    from dlrover_tpu_torch.trainer.executor import TrainHook

    class Record(TrainHook):
        def __init__(self):
            self.events, self.metrics, self.mfu = [], {}, {}
            # host clock at each step's dispatch and materialization
            self.dispatched, self.materialized = {}, {}

        def _mark(self):
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()

        def before_step(self, step):
            self.dispatched[step] = time.perf_counter()
            self._mark()

        def after_step(self, step, metrics):
            self.materialized[step] = time.perf_counter()
            self.metrics[step] = metrics
            gauge = process_registry().get(tm.ATTR_MFU)
            if gauge is not None:
                self.mfu[step] = gauge.value

        def end(self, executor):
            self._mark()

    return Record()


def gauge_mfu(record, first, last):
    """The live MFU gauge over steps ``first``..``last`` as one figure:
    the harmonic mean of its samples, which is ``derived_mfu`` over their
    mean step time (None without samples)."""
    samples = [record.mfu[s] for s in range(first, last + 1)
               if record.mfu.get(s, 0.0) > 0]
    return len(samples) / sum(1 / m for m in samples) if samples else None


def attribution_report(result, batch, label, formula_flops, card, k=1):
    """The attribution record of a built step (``telemetry.attribution``,
    counted on the meta device) beside the formula's FLOPs, with each
    hand-written kernel's calls, FLOPs and bytes a call."""
    from dlrover_tpu_torch.telemetry import attribution

    t0 = time.monotonic()
    count = attribution.count_step(result, k, batch)
    count_s = time.monotonic() - t0
    record = attribution.capture_attribution(result, k, batch, emit=False)
    flops = record.flops_per_step
    log(f"  attribution ({label}): {flops:.6e} FLOPs a step counted on the "
        f"meta device (aten matmuls {count.matmul_flops / k:.6e}), the "
        f"formula's {formula_flops:.6e} (counted / formula "
        f"{flops / formula_flops:.4f}); {record.bytes_accessed_per_step:.6e} "
        f"bytes a step (intensity {record.arithmetic_intensity:.1f}); peak "
        f"memory {record.peak_hbm_bytes / 2**30:.2f} GiB; exchanges "
        f"{record.collective_bytes}; capture {record.capture_seconds:.3f} s "
        f"(a count alone {count_s:.3f} s); {card}")
    for name, v in sorted(count.kernels.items()):
        log(f"    {name}: {v['calls'] / k:g} calls a step, "
            f"{v['flops'] / v['calls'] / 1e9:.1f} GFLOP and "
            f"{v['bytes'] / v['calls'] / 1e9:.4f} GB a call")
    return {"record": record.to_dict(), "formula_flops": formula_flops,
            "matmul_flops": count.matmul_flops / k,
            "kernels": count.kernels, "count_s": count_s}


def main_trainer(llama, config, rule_set, example_batch, loss_fn=None,
                 **kwargs):
    """The main path's ElasticTrainer on the card: ``config``'s init and
    loss (or ``loss_fn``), the example's AdamW, one device; ``kwargs``
    go to the trainer (``ckpt_dir``)."""
    from dlrover_tpu_torch.examples.train_llama import adamw
    from dlrover_tpu_torch.parallel.mesh import single_device_plan
    from dlrover_tpu_torch.parallel.strategy import Strategy
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

    return ElasticTrainer(
        llama.make_init_fn(config), loss_fn or llama.make_loss_fn(config),
        adamw(), example_batch,
        strategy=Strategy(mesh=single_device_plan(), rule_set=rule_set),
        device="cuda", **kwargs)


def train_main_path(llama, config, label, rule_set, kernels, expected,
                    card, active_fpt=None, batches=None, feed=None,
                    keep_params=False):
    """Drive TrainExecutor + ElasticTrainer on ``config`` for STEPS
    steps. ``kernels``: the wrapper modules whose launch counters the
    run resets just before and reads just after; their counts must equal
    ``expected``. ``active_fpt``: the FLOPs per token the tokens really
    cost, where the reference's formula counts more (MoE). ``batches``:
    a callable returning an iterator of host batches (the example's
    synthetic token stream by default). ``feed``: trainer -> the
    executor's ``train_iter_fn`` (``batches`` itself by default).
    ``keep_params``: the summary's "params_snapshot" holds a
    ``HostSnapshot`` of the trained parameters (``params_snapshot``), and
    the trainer is freed as always."""
    import torch

    from dlrover_tpu_torch.common.config import get_context
    from dlrover_tpu_torch.examples.train_llama import synthetic_batches
    from dlrover_tpu_torch.telemetry import names as tm
    from dlrover_tpu_torch.telemetry.metrics import process_registry
    from dlrover_tpu_torch.trainer.conf import build_configuration
    from dlrover_tpu_torch.trainer.executor import TrainExecutor

    if not config.use_flash:
        fail("the main path must run with use_flash=True")

    record = step_record()
    if batches is None:
        batches = synthetic_batches(config.vocab_size, 1, SEQ)
    trainer = main_trainer(llama, config, rule_set, next(batches()))
    window = get_context().train_window  # the default, as users run it
    executor = TrainExecutor(
        trainer, train_iter_fn=feed(trainer) if feed else batches,
        hooks=[record],
        conf=build_configuration({"train_steps": STEPS,
                                  "log_every_steps": 1}),
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for module in kernels:
        module.reset_launch_counts()
    out = executor.train_and_evaluate()
    torch.cuda.synchronize()
    counts = {}
    for module in kernels:
        counts.update(module.launch_counts())
    peak = torch.cuda.max_memory_allocated()
    input_wait_s = executor.input_wait_seconds
    wait_gauge = process_registry().get(tm.INPUT_WAIT_FRAC)
    if out["step"] != STEPS or sorted(record.metrics) != list(
            range(1, STEPS + 1)):
        fail(f"trained {out['step']} steps, expected {STEPS}")
    tokens = SEQ  # batch 1
    fpt = llama.flops_per_token(config)
    step_ms = [a.elapsed_time(b) for a, b in zip(record.events,
                                                 record.events[1:])]
    losses = [record.metrics[s]["loss"] for s in range(1, STEPS + 1)]
    for step, ms in enumerate(step_ms, start=1):
        metrics = record.metrics[step]
        loss = metrics["loss"]
        load = metrics.get("moe_expert_load")
        log(f"  step {step}: loss={loss:.4f} grad_norm="
            f"{metrics['grad_norm']:.4f} {ms:.1f} ms "
            f"{tokens / ms * 1e3:.0f} tokens/s MFU "
            f"{fpt * tokens / (ms / 1e3) / PEAK_BF16_FLOPS:.3f}"
            + (f" expert load {[round(v, 4) for v in load]}"
               if load is not None else ""))
        if not (math.isfinite(loss) and metrics["finite"]):
            fail(f"non-finite loss at step {step}")
    first = losses[0]
    if abs(first - math.log(config.vocab_size)) > 3.0:
        fail(f"first loss {first:.3f} is far from ln(vocab) "
             f"{math.log(config.vocab_size):.3f} for a random init")
    # steps 2..N-1: the first pays for first-call set-up, and the last
    # event waits for the host's drain of the window
    steady = record.events[1].elapsed_time(record.events[-2]) / (STEPS - 2)
    mfu = fpt * tokens / (steady / 1e3) / PEAK_BF16_FLOPS
    active_mfu = (active_fpt * tokens / (steady / 1e3) / PEAK_BF16_FLOPS
                  if active_fpt else None)
    log(f"  launches {counts} (expected {expected}); train_window "
        f"{window}; steady step "
        f"{steady:.1f} ms, {tokens / steady * 1e3:.0f} tokens/s, MFU "
        f"{mfu:.4f} (flops/token {fpt:.4e})"
        + (f", MFU by the active parameters {active_mfu:.4f} (flops/token "
           f"{active_fpt:.4e})" if active_fpt else "")
        + f"; peak memory {peak / 2**30:.2f} GiB; {card}")
    if counts != expected:
        fail(f"kernel launches {counts} on the main path, expected "
             f"{expected}")
    attr = attribution_report(trainer.accelerated, next(batches()), label,
                              fpt * tokens, card)
    # the last `window` steps are materialized in the final drain
    attr["gauge_mfu"] = gauge_mfu(record, 2, STEPS - window)
    log(f"  live MFU gauge (dlrover_attribution_mfu: counted FLOPs over the "
        f"executor's step time) over steps 2..{STEPS - window}: "
        f"{attr['gauge_mfu'] or 0.0:.4f}; by llama.flops_per_token over the "
        f"device's steady step {mfu:.4f}; {card}")
    profile = profile_steps(trainer, executor.state, next(batches()))
    summary = {
        "attribution": attr,
        "profile": profile, "config": label,
        "params": llama.param_count(config), "batch": 1, "seq": SEQ,
        "steps": STEPS, "train_window": window,
        "losses": losses,
        "step_ms": step_ms, "steady_step_ms": steady,
        "tokens_per_s": tokens / steady * 1e3,
        "mfu": mfu, "flops_per_token": fpt,
        "mfu_active": active_mfu, "active_flops_per_token": active_fpt,
        "peak_memory_bytes": peak,
        "launches": counts, "expected_launches": expected,
        "expert_load": [record.metrics[s].get("moe_expert_load")
                        for s in range(1, STEPS + 1)],
        "input_wait_ms_per_step": input_wait_s * 1e3 / STEPS,
        "input_wait_frac": wait_gauge.value if wait_gauge else None,
    }
    if keep_params:
        summary["params_snapshot"] = params_snapshot(executor.state)
    del executor, trainer
    return summary


def params_snapshot(state):
    """A ``HostSnapshot`` of a TrainState's parameters alone (an optimizer
    that keeps no moments stands in for its AdamW, so the host copy is a
    third of the state's): what a serving worker beside the trainer
    promotes."""
    import torch

    from dlrover_tpu_torch.checkpoint import HostSnapshot
    from dlrover_tpu_torch.models.common import tree_leaves
    from dlrover_tpu_torch.parallel.accelerate import TrainState

    return HostSnapshot.take(TrainState(
        step=state.step, params=state.params,
        opt_state=torch.optim.SGD(tree_leaves(state.params), lr=0.0)))


FLASH_KERNELS = {"flash_fwd": "B1", "flash_bwd_dkv": "B2",
                 "flash_bwd_dq": "B3"}  # a substring of each kernel's name
# the segment-id kernels, which no unpacked path launches, and the
# prefix-LM kernels, which only phase 14 launches
NO_SEG = {f"{name}_seg": 0 for name in FLASH_KERNELS}
NO_PFX = {f"{name}_pfx": 0 for name in FLASH_KERNELS}
TRACE_AGREEMENT = 0.01  # the trace's busy time against key_averages'


def profile_steps(trainer, state, batch, n=3):
    """``n`` more training steps dispatched back to back (as the
    dispatch window lets them run), once under torch.profiler and once
    without. The trace is exported (``export_chrome_trace``) and read by
    the package (``telemetry.attribution``): device-time buckets, time
    by kernel group and by kernel, the device's gaps; its busy time is
    held within TRACE_AGREEMENT of the device sum ``key_averages``
    reads. The idle share is of the profiled steps' own span (CUDA
    events around all ``n``)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.telemetry import attribution

    def run():
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            trainer.step(state, batch)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    plain_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        span_ms = run()
    host, summed_us = [], 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            host.append((evt.self_cpu_time_total / 1e3 / n, evt.count / n,
                         evt.key))
            continue
        # kernels only: a user annotation (e.g. the optimizer's
        # record_function range) spans kernels already counted. Kernel
        # names may hold '#' ("{lambda()#3}"): the annotation flag, not
        # the name, tells them apart
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        summed_us += getattr(evt, "device_time_total", 0) or 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "steps.pt.trace.json")
        prof.export_chrome_trace(path)
        buckets = attribution.parse_trace_path(path)
        records = attribution.load_trace(path)
    view = attribution.kernel_breakdown(records, n, top=12)
    step_ms, plain_step_ms = span_ms / n, plain_ms / n
    summed = summed_us / 1e3 / n
    busy = buckets["busy_s"] * 1e3 / n  # the busiest lane, per step
    if busy == 0.0:
        log("  profile: the profiler recorded no device time "
            "(not measured)")
        return {"device_ms": None, "step_ms": step_ms,
                "unprofiled_step_ms": plain_step_ms}
    idle = 1 - busy / step_ms
    agreement = busy / summed - 1 if summed else float("inf")
    log(f"  profile of {n} more steps: device busy {busy:.1f} ms per step "
        f"of {step_ms:.1f} ms under the profiler (idle share {idle:.4f}); "
        f"the same {n} steps without it: {plain_step_ms:.1f} ms per step "
        f"(idle share against it {1 - busy / plain_step_ms:.4f})")
    log(f"    the trace by telemetry.attribution.parse_trace_path: "
        f"{buckets['events']} device events, busy {buckets['busy_s']:.6f} s "
        f"(all lanes {view['busy_ms'] * n / 1e3:.6f}), idle "
        f"{buckets['idle_s']:.6f} s of a {buckets['wall_s']:.6f} s device "
        f"span; compute {buckets['compute_s']:.6f}, collective "
        f"{buckets['collective_s']:.6f}, infeed {buckets['infeed_s']:.6f}, "
        f"other {buckets['other_s']:.6f} s; against key_averages' device "
        f"sum {summed:.3f} ms per step: {agreement:+.5f}")
    if abs(agreement) > TRACE_AGREEMENT:
        fail(f"the parsed trace's busy time {busy:.3f} ms per step is not "
             f"within {TRACE_AGREEMENT} of key_averages' {summed:.3f}")
    for group, ms in sorted(view["groups_ms"].items(), key=lambda kv: -kv[1]):
        log(f"    {group}: {ms:.1f} ms ({ms / busy:.3f})")
    flash = {name: [0.0, 0.0] for name in FLASH_KERNELS}  # ms, launches
    for name, (ms, launches) in view["by_name"].items():
        for kernel in FLASH_KERNELS:
            if kernel in name:
                flash[kernel][0] += ms
                flash[kernel][1] += launches
    for kernel, (ms, launches) in flash.items():
        log(f"    {FLASH_KERNELS[kernel]} ({kernel}): {ms:.2f} ms per step "
            f"over {launches:g} launches ({ms / busy:.3f} of the busy time)")
    for ms, count, name in view["top"]:
        log(f"    top kernel {ms:.2f} ms x{count:g}: {name[:90]}")
    gaps = attribution.device_gaps(records, n)
    log(f"    device span of the profiled steps: "
        f"{gaps['span_ms_per_step']:.1f} ms per step; gaps per step:")
    for label, entry in gaps["per_step"].items():
        log(f"      {label}: {entry['count']:g} gaps, {entry['ms']:.2f} ms")
    for gap, before, after in gaps["largest"][:6]:
        log(f"      gap {gap:.2f} ms after {before[:50]} before {after[:50]}")
    # the host's side: self time per step of each op and runtime call
    # (under the profiler, which adds its own cost to each)
    host.sort(reverse=True)
    log(f"    host self time per step, all ops: "
        f"{sum(ms for ms, _, _ in host):.1f} ms")
    for ms, count, name in host[:12]:
        log(f"    top host op {ms:.2f} ms x{count:g}: {name[:90]}")
    return {"device_ms": busy, "step_ms": step_ms,
            "unprofiled_step_ms": plain_step_ms, "idle_share": idle,
            "key_averages_device_ms": summed, "trace_agreement": agreement,
            "buckets": buckets, "groups_ms": view["groups_ms"],
            "flash_ms": {k: ms for k, (ms, _) in flash.items()},
            "flash_launches": {k: c for k, (_, c) in flash.items()},
            "top": [(ms, count, name[:200])
                    for ms, count, name in view["top"]],
            "host_top": [(ms, count, name[:200])
                         for ms, count, name in host[:15]],
            "gaps": gaps}


# Phase 6 holds the gradients of the flash path against the reference's
# on one batch. Its loss is held by loss_check: one batch's flash and
# reference losses differ by more bf16 noise than the 1e-4 this check
# once allowed (PERF.md, section 6)
GRAD_GAP_LIMIT = 5e-2  # ||g_flash - g_ref|| / ||g_ref|| over every leaf
# grouped vs gather dispatch at a capacity nothing overflows. Observed
# gap: exactly 0, with B4's WMMA loop and again with its wgmma loop (both
# sum K in cuBLAS's k16 order on the tensor cores). The limits allow
# another summation order (a bf16 rounding here and there) but not a
# wrong tile or route, which moves gradients by about 1e-1
MOE_LOSS_GAP_LIMIT = 1e-4
MOE_GRAD_GAP_LIMIT = 1e-3


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _named_leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def token_batch(config, seed):
    """One batch of ``SEQ`` tokens from ``RandomState(seed)``."""
    import numpy as np
    import torch

    ids = np.random.RandomState(seed).randint(0, config.vocab_size,
                                              size=(1, SEQ + 1))
    return {"input_ids": torch.as_tensor(ids[:, :-1], device="cuda"),
            "labels": torch.as_tensor(ids[:, 1:], device="cuda")}


def cross_check(llama, config, variants, kernels, loss_limit, grad_limit,
                batch=None):
    """One forward+backward at full width of ``config`` changed as each
    of ``variants`` says ((name, overrides) for the path under test,
    then for its reference), same weights and ``batch`` (default
    ``token_batch(config, 1)``): the loss and every gradient. The path
    under test must launch ``kernels`` (wrapper modules), and the
    reference none of them. ``loss_limit`` None: the loss is logged and
    held elsewhere."""
    import dataclasses

    import torch

    (test, test_kw), (ref, ref_kw) = variants
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = llama.init(gen, config)
    named = list(_named_leaves(params))
    for _, t in named:
        t.requires_grad_()
    batch = token_batch(config, 1) if batch is None else batch
    losses, grads, launched = {}, {}, {}
    for is_test, overrides in ((True, test_kw), (False, ref_kw)):
        cfg = dataclasses.replace(config, **overrides)
        for module in kernels:
            module.reset_launch_counts()
        loss, _ = llama.make_loss_fn(cfg)(params, batch, None)
        grads[is_test] = torch.autograd.grad(loss, [t for _, t in named])
        losses[is_test] = loss.item()
        launched[is_test] = sum(sum(m.launch_counts().values())
                                for m in kernels)
        del loss
        torch.cuda.empty_cache()
    log(f"  kernel launches: {test} {launched[True]}, {ref} "
        f"{launched[False]}")
    if not launched[True] or launched[False]:
        fail(f"the cross-check does not compare the kernels' path with "
             f"one without them: {launched}")

    def sq(t):
        return torch.linalg.vector_norm(t.float()).item() ** 2

    leaf_gap = {}
    diff2 = ref2 = flash2 = 0.0
    for (name, _), gf, gr in zip(named, grads[True], grads[False]):
        d2, r2 = sq(gf - gr), sq(gr)
        diff2, ref2, flash2 = diff2 + d2, ref2 + r2, flash2 + sq(gf)
        leaf_gap[name] = math.sqrt(d2 / r2) if r2 else math.sqrt(d2)
    del grads
    lf, lr = losses[True], losses[False]
    nf, nr = math.sqrt(flash2), math.sqrt(ref2)
    gap = math.sqrt(diff2 / ref2)
    worst = max(leaf_gap, key=leaf_gap.get)
    log(f"  {test} loss {lf:.6f} grad_norm {nf:.6f}; {ref} loss "
        f"{lr:.6f} grad_norm {nr:.6f}; loss gap {abs(lf - lr):.3e} "
        + (f"(limit {loss_limit:.0e})" if loss_limit is not None
           else "(held by the loss check below)")
        + f"; gradient gap ||g_{test} - g_{ref}|| "
        f"/ ||g_{ref}|| {gap:.3e} (limit {grad_limit:.0e}), worst leaf "
        f"{worst} {leaf_gap[worst]:.3e}")
    for name in sorted(leaf_gap):
        log(f"    gradient gap {name}: {leaf_gap[name]:.3e}")
    loss_ok = loss_limit is None or abs(lf - lr) <= loss_limit
    if not (loss_ok and gap <= grad_limit):
        fail(f"{test} and {ref} disagree at full width")
    return {"test": test, "ref": ref, "launches": launched, "test_loss": lf,
            "test_grad_norm": nf, "ref_loss": lr, "ref_grad_norm": nr,
            "loss_gap": abs(lf - lr), "grad_gap": gap, "leaf_gap": leaf_gap}


# Phase 6's FSDP wire variants (ROADMAP A14): the reference's bound on
# the fp8 wire's loss against bf16's (tests/test_fsdp_wire.py)
WIRE_DRIFT = 5e-3
WIRE_PRECISIONS = ("fp8", "fp8_qdq", "bf16")


def wire_variants(llama, config, fa, remat, card):
    """One forward and backward of ``config`` (phase 5's model, same
    weights and batch) under each FSDP wire precision: the fp8 probe
    must pass on the card and each run's effective precision be the one
    asked for (a degraded wire never passes for an fp8 run); fp8 and
    fp8_qdq bit for bit, loss and every gradient; bf16 against fp8 within
    WIRE_DRIFT, every gradient finite; B1-B3 launches pinned in each.
    Then the wires' own device time: the layer stack's quantize, the
    decode of every layer's slice, the gradient wire's error-feedback
    step over the gradient tree, and the bytes they move."""
    import torch

    from dlrover_tpu_torch.ops.quantize import (
        dequantize_block_scaled,
        error_feedback_qdq,
    )
    from dlrover_tpu_torch.ops.shard_compat import fp8_wire_supported

    cuda = torch.device("cuda")
    probe = fp8_wire_supported(cuda)
    log(f"  the fp8 probe on {torch.cuda.get_device_name(0)}: {probe}")
    if not probe:
        fail("the fp8 wire probe fails on the card: an fp8 run would run "
             "the bf16 wire")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = llama.init(gen, config)
    named = list(_named_leaves(params))
    for _, t in named:
        t.requires_grad_()
    batch = token_batch(config, 1)
    recompute = 1 if remat.remat_enabled(config.remat_policy) else 0
    expected = {"flash_fwd": LAYERS * (1 + recompute),
                "flash_bwd_dkv": LAYERS, "flash_bwd_dq": LAYERS,
                **NO_SEG, **NO_PFX}
    runs, kept = {}, {}
    for precision in WIRE_PRECISIONS:
        cfg = dataclasses.replace(config, fsdp_precision=precision)
        effective = llama.resolve_fsdp_precision(cfg, cuda)
        fa.reset_launch_counts()
        loss, _ = llama.make_loss_fn(cfg)(params, batch, None)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        torch.cuda.synchronize()
        counts = fa.launch_counts()
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        runs[precision] = {"loss": loss.item(), "effective": effective,
                           "launches": counts, "finite": finite}
        log(f"  fsdp_precision={precision}: effective {effective}, loss "
            f"{loss.item():.6f}, gradients finite {finite}, launches "
            f"{counts}")
        if effective != precision:
            fail(f"fsdp_precision {precision} runs as {effective}")
        if counts != expected:
            fail(f"launches {counts} under fsdp_precision={precision}, "
                 f"expected {expected}")
        if not finite:
            fail(f"a non-finite gradient under fsdp_precision={precision}")
        if precision == "fp8":
            kept = {"loss": loss.detach().clone(), "grads": grads}
        elif precision == "fp8_qdq":
            same = (torch.equal(loss, kept["loss"]) and all(
                torch.equal(a, b) for a, b in zip(grads, kept["grads"])))
            runs["fp8_equals_fp8_qdq"] = same
            log(f"  fp8 against fp8_qdq: loss and all {len(grads)} "
                f"gradients bit for bit: {same}")
            if not same:
                fail("the fp8 wire differs from its fp8_qdq reference")
            kept = {"loss": kept["loss"], "grads": grads}
        del loss, grads
        torch.cuda.empty_cache()
    drift = abs(runs["bf16"]["loss"] - runs["fp8"]["loss"]) / abs(
        runs["bf16"]["loss"])
    runs["drift"] = drift
    log(f"  bf16 against fp8: loss {runs['bf16']['loss']:.6f} vs "
        f"{runs['fp8']['loss']:.6f}, relative {drift:.3e} (limit "
        f"{WIRE_DRIFT:.0e})")
    if drift >= WIRE_DRIFT:
        fail(f"the fp8 wire's loss is {drift:.3e} from bf16's")

    # the wires' own cost at this width (device time, CUDA events)
    grads = kept["grads"]
    del kept
    layers = params["layers"]
    wired = {p: t for p, t in llama._flatten_layers(layers)
             if llama._wire_leaf(t)}
    elems = sum(t.numel() for t in wired.values())
    with torch.no_grad():
        stack = llama._quantize_layer_stack(layers, "fp8")
        quant_ms = device_ms(
            lambda: llama._quantize_layer_stack(layers, "fp8"), 5, 1)
        dequant_ms = device_ms(lambda: [
            dequantize_block_scaled(f["v"][i], f["s"][i], torch.float32)
            for f in stack.values() for i in range(config.num_layers)], 5, 1)
        residual = [torch.zeros_like(g) for g in grads]
        ef_ms = device_ms(lambda: [error_feedback_qdq(g, r)
                                   for g, r in zip(grads, residual)], 5, 1)
    param_bytes = sum(t.numel() * t.element_size() for _, t in named)
    wire = {"wired_elements": elems,
            "fp8_wire_bytes": elems * (1 + 4 / 32),
            "full_wire_bytes": elems * 4,
            "quantize_ms": quant_ms, "dequantize_ms": dequant_ms,
            "error_feedback_ms": ef_ms, "residual_bytes": param_bytes}
    runs["wire"] = wire
    log(f"  the wires' device time a step at this width ({elems} wired "
        f"elements in {len(wired)} layer stacks): quantize the stack "
        f"{quant_ms:.3f} ms, decode every layer's slice {dequant_ms:.3f} "
        f"ms, the gradient wire's error feedback over all "
        f"{len(grads)} gradients {ef_ms:.3f} ms; a gather of the wired "
        f"stacks moves {wire['fp8_wire_bytes'] / 1e9:.4f} GB under fp8 "
        f"against {wire['full_wire_bytes'] / 1e9:.4f} GB at f32; the "
        f"residual holds {param_bytes / 1e9:.4f} GB; {card}")
    del params, named, grads, residual, stack
    torch.cuda.empty_cache()
    return runs


# The dense loss check. Each path's loss is held, batch by batch, against
# the loss of an exact attention (the reference's, with P and P.V in f32
# and the output rounded to bf16 once) over LOSS_BATCHES token batches of
# the same weights: the mean of a path's gaps measures a bias, their root
# mean square the noise it adds. bf16 rounding in the rest of the model
# sets a floor of ~2e-4 under the rms of every path. The sound paths (the
# flash kernels, the reference, the plain forward) must keep both within
# the limits; the controls must exceed one. Each limit lies between the
# sound paths' largest reading and a control's (PERF.md, section 6)
LOSS_BATCHES = 64
LOSS_BIAS_LIMIT = 1e-4  # |mean(L_path - L_exact)|
LOSS_RMS_LIMIT = 2.8e-4  # sqrt(mean((L_path - L_exact)^2))


def exact_attention(q, k, v, causal=True, scale=None, bias=None):
    """The reference attention with P and P.V in f32, its output rounded
    to the inputs' dtype once, at the end."""
    from dlrover_tpu_torch.ops.attention_ref import mha_reference

    return mha_reference(q.float(), k.float(), v.float(), causal, scale,
                         bias).to(q.dtype)


def round_bits(bits):
    """f32 p >= 0 -> p rounded to nearest at ``bits`` significant bits
    (bf16 keeps 8)."""
    import torch

    drop = 24 - bits

    def rnd(p):
        x = p.view(torch.int32)
        return ((x + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)
    return rnd


def faulty_fwd(fa, round_p=None, extra_keys=0, ignore_ids=False,
               ignore_prefix=False, prefix_extra=0):
    """``flash_fwd_plain`` with P rounded by ``round_p`` (f32 -> f32; bf16
    when None) before P.V, the causal mask ``extra_keys`` keys too wide,
    (``ignore_ids``) segment ids ignored, and in prefix-LM mode the
    prefix ignored (``ignore_prefix``) or ``prefix_extra`` keys too wide:
    what a forward kernel with those faults returns."""
    import torch

    def fwd(q, k, v, causal, scale, seg_q=None, seg_k=None,
            prefix_len=None):
        ids = (None, None) if ignore_ids else (seg_q, seg_k)
        s = fa._scores(q, k, False, scale, *ids)
        if causal:
            rows = torch.arange(s.shape[-2], device=q.device)[:, None]
            cols = torch.arange(s.shape[-1], device=q.device)[None, :]
            hidden = cols > rows + extra_keys
            if prefix_len is not None and not ignore_prefix:
                p = prefix_len[:, None, None, None] + prefix_extra
                hidden = hidden & (cols >= p)
            s = s.masked_fill(hidden, fa.NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        p = p.to(v.dtype).float() if round_p is None else round_p(p)
        v_rep = v.repeat_interleave(fa._group_size(q, k), dim=1).float()
        out = torch.matmul(p, v_rep) / l
        return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)
    return fwd


def loss_controls(fa):
    """(name, forward, verdict) put in the kernel's place: the forwards
    the loss check must reject, and faults it is known not to see,
    reported beside them."""
    from dlrover_tpu_torch.ops.flash_check import truncate_bf16

    return [("P rounded to 5 significant bits",
             faulty_fwd(fa, round_p=round_bits(5)), "control"),
            ("causal mask one key too wide",
             faulty_fwd(fa, extra_keys=1), "control"),
            ("P truncated to bf16", faulty_fwd(fa, round_p=truncate_bf16),
             "reading"),
            ("P rounded to 6 significant bits",
             faulty_fwd(fa, round_p=round_bits(6)), "reading")]


@contextlib.contextmanager
def swapped(module, name, value):
    """``module.name`` is ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def loss_check(llama, config, fa, controls, batches=LOSS_BATCHES,
               bias_limit=LOSS_BIAS_LIMIT, rms_limit=LOSS_RMS_LIMIT,
               batch_fn=token_batch, b1="flash_fwd"):
    """The losses of the flash, reference and plain-forward paths and of
    ``controls`` (``loss_controls``) against the exact attention's, over
    ``batches`` batches (``batch_fn(config, seed)``) at full width of
    ``config``; see LOSS_BATCHES. Fails unless every sound path passes,
    every control fails and the flash path launched B1 (counted as
    ``b1``) in every layer of every batch."""
    import dataclasses

    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    params = llama.init(gen, config)
    flash_cfg = dataclasses.replace(config, use_flash=True)
    ref_cfg = dataclasses.replace(config, use_flash=False)
    paths = [("flash", flash_cfg, None, "sound"),
             ("reference", ref_cfg, None, "sound"),
             ("plain forward", flash_cfg, fa.flash_fwd_plain, "sound")]
    paths += [(name, flash_cfg, fwd, verdict)
              for name, fwd, verdict in controls]
    gaps = {name: [] for name, *_ in paths}
    fa.reset_launch_counts()
    with torch.no_grad():
        for seed in range(1, batches + 1):
            batch = batch_fn(config, seed)
            # the packed reference path reaches mha_reference through
            # ops.flash_attention.segmented_attention
            with swapped(llama, "mha_reference", exact_attention), \
                    swapped(fa, "mha_reference", exact_attention):
                exact = llama.make_loss_fn(ref_cfg)(params, batch,
                                                    None)[0].item()
            for name, cfg, fwd, _ in paths:
                # in the place of the autograd forward's launch of B1,
                # whose last argument is the ids' tile table
                with (swapped(fa, "_launch_fwd", lambda *a: fwd(*a[:-1]))
                      if fwd is not None else contextlib.nullcontext()):
                    loss = llama.make_loss_fn(cfg)(params, batch,
                                                   None)[0].item()
                gaps[name].append(loss - exact)
    launches = fa.launch_counts()[b1]
    expected = batches * config.num_layers
    log(f"  B1 launches {launches} (expected {expected}: the flash path's "
        f"layers over {batches} batches)")
    if launches != expected:
        fail(f"the loss check's flash path launched B1 {launches} times, "
             f"not {expected}")
    fr = [a - b for a, b in zip(gaps["flash"], gaps["reference"])]
    log(f"  flash - reference per batch: first {fr[0]:+.3e}, min "
        f"{min(fr):+.3e}, max {max(fr):+.3e}")
    log(f"  L_path - L_exact over {batches} batches (limits: |mean| "
        f"{bias_limit:.1e}, rms {rms_limit:.1e}):")
    report, wrong = {}, []
    for name, _, _, verdict in paths:
        g = gaps[name]
        mean = statistics.mean(g)
        stderr = statistics.stdev(g) / math.sqrt(len(g))
        rms = math.sqrt(statistics.mean(x * x for x in g))
        passes = abs(mean) <= bias_limit and rms <= rms_limit
        log(f"    {verdict} {name}: mean {mean:+.3e} (standard error "
            f"{stderr:.2e}), rms {rms:.3e}, max |gap| "
            f"{max(abs(x) for x in g):.3e}: "
            f"{'passes' if passes else 'fails'}")
        if verdict != "reading" and passes != (verdict == "sound"):
            wrong.append(name)
        report[name] = {"verdict": verdict, "mean": mean, "stderr": stderr,
                        "rms": rms, "gaps": g, "passes": passes}
    if wrong:
        fail(f"the loss check misjudges {wrong}")
    return report


def ep_received_rows(moe, quantize, d, f, seed, bias=None, tokens=EP_TOKENS,
                     experts=MOE_EXPERTS, ranks=EP_RANKS):
    """What rank 0 of a grouped_ep job hands B6: each of ``ranks``
    sources routes its ``tokens`` tokens top-2 over ``experts`` experts
    (a random router; ``bias`` added to the logits skews it) and sends
    rank 0 the rows of its local experts, quantized; rank 0 sorts them
    by local expert (``moe.regroup_layout``). Returns (values, scales,
    w [el, d, f] f32 from bf16, the layout, real rows per local
    expert)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    el, n = experts // ranks, tokens * MOE_TOP_K

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    router = rnd(d, experts, scale=d ** -0.5)
    rows, counts = [], []
    for _ in range(ranks):
        xt = rnd(tokens, d)
        logits = xt @ router
        if bias is not None:
            logits = logits + torch.tensor(bias, device="cuda")
        rounds, _, _ = moe._routing(logits, tokens, MOE_TOP_K, None, 0.0)
        lay = moe.send_layout(rounds, tokens, ranks, el)
        x_send = torch.cat([xt, xt.new_zeros((1, d))])[lay.send_token]
        rows.append(x_send.view(ranks, n, d)[0])
        counts.append(lay.counts[0])
    recv = torch.stack(counts)  # [sources, el]
    v, s = quantize.quantize_block_scaled(torch.stack(rows))
    rl = moe.regroup_layout(recv, 0, n, ranks, el, BLOCK_T)
    v = torch.cat([v.view(-1, d), v.new_zeros((1, d))])[rl.row_src]
    s = torch.cat([s.view(-1, s.shape[-1]),
                   s.new_zeros((1, s.shape[-1]))])[rl.row_src]
    w = rnd(el, d, f, scale=d ** -0.5).to(torch.bfloat16).float()
    return v, s, w, rl, recv.sum(dim=0).tolist()


def check_quant(gm, quantize, v, s, w, rl, label, f32_tol=1e-4):
    """B6 against its plain version by the row rule (and within
    ``f32_tol`` absolute plus relative, element by element), and bit for
    bit against dequantize followed by B4's f32 path: without
    ``live_rows`` and with the layout's (rows past it exactly zero, the
    rows before bit for bit the run without it). Returns (max abs error
    with ``live_rows``, the plain result with it)."""
    import torch

    from dlrover_tpu_torch.ops import flash_check

    te, live = rl.tile_expert, rl.live_rows
    n = live.item()
    runs = {}
    for tag, lr in (("all rows", None), (f"live_rows {n}", live)):
        right = gm.grouped_matmul_fwd_quant_plain(v, s, w, te, BLOCK_T,
                                                  live_rows=lr)
        got = gm.grouped_matmul_fwd_quant(v, s, w, te, BLOCK_T,
                                          live_rows=lr)
        b4 = gm.grouped_matmul_fwd(quantize.dequantize_block_scaled(v, s), w,
                                   te, BLOCK_T, live_rows=lr)
        torch.cuda.synchronize()
        es = flash_check.row_errors(got, right)
        ok = flash_check.rows_close(got, right) and bool(
            torch.allclose(got, right, atol=f32_tol, rtol=f32_tol))
        bitwise = torch.equal(got, b4)
        log(f"  {label}, {tag}: y {tuple(got.shape)}: max_abs_err="
            f"{es['max_abs_err']:.3e} (worst row {es['worst_row']:.3f} of "
            f"its limit, norm ratio {es['norm_ratio']:.3e}; limit "
            f"{f32_tol:.0e} abs + rel) {'ok' if ok else 'MISMATCH'}; "
            f"dequantize + B4 f32: "
            f"{'bitwise equal' if bitwise else 'DIFFERENT'}")
        if not ok:
            fail(f"grouped_matmul_fwd_quant disagrees with its plain version "
                 f"({label}, {tag})")
        if not bitwise:
            fail(f"grouped_matmul_fwd_quant is not bitwise dequantize + B4 "
                 f"f32 ({label}, {tag}): max diff "
                 f"{(got - b4).abs().max().item():.3e}")
        runs[tag] = (got, right, es["max_abs_err"])
        del b4
    (full, _, _), (got, right, err) = runs.values()
    dead = torch.count_nonzero(got[n:]).item()
    same = torch.equal(got[:n], full[:n])
    log(f"  {label}: rows past live_rows ({rl.rows - n} of {rl.rows}) "
        f"{'all zero' if dead == 0 else f'{dead} NONZERO'}; the rows "
        f"before {'bit for bit' if same else 'DIFFER from'} the run "
        f"without it")
    if dead or not same:
        fail(f"grouped_matmul_fwd_quant's live_rows ({label})")
    return err, right


def check_quant_faults(v, s, w, rl, right):
    """The rule that passed B6 must reject a neighbour block's scale,
    ignored scales and a tile read with the neighbour expert's weights
    (``grouped_check.planted_quant_faults``)."""
    from dlrover_tpu_torch.ops import flash_check, grouped_check

    results = []
    for name, fault, got in grouped_check.planted_quant_faults(
            v, s, w, rl.tile_expert, BLOCK_T):
        e = flash_check.row_errors(got, right)
        caught = not flash_check.rows_close(got, right)
        log(f"  planted fault, {name}: {fault}: worst row "
            f"{e['worst_row']:.1f} of its limit -> "
            f"{'rejected' if caught else 'PASSED'}")
        if not caught:
            fail(f"the B6 check lets a planted fault pass: {fault}")
        results.append({"output": name, "fault": fault, **e})
        del got
    return results


STRESS_CALLS = 100  # phase 10's calls of B6 and of B4-f32 on each layout


def wrong_cells(got, want):
    """Where ``got`` differs from ``want`` (2-D): the entries, the
    128 x 128 output tiles (row tile, column tile) that hold them, and
    their rows and columns."""
    bad = (got != want).nonzero()[:100_000].tolist()
    rows = sorted({r for r, _ in bad})
    cols = sorted({c for _, c in bad})
    tiles = sorted({(r // 128, c // 128) for r, c in bad})
    return (f"{len(bad)} entries in output tiles {tiles[:8]}; rows "
            f"{rows[:32]} ({len(rows)}); columns {cols[0]}-{cols[-1]} "
            f"({len(cols)})")


def stress_layout(runs, label, v, s, w, rl, calls, report_only=False):
    """The f32 loop's stress check: ``calls`` calls of each kernel of
    ``runs`` ({name: fn(v, s, xd, w, tile_expert, live_rows) -> y}) on
    one expert-parallel layout with its ``live_rows``, each held bit for
    bit against one call of this tree's B4-f32 on the dequantized rows
    (which B6 must equal) and within 1e-4 of B6's plain version. A wrong
    output is logged with its tiles, rows and columns, and fails the run
    unless ``report_only``. Returns {name: wrong calls}."""
    import torch

    from dlrover_tpu_torch.ops import grouped_matmul as gm
    from dlrover_tpu_torch.ops import quantize

    te, live = rl.tile_expert, rl.live_rows
    xd = quantize.dequantize_block_scaled(v, s)
    ref = gm.grouped_matmul_fwd(xd, w, te, BLOCK_T, live_rows=live)
    plain = gm.grouped_matmul_fwd_quant_plain(v, s, w, te, BLOCK_T,
                                              live_rows=live)
    if not torch.allclose(ref, plain, atol=1e-4, rtol=1e-4):
        fail(f"stress, {label}: B4-f32 disagrees with B6's plain version")
    counts = {}
    for name, fn in runs.items():
        t0, bad = time.monotonic(), 0
        for i in range(calls):
            y = fn(v, s, xd, w, te, live)
            if torch.equal(y, ref) and torch.allclose(y, plain, atol=1e-4,
                                                      rtol=1e-4):
                continue
            bad += 1
            log(f"  stress, {name} on {label}: call {i} WRONG: "
                f"{wrong_cells(y, ref)}")
            if not report_only:
                fail(f"{name} gave a wrong output on {label} (call {i})")
        counts[name] = bad
        log(f"  stress, {name} on {label}: {calls} calls, {bad} wrong "
            f"({time.monotonic() - t0:.1f} s)")
    del xd, ref, plain
    return counts


def clocks_under(fn, seconds=2.0):
    """The SM clock and power draw (``nvidia-smi``, every 50 ms; medians
    of the samples taken while the calls ran) while ``fn`` runs back to
    back for about ``seconds`` on the device: what a share of a bound
    taken at 1980 MHz is measured against."""
    import datetime

    import torch

    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    calls = max(1, int(seconds / max(time.monotonic() - t0, 1e-4)))
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(1.0)  # nvidia-smi starts
        begin = datetime.datetime.now()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        stop = datetime.datetime.now()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = []
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        try:
            at = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
            if begin <= at <= stop:
                rows.append((float(parts[1]), float(parts[2])))
        except (ValueError, IndexError):
            continue
    if not rows:
        return {"sm_mhz": None, "power_w": None, "samples": 0}
    return {"sm_mhz": statistics.median(r[0] for r in rows),
            "power_w": statistics.median(r[1] for r in rows),
            "samples": len(rows)}


def f64_errors(got, ref64):
    """``got`` against an f64 product of the same inputs: the norm
    ratio, ``flash_check.bias`` and the largest error."""
    from dlrover_tpu_torch.ops import flash_check

    err = got.double() - ref64
    return {"norm_ratio": (err.norm() / ref64.norm()).item(),
            "bias": flash_check.bias(got, ref64),
            "max_abs_err": err.abs().max().item()}


def expert_ends(te):
    """Row offsets [0, end of expert 0, ...] from tile_expert (host)."""
    import torch

    el = int(te.max().item()) + 1
    return [0] + [int(x) for x in (torch.searchsorted(
        te, torch.arange(el, dtype=te.dtype, device=te.device),
        right=True) * BLOCK_T).tolist()]


def grouped_f32_bounds(rows, k, n, el, live, a_row_bytes=None, dw=False):
    """The least times of an f32 grouped product of ``rows`` x ``k`` by
    ``el`` weights [k, n] with rows at or past ``live`` written as zeros,
    over the rows given and over the live rows: FFMA (2 rows k n at 67
    TFLOP/s, the design kept) and 3xTF32 tensor cores (3 x 2 rows k n at
    494.7 TFLOP/s), each or the bytes (the rows read, ``a_row_bytes`` a
    row, 4 k for f32; every weight read; every output row written) at
    3.35 TB/s if larger. ``dw``: B5's dw [el, k, n] summed over the rows
    of x [rows, k] and dy [rows, n] (the same operations; the rows of
    both read, dw written)."""
    a_row_bytes = 4.0 * k if a_row_bytes is None else a_row_bytes
    out = {}
    for tag, used in (("given", rows), ("live", live)):
        ops = 2.0 * used * k * n
        moved = (used * 4.0 * (k + n) + 4.0 * el * k * n if dw else
                 used * a_row_bytes + 4.0 * (el * k * n + rows * n))
        t_bytes = moved / PEAK_BYTES * 1e3
        out[tag] = {"gflop": ops / 1e9,
                    "ffma_ms": max(ops / PEAK_F32_FLOPS * 1e3, t_bytes),
                    "tf32x3_ms": max(3 * ops / PEAK_TF32_FLOPS * 1e3,
                                     t_bytes),
                    "bytes_ms": t_bytes}
    return out


def f32_form_times(gm, label, a, w, rl, transpose_w):
    """One f32 form of B4 at the expert-parallel rank's layout: checked
    against its plain version with and without ``live_rows`` (row rule
    and 1e-4 absolute plus relative; rows past it zero, the rows before
    bit for bit the run without it), its f64 errors and its plain
    version's, then timed (both clocks) with and without ``live_rows``
    beside the plain version, a per-expert cuBLAS loop (TF32 off) over
    the rows given and over the live rows, and both bounds."""
    import torch

    from dlrover_tpu_torch.ops import flash_check

    te, live = rl.tile_expert, rl.live_rows
    rows, k = a.shape
    el = w.shape[0]
    n = w.shape[1] if transpose_w else w.shape[2]
    n_live = live.item()

    def run(lr):
        return gm.grouped_matmul_fwd(a, w, te, BLOCK_T, transpose_w, lr)

    ends = expert_ends(te)
    ref64 = torch.zeros((rows, n), dtype=torch.float64, device=a.device)
    for i in range(el):
        we = w[i].double()
        ref64[ends[i]:ends[i + 1]] = a[ends[i]:ends[i + 1]].double() @ (
            we.t() if transpose_w else we)
    errs = {}
    full = run(None)
    for tag, lr in (("all rows", None), ("live_rows", live)):
        got = run(lr)
        right = gm.grouped_matmul_fwd_plain(a, w, te, BLOCK_T, transpose_w,
                                            lr)
        torch.cuda.synchronize()
        ok = flash_check.rows_close(got, right) and bool(
            torch.allclose(got, right, atol=1e-4, rtol=1e-4))
        if not ok:
            fail(f"B4 f32 {label} disagrees with its plain version ({tag}): "
                 f"{flash_check.row_errors(got, right)}")
        errs[tag] = {"kernel": f64_errors(got, ref64),
                     "plain": f64_errors(right, ref64)}
    dead = torch.count_nonzero(got[n_live:]).item()
    if dead or not torch.equal(got[:n_live], full[:n_live]):
        fail(f"B4 f32 {label}: live_rows wrong ({dead} nonzero dead "
             f"entries, or the live rows differ from the run without it)")
    del full, got, right, ref64

    def loop(end):
        cut = [min(x, end) for x in ends]
        for i in range(el):
            we = w[i]
            a[cut[i]:cut[i + 1]] @ (we.t() if transpose_w else we)

    r = f32_times(run, lambda: gm.grouped_matmul_fwd_plain(
        a, w, te, BLOCK_T, transpose_w, live), loop, rl, rows,
                  grouped_f32_bounds(rows, k, n, el, n_live), errs)
    log_f32_times(f"B4 f32 {label}", r)
    return r


def dw_f32_form_times(gm, label, x, dy, rl):
    """One f32 form of B5 at the expert-parallel rank's layout (x and dy
    zero past ``live_rows``, as the layout leaves them): checked against
    its plain version with and without ``live_rows`` (row rule and 1e-4
    absolute plus relative; bit for bit the same either way), its f64
    errors and its plain version's, then timed (both clocks) with and
    without ``live_rows`` beside the plain version, a per-expert cuBLAS
    loop (TF32 off) over the rows given and over the live rows, and both
    bounds."""
    import torch

    from dlrover_tpu_torch.ops import flash_check

    te, live = rl.tile_expert, rl.live_rows
    rows, k = x.shape
    n = dy.shape[1]
    el = int(te.max().item()) + 1
    n_live = live.item()
    ends = expert_ends(te)

    def run(lr):
        return gm.grouped_matmul_dw(x, dy, te, el, BLOCK_T, lr)

    ref64 = torch.stack([x[ends[i]:ends[i + 1]].double().t()
                         @ dy[ends[i]:ends[i + 1]].double()
                         for i in range(el)])
    errs, outs = {}, {}
    for tag, lr in (("all rows", None), ("live_rows", live)):
        got = outs[tag] = run(lr)
        right = gm.grouped_matmul_dw_plain(x, dy, te, el, BLOCK_T, lr)
        torch.cuda.synchronize()
        ok = flash_check.rows_close(got, right) and bool(
            torch.allclose(got, right, atol=1e-4, rtol=1e-4))
        if not ok:
            fail(f"B5 f32 {label} disagrees with its plain version ({tag}): "
                 f"{flash_check.row_errors(got, right)}")
        errs[tag] = {"kernel": f64_errors(got, ref64),
                     "plain": f64_errors(right, ref64)}
        del right
    if not torch.equal(outs["all rows"], outs["live_rows"]):
        fail(f"B5 f32 {label}: the run with live_rows differs from the one "
             f"without it on inputs zero past it")
    del outs, got, ref64

    def loop(end):
        cut = [min(e, end) for e in ends]
        for i in range(el):
            x[cut[i]:cut[i + 1]].t() @ dy[cut[i]:cut[i + 1]]

    r = f32_times(run, lambda: gm.grouped_matmul_dw_plain(
        x, dy, te, el, BLOCK_T, live), loop, rl, rows,
                  grouped_f32_bounds(rows, k, n, el, n_live, dw=True), errs)
    log_f32_times(f"B5 f32 {label}", r)
    return r


def ep_dw_forms(gm, quantize, v, s, rl, f, seed=21):
    """B5's two f32 forms on rank 0's layout (``dw_f32_form_times``): the
    up projection's dw (the dequantized rows and a gradient of y's
    shape [rows, F]) and the down projection's (h [rows, F] and a
    gradient [rows, D]), the gradients and h random on the live rows
    and zero past them, as the layout leaves them."""
    import torch

    rows, d = v.shape
    n = rl.live_rows.item()
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def live(*shape):
        t = torch.randn(shape, generator=gen, device="cuda")
        t[n:] = 0.0
        return t

    out = {}
    for label, make in (
            ("dw up", lambda: (quantize.dequantize_block_scaled(v, s),
                               live(rows, f))),
            ("dw down", lambda: (live(rows, f), live(rows, d)))):
        x, dy = make()
        out[label] = dw_f32_form_times(gm, label, x, dy, rl)
        del x, dy
        torch.cuda.empty_cache()
    return out


def f32_times(run, plain, loop, rl, rows, bounds, errs):
    """Phase 10's times of one f32 kernel, ``run(live_rows)``: both clocks
    with the layout's ``live_rows`` (as the main path calls it) and
    without, its plain version ``plain()``, ``loop(end)`` (a per-expert
    cuBLAS loop over the rows below ``end``) over every row and over the
    live rows, and the SM clock while it runs; with ``bounds`` and the
    f64 errors ``errs`` beside them."""
    live, n_live = rl.live_rows, rl.live_rows.item()
    return {"ms": time_ms(lambda: run(live)),
            "device_ms": device_ms(lambda: run(live)),
            "all_rows_ms": time_ms(lambda: run(None)),
            "all_rows_device_ms": device_ms(lambda: run(None)),
            "plain_ms": time_ms(plain, iters=5, warmup=1),
            "loop_ms": time_ms(lambda: loop(rows), iters=5, warmup=1),
            "loop_live_ms": time_ms(lambda: loop(n_live), iters=5,
                                    warmup=1),
            "bounds": bounds, "clocks": clocks_under(lambda: run(live)),
            "f64": errs, "rows": rows, "live_rows": n_live}


def log_f32_times(label, r):
    """One f32 kernel's phase-10 line: times, bounds, shares, errors."""
    b = r["bounds"]
    share = b["live"]["ffma_ms"] / r["device_ms"]
    share_all = b["given"]["ffma_ms"] / r["all_rows_device_ms"]
    r["share"], r["all_rows_share"] = share, share_all
    e = r["f64"]["live_rows"]
    log(f"  {label}: {r['ms']:.3f} ms (device alone {r['device_ms']:.3f}) "
        f"with live_rows {r['live_rows']} of {r['rows']}; all rows "
        f"{r['all_rows_ms']:.3f} ({r['all_rows_device_ms']:.3f}); plain "
        f"{r['plain_ms']:.3f}; per-expert cuBLAS loop (TF32 off) "
        f"{r['loop_ms']:.3f}, over the live rows {r['loop_live_ms']:.3f}; "
        f"bounds FFMA {b['given']['ffma_ms']:.3f} given / "
        f"{b['live']['ffma_ms']:.3f} live, 3xTF32 "
        f"{b['given']['tf32x3_ms']:.3f} / {b['live']['tf32x3_ms']:.3f} "
        f"({b['given']['gflop']:.1f} / {b['live']['gflop']:.1f} GFLOP); "
        f"share of the FFMA bound {share:.3f} live, {share_all:.3f} all "
        f"rows (device alone); f64: kernel norm ratio "
        f"{e['kernel']['norm_ratio']:.3e} bias {e['kernel']['bias']:.3e}, "
        f"plain {e['plain']['norm_ratio']:.3e} / {e['plain']['bias']:.3e}; "
        f"while it runs the SM clock reads {r['clocks']['sm_mhz']} MHz "
        f"and the card draws {r['clocks']['power_w']} W (medians of "
        f"{r['clocks']['samples']} nvidia-smi samples)")
    if share > 1.0 or share_all > 1.0:
        fail(f"{label} reads above its bound ({share:.3f}, {share_all:.3f})")


def ep_f32_forms(gm, quantize, v, s, w_up, rl, seed=20):
    """B4's four f32 forms on rank 0's layout (``f32_form_times``): the
    up projection's y (the dequantized rows), the down projection's y
    (h [rows, F]), and the backward's dx through w_down^T (g [rows, D])
    and through w_up^T (gh [rows, F]); h, g and gh random on the live
    rows and zero past them, as the layout leaves them; w_down [el, F,
    D] from bf16 as w_up."""
    import torch

    rows, d = v.shape
    el, _, f = w_up.shape
    n = rl.live_rows.item()
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def live(t):
        t[n:] = 0.0
        return t

    w_down = rnd(el, f, d, scale=f ** -0.5).to(torch.bfloat16).float()
    out = {}
    for label, a, w, tw in (
            ("y up", quantize.dequantize_block_scaled(v, s), w_up, False),
            ("y down", live(rnd(rows, f)), w_down, False),
            ("dx through w_down^T", live(rnd(rows, d)), w_down, True),
            ("dx through w_up^T", live(rnd(rows, f)), w_up, True)):
        out[label] = f32_form_times(gm, label, a, w, rl, tw)
        del a
        torch.cuda.empty_cache()
    return out


def quant_times(gm, quantize, v, s, w, rl):
    """B6 at the main shape, with the layout's ``live_rows`` (as the main
    path calls it) and without: kernel (both clocks), plain, dequantize
    plus a per-expert torch.matmul loop (TF32 off) over the rows given
    and over the live rows, both bounds over the rows given and the
    live rows, f64 errors of kernel and plain. No single PyTorch call
    computes this function: torch._grouped_mm takes bf16,
    torch._scaled_grouped_mm wants both operands in fp8."""
    import torch

    te, live = rl.tile_expert, rl.live_rows
    rows, d = v.shape
    el, _, f = w.shape
    n_live = live.item()
    ends = expert_ends(te)
    xd = quantize.dequantize_block_scaled(v, s)
    ref64 = torch.zeros((rows, f), dtype=torch.float64, device=v.device)
    for i in range(el):
        ref64[ends[i]:ends[i + 1]] = (xd[ends[i]:ends[i + 1]].double()
                                      @ w[i].double())
    errs = {"live_rows": {
        "kernel": f64_errors(gm.grouped_matmul_fwd_quant(
            v, s, w, te, BLOCK_T, live), ref64),
        "plain": f64_errors(gm.grouped_matmul_fwd_quant_plain(
            v, s, w, te, BLOCK_T, live), ref64)}}
    del ref64

    def run(lr):
        return gm.grouped_matmul_fwd_quant(v, s, w, te, BLOCK_T, lr)

    def loop(end):
        cut = [min(x, end) for x in ends]
        x = quantize.dequantize_block_scaled(v, s)
        for i in range(el):
            x[cut[i]:cut[i + 1]] @ w[i]

    del xd
    # B6's A is the fp8 values and their f32 scales
    r = f32_times(run, lambda: gm.grouped_matmul_fwd_quant_plain(
        v, s, w, te, BLOCK_T, live), loop, rl, rows,
                  grouped_f32_bounds(rows, d, f, el, n_live,
                                     d + 4 * s.shape[1]), errs)
    r.update({"library_ms": None, "library_device_ms": None,
              "library_call": "none: torch._grouped_mm takes bf16 and "
                              "torch._scaled_grouped_mm wants both operands "
                              "in fp8"})
    b = r["bounds"]
    r["bound_ms"] = b["live"]["ffma_ms"]
    r["bound_by"] = ("operations" if b["live"]["ffma_ms"] > b["live"][
        "bytes_ms"] else "bytes")
    r["bound_peak"] = "67 TFLOP/s f32 on the CUDA cores, live rows"
    log_f32_times("B6 (grouped_matmul_fwd_quant)", r)
    return r


def _ep_join():
    """Join the 4-rank gloo group on the one card (rank function side)."""
    import torch

    from dlrover_tpu_torch.trainer import bootstrap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worker = bootstrap.init_worker("gloo", "cuda:0")
    return worker.process_id, worker.num_processes


def ep_layer_rank(d, f, seed):
    """One rank of phase 11: one full-width MoE layer, forward and
    backward, experts sharded over the 4 ranks. (i) the fp8 wire against
    fp8_qdq, bit for bit, at C = 1 and 2, in bf16 as the model computes;
    (ii) the unquantized ("bf16") wire against the one-rank grouped
    dispatch of all 4096 tokens, in f32 so that the differently shaped
    router products cannot flip a routing tie. Loss: sum(out^2) / (T d)
    + aux, the sum of the ranks' sum(out_r^2) / (T d) + aux / P."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import grouped_matmul as gm
    from dlrover_tpu_torch.ops import moe, ring
    from dlrover_tpu_torch.parallel.mesh import ProcessMesh

    rank, ranks = _ep_join()
    e, el = MOE_EXPERTS, MOE_EXPERTS // ranks
    t = ranks * EP_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full = {"router": torch.randn(d, e, generator=gen, device="cuda")
            * d ** -0.5,
            "up": torch.randn(e, d, f, generator=gen, device="cuda")
            * d ** -0.5,
            "down": torch.randn(e, f, d, generator=gen, device="cuda")
            * f ** -0.5}
    x_all = torch.randn(t, d, generator=gen, device="cuda")
    mine = slice(rank * EP_TOKENS, (rank + 1) * EP_TOKENS)
    experts = slice(rank * el, (rank + 1) * el)
    mesh = ProcessMesh.over("data")

    def run(dtype, cfg, local=True):
        leaves = {"router": full["router"],
                  "up": full["up"][experts] if local else full["up"],
                  "down": full["down"][experts] if local else full["down"]}
        leaves = {k: v.to(dtype).detach().requires_grad_()
                  for k, v in leaves.items()}
        x = (x_all[mine] if local else x_all).to(dtype).requires_grad_()
        params = {"router": {"kernel": leaves["router"]},
                  "experts": {"up": {"kernel": leaves["up"]},
                              "down": {"kernel": leaves["down"]}}}
        out, aux, metrics = moe.moe_ffn(params, x[None], cfg,
                                        activation=F.silu)
        loss = out.float().square().sum() / (t * d) + (
            aux / ranks if local else aux)
        loss.backward()
        grads = {k: v.grad for k, v in leaves.items()}
        grads["x"] = x.grad
        return loss.detach(), aux.detach(), out.detach(), grads, metrics

    result = {"rank": rank, "fp8": {}}
    for chunks in (1, 2):
        runs = {}
        for precision in ("fp8", "fp8_qdq"):
            gm.reset_launch_counts()
            cfg = moe.MoEConfig(num_experts=e, top_k=MOE_TOP_K,
                                dispatch="grouped_ep", mesh=mesh,
                                ep_axes=("data",), dispatch_chunks=chunks,
                                precision=precision)
            runs[precision] = run(torch.bfloat16, cfg)
            torch.cuda.synchronize()
            runs[precision] += (gm.launch_counts(),)
        (lq, aq, oq, gq, mq, cq), (lr, ar, orf, gr, _, cr) = (
            runs["fp8"], runs["fp8_qdq"])
        same = {"loss": torch.equal(lq, lr), "aux": torch.equal(aq, ar),
                "out": torch.equal(oq, orf)}
        same.update({f"grad {k}": torch.equal(gq[k], gr[k]) for k in gq})
        result["fp8"][chunks] = {
            "bitwise": same, "dropped_frac": mq["dropped_frac"].item(),
            "launches_fp8": cq, "launches_fp8_qdq": cr,
            "loss": lq.item()}
        del runs
        torch.cuda.empty_cache()
    # (ii) the unquantized wire over 4 ranks against the one-rank
    # grouped dispatch of all tokens, f32
    ep_cfg = moe.MoEConfig(num_experts=e, top_k=MOE_TOP_K,
                           dispatch="grouped_ep", mesh=mesh,
                           ep_axes=("data",), dispatch_chunks=1,
                           precision="bf16")
    l_ep, _, o_ep, g_ep, m_ep = run(torch.float32, ep_cfg)
    ref_cfg = moe.MoEConfig(num_experts=e, top_k=MOE_TOP_K,
                            dispatch="grouped")
    l_ref, _, o_ref, g_ref, _ = run(torch.float32, ref_cfg, local=False)
    loss_ep = ring.all_reduce_(l_ep.clone()).item()
    router_ep = ring.all_reduce_(g_ep["router"].clone())
    pairs = {"out": (o_ep[0], o_ref[0][mine]), "x": (g_ep["x"],
                                                     g_ref["x"][mine]),
             "up": (g_ep["up"], g_ref["up"][experts]),
             "down": (g_ep["down"], g_ref["down"][experts])}
    if rank == 0:
        pairs["router"] = (router_ep, g_ref["router"])
    sums = torch.zeros(2 * 5, device="cuda", dtype=torch.float64)
    for i, key in enumerate(("out", "x", "up", "down", "router")):
        if key in pairs:
            a, b = pairs[key]
            sums[2 * i] = (a.double() - b.double()).square().sum()
            sums[2 * i + 1] = b.double().square().sum()
    ring.all_reduce_(sums)
    gaps = {key: (sums[2 * i] / sums[2 * i + 1]).sqrt().item()
            for i, key in enumerate(("out", "x", "up", "down", "router"))}
    grad = sums[2:].view(-1, 2).sum(dim=0)
    result["bf16_vs_grouped"] = {
        "loss_ep": loss_ep, "loss_ref": l_ref.item(),
        "loss_gap": abs(loss_ep - l_ref.item()),
        "grad_gap": (grad[0] / grad[1]).sqrt().item(), "gaps": gaps,
        "dropped_frac": m_ep["dropped_frac"].item()}
    dist.destroy_process_group()
    return result


def ep_train_rank(argv, profile_last):
    """One rank of phase 12: ``examples/train_llama.py``'s entry point as
    a launched job would run it; the launch counters and exchange
    statistics are reset just before and read just after. With
    ``profile_last`` rank 0's last step runs under torch.profiler: its
    device time by kernel group (the other ranks' kernels share the
    card and are not in it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.examples import train_llama
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import grouped_matmul as gm
    from dlrover_tpu_torch.ops import ring
    from dlrover_tpu_torch.telemetry import attribution
    from dlrover_tpu_torch.trainer.executor import TrainHook

    class Record(TrainHook):
        """CUDA events and host clocks around each step of this rank;
        with ``profile``, torch.profiler over the last step."""

        def __init__(self, profile):
            self.events, self.host, self.metrics = [], [], {}
            self.profile, self.prof = profile, None

        def _mark(self):
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()
            self.host.append(time.perf_counter())

        def before_step(self, step):
            self._mark()
            if self.profile and step == EP_STEPS:
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()

        def after_step(self, step, metrics):
            self.metrics[step] = metrics

        def end(self, executor):
            self._mark()
            if self.prof is not None:
                torch.cuda.synchronize()
                self.prof.__exit__(None, None, None)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # rank 0 only: the profiler's own cost stays off the other ranks
    record = Record(profile_last
                    and os.environ.get(NodeEnv.PROCESS_ID) == "0")
    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    gm.reset_launch_counts()
    ring.reset_stats()
    out = train_llama.main(argv, hooks=[record])
    torch.cuda.synchronize()
    counts = {**fa.launch_counts(), **gm.launch_counts()}
    step_ms = [a.elapsed_time(b) for a, b in zip(record.events,
                                                 record.events[1:])]
    host_s = [b - a for a, b in zip(record.host, record.host[1:])]
    groups = {}
    if record.prof is not None:
        for evt in record.prof.key_averages():
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(evt, "is_user_annotation", False)):
                continue
            group = attribution.kernel_group(evt.key)
            groups[group] = groups.get(group, 0.0) + (
                getattr(evt, "device_time_total", 0) or 0) / 1e3
    return {"step": out["step"], "launches": counts, "step_ms": step_ms,
            "host_step_s": host_s,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "exchange": ring.stats(), "metrics": record.metrics,
            "profile_groups_ms": groups}


def ep_phases(run_local, llama, moe_config, card):
    """Phases 11 and 12, each over EP_RANKS spawned ranks on the card."""
    d, f = moe_config.hidden_size, moe_config.intermediate_size
    report = {}
    log(f"one MoE layer at full width over {EP_RANKS} ranks sharing the "
        f"card (gloo; {EP_TOKENS} tokens per rank, top-{MOE_TOP_K} over "
        f"{MOE_EXPERTS} experts, {MOE_EXPERTS // EP_RANKS} per rank, D={d}, "
        f"F={f}), forward and backward:")
    t0 = time.monotonic()
    ranks = run_local(ep_layer_rank, EP_RANKS, (d, f, 11), timeout=EP_TIMEOUT)
    for r in ranks:
        for chunks, res in r["fp8"].items():
            bad = [k for k, ok in res["bitwise"].items() if not ok]
            log(f"  rank {r['rank']} C={chunks}: fp8 wire vs fp8_qdq: "
                + ("bitwise equal (loss, aux, output, every gradient)"
                   if not bad else f"DIFFERENT in {bad}")
                + f"; dropped_frac {res['dropped_frac']}; launches fp8 "
                f"{res['launches_fp8']}, fp8_qdq {res['launches_fp8_qdq']}")
            if bad:
                fail(f"the fp8 wire differs from fp8_qdq on rank "
                     f"{r['rank']} at C={chunks}: {bad}")
            if res["dropped_frac"] != 0.0:
                fail("grouped_ep dropped tokens")
            if not (res["launches_fp8"]["grouped_matmul_fwd_quant"] > 0
                    and res["launches_fp8_qdq"]["grouped_matmul_fwd_quant"]
                    == 0):
                fail("the fp8 wire did not go through B6 (or fp8_qdq did)")
    cmp_ = ranks[0]["bf16_vs_grouped"]
    log(f"  unquantized wire over {EP_RANKS} ranks vs the one-rank grouped "
        f"dispatch (f32): loss {cmp_['loss_ep']:.9f} vs "
        f"{cmp_['loss_ref']:.9f}, gap {cmp_['loss_gap']:.3e} (limit "
        f"{MOE_LOSS_GAP_LIMIT:.0e}); gradient gap {cmp_['grad_gap']:.3e} "
        f"(limit {MOE_GRAD_GAP_LIMIT:.0e}); per leaf "
        + ", ".join(f"{k} {v:.3e}" for k, v in cmp_["gaps"].items()))
    if not (cmp_["loss_gap"] <= MOE_LOSS_GAP_LIMIT
            and cmp_["grad_gap"] <= MOE_GRAD_GAP_LIMIT
            and cmp_["dropped_frac"] == 0.0):
        fail("grouped_ep over 4 ranks disagrees with the one-rank grouped "
             "dispatch")
    log(f"  ({time.monotonic() - t0:.1f} s with the ranks' start-up)")
    report["ep_layer"] = ranks

    argv = ["--preset", "7b", "--layers", str(MOE_LAYERS), "--seq",
            str(EP_TOKENS), "--batch", str(EP_RANKS), "--steps",
            str(EP_STEPS), "--moe_experts", str(MOE_EXPERTS), "--moe_top_k",
            str(MOE_TOP_K), "--moe_dispatch", "grouped_ep",
            "--moe_precision", "fp8", "--dispatch_chunks", "1", "--device",
            "cuda:0", "--backend", "gloo"]
    log(f"expert-parallel main path: python -m dlrover_tpu_torch.examples."
        f"train_llama {' '.join(argv)} on {EP_RANKS} ranks sharing the card "
        f"(gloo: exchanges and gradient all-reduces go through host memory; "
        f"the timings are four ranks on one card, not a multi-GPU result):")
    t0 = time.monotonic()
    ranks = run_local(ep_train_rank, EP_RANKS, (argv, True),
                      timeout=EP_TIMEOUT)
    per = EP_STEPS * MOE_LAYERS
    expected = {"flash_fwd": 2 * per, "flash_bwd_dkv": per,
                "flash_bwd_dq": per, **NO_SEG, **NO_PFX,
                "grouped_matmul_fwd": 6 * per,
                "grouped_matmul_dw": 2 * per,
                "grouped_matmul_fwd_quant": 2 * per}
    tokens = EP_RANKS * EP_TOKENS
    for rank, r in enumerate(ranks):
        steps = sorted(r["metrics"])
        if r["step"] != EP_STEPS or steps != list(range(1, EP_STEPS + 1)):
            fail(f"rank {rank} trained {r['step']} steps, expected "
                 f"{EP_STEPS}")
        for step in steps:
            m = r["metrics"][step]
            if not (math.isfinite(m["loss"]) and m["finite"]):
                fail(f"non-finite loss at step {step} on rank {rank}")
            if m["moe_dropped_frac"] != 0.0:
                fail("grouped_ep dropped tokens")
        exch = sum(v["seconds"] for k, v in r["exchange"].items()
                   if k != "all_reduce")
        red = r["exchange"].get("all_reduce", {}).get("seconds", 0.0)
        wall = sum(r["host_step_s"])
        r["exchange_share"] = exch / wall
        r["all_reduce_share"] = red / wall
        log(f"  rank {rank}: launches {r['launches']}; step ms (device "
            f"clock) {[round(x, 1) for x in r['step_ms']]}; host s per step "
            f"{[round(x, 3) for x in r['host_step_s']]}; peak memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; row and count exchanges "
            f"{exch:.2f} s ({r['exchange_share']:.3f} of the steps' host "
            f"time), gradient all-reduces {red:.2f} s "
            f"({r['all_reduce_share']:.3f})")
        if r["launches"] != expected:
            fail(f"rank {rank} kernel launches {r['launches']} on the main "
                 f"path, expected {expected}")
    m0 = ranks[0]["metrics"]
    losses = [m0[s]["loss"] for s in range(1, EP_STEPS + 1)]
    if abs(losses[0] - math.log(llama.llama2_7b().vocab_size)) > 3.0:
        fail(f"first loss {losses[0]:.3f} is far from ln(vocab)")
    # steps 2..N-1: the first pays for first-call set-up, the last runs
    # under rank 0's profiler
    steady_s = statistics.mean(
        max(r["host_step_s"][i] for r in ranks)
        for i in range(1, EP_STEPS - 1))
    peak_sum = sum(r["peak_bytes"] for r in ranks)
    log(f"  losses {[round(x, 4) for x in losses]}; grad_norm "
        f"{[round(m0[s]['grad_norm'], 4) for s in range(1, EP_STEPS + 1)]}; "
        f"steady step (steps 2-{EP_STEPS - 1}, host clock, slowest rank) "
        f"{steady_s * 1e3:.1f} ms, {tokens / steady_s:.0f} tokens/s; "
        f"peak memory summed over ranks {peak_sum / 2**30:.2f} GiB "
        f"({time.monotonic() - t0:.1f} s with start-up); {card}")
    groups = ranks[0]["profile_groups_ms"]
    prof_ms = ranks[0]["host_step_s"][-1] * 1e3
    busy = sum(groups.values())
    if busy == 0.0:
        log("  profile of rank 0's last step: no device time recorded "
            "(not measured)")
    else:
        log(f"  profile of rank 0's last step ({prof_ms:.1f} ms on the host "
            f"clock, under the profiler): rank 0's kernels busy "
            f"{busy:.1f} ms ({busy / prof_ms:.3f} of the step; the other "
            f"ranks' kernels share the card)")
        for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"    {group}: {ms:.1f} ms ({ms / busy:.3f})")
    report["ep_train"] = {
        "argv": argv, "ranks": ranks, "expected_launches": expected,
        "losses": losses, "steady_step_s": steady_s,
        "profiled_step_ms": prof_ms, "profile_busy_ms": busy,
        "tokens_per_s": tokens / steady_s, "peak_bytes_sum": peak_sum}
    return report


# -- phase 13: packed documents ----------------------------------------------


def packed_segment_rows(seq, seed):
    """Segment-id rows of ``seq`` tokens, one after another: document
    lengths drawn log-uniform over [DOC_MIN, DOC_MAX] from
    ``RandomState(seed)``, packed greedily by the rule of the reference's
    text reader (``_pack_records``): a document that does not fit the
    row's remainder is split, and each piece gets a fresh id."""
    import numpy as np

    rs = np.random.RandomState(seed)
    next_id, left = 0, 0
    while True:
        row = np.empty(seq, np.int32)
        at = 0
        while at < seq:
            if left == 0:
                left = int(round(math.exp(rs.uniform(math.log(DOC_MIN),
                                                     math.log(DOC_MAX)))))
            take = min(left, seq - at)
            row[at:at + take] = next_id
            next_id, at, left = next_id + 1, at + take, left - take
        yield row


def packed_labels(labels, seg):
    """Next-token labels within a document only (the reference's
    ``_finish_row``): -100 across each boundary, on pads and at the
    row's end."""
    labels = labels.copy()
    labels[:, :-1][seg[:, :-1] != seg[:, 1:]] = -100
    labels[:, -1] = -100
    labels[seg == -1] = -100
    return labels


def packed_batch(config, seed):
    """One packed batch on the card: ``token_batch``'s tokens and the
    first row of ``packed_segment_rows(SEQ, seed)``."""
    import torch

    batch = token_batch(config, seed)
    seg = next(packed_segment_rows(SEQ, seed))[None]
    labels = packed_labels(batch["labels"].cpu().numpy(), seg)
    return {"input_ids": batch["input_ids"],
            "segment_ids": torch.as_tensor(seg, device="cuda"),
            "labels": torch.as_tensor(labels, device="cuda")}


def document_lengths(seq, seed, rows):
    """The document lengths ``packed_segment_rows(seq, seed)`` draws for
    its first ``rows`` rows: the same draws, until they fill the rows."""
    import numpy as np

    rs = np.random.RandomState(seed)
    lengths, total = [], 0
    while total < rows * seq:
        lengths.append(int(round(math.exp(rs.uniform(math.log(DOC_MIN),
                                                     math.log(DOC_MAX))))))
        total += lengths[-1]
    return lengths


def write_packed_corpus(path, seq=SEQ, seed=PACK_SEED, rows=STEPS):
    """A text file whose packed rows are ``packed_segment_rows(seq,
    seed)``'s first ``rows``: line i holds L_i - 1 printable bytes (the
    byte tokenizer's BOS makes L_i tokens), L_i from
    ``document_lengths``, the bytes from ``RandomState(seed + 1)``.
    Returns the lengths."""
    import numpy as np

    lengths = document_lengths(seq, seed, rows)
    rs = np.random.RandomState(seed + 1)
    with open(path, "wb") as f:
        for n in lengths:
            f.write(rs.randint(32, 127, size=n - 1).astype(np.uint8)
                    .tobytes() + b"\n")
    return lengths


class LineShards:
    """A shard source over ``count`` lines in shards of ``per`` lines:
    the calls the text reader makes of a sharding client, each recorded
    in ``calls``."""

    def __init__(self, count, per=8):
        self.count, self.per = count, per
        self.current_task_id = None
        self.calls = []
        self.tasks = 0  # shards handed out
        self._next = 0

    def fetch_shard(self):
        if self._next >= self.count:
            self.current_task_id = None
            self.calls.append(("fetch", None))
            return None
        start, end = self._next, min(self.count, self._next + self.per)
        self._next, self.current_task_id = end, self.tasks
        self.tasks += 1
        self.calls.append(("fetch", self.current_task_id))
        return types.SimpleNamespace(start=start, end=end,
                                     record_indices=None)

    def report_batch_done(self):
        self.calls.append(("batch_done",))

    def report_task_done(self):
        self.calls.append(("task_done", self.current_task_id))

    def report_task_done_by_id(self, task_id):
        self.calls.append(("task_done", task_id))


def packed_reader(path):
    """(the port's packer over ``path``: ShardedTextBatches, batch 1,
    SEQ tokens, pack=True; its shard source)."""
    from dlrover_tpu_torch.trainer.text_reader import (
        LineIndexedFile,
        ShardedTextBatches,
    )

    reader = LineIndexedFile(path)
    shards = LineShards(reader.count())
    return ShardedTextBatches(shards, reader, 1, seq_len=SEQ,
                              pack=True), shards


@dataclasses.dataclass
class PackedRowsProducer:
    """A coworker's ``produce_fn``: the first ``rows`` packed rows of
    ``path``. Picklable, and its module (this script) imports no torch,
    so a spawned coworker imports numpy and the text reader only."""

    path: str
    rows: int

    def __call__(self, rank, num_workers):
        source, _ = packed_reader(self.path)
        for i, batch in enumerate(source):
            if i == self.rows:
                return
            yield batch


def import_torch():
    import torch  # noqa: F401  (the cost timed is the import)


def spawn_seconds(target):
    """Wall seconds of one spawned process running ``target``."""
    import multiprocessing as mp

    t0 = time.monotonic()
    proc = mp.get_context("spawn").Process(target=target)
    proc.start()
    proc.join(timeout=120)
    if proc.is_alive():
        proc.terminate()
        proc.join()
        fail(f"a spawned process running {target.__name__} did not end "
             "within 120 s")
    if proc.exitcode != 0:
        fail(f"a spawned process running {target.__name__} exited with "
             f"{proc.exitcode}")
    return time.monotonic() - t0


def same_rows(got, want) -> bool:
    """Bit for bit: every key of ``want`` (host arrays) in ``got``
    (tensors anywhere, or arrays)."""
    import numpy as np

    def host(v):
        return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)

    return sorted(got) == sorted(want) and all(
        host(got[k]).dtype == want[k].dtype
        and host(got[k]).tobytes() == want[k].tobytes()
        and host(got[k]).shape == want[k].shape for k in want)


def data_path_checks(tmp, card):
    """Phase 13's rows: the corpus written into ``tmp`` and packed in
    this process, its segment ids against ``packed_segment_rows``, and
    the same corpus packed by one coworker through the native shm ring
    and DevicePrefetcher onto the card. Returns (host rows, report)."""
    import numpy as np
    import torch

    from dlrover_tpu_torch import native
    from dlrover_tpu_torch.trainer.shm_dataloader import (
        DevicePrefetcher,
        ShmDataLoader,
    )

    path = os.path.join(tmp, "corpus.txt")
    t0 = time.monotonic()
    lengths = write_packed_corpus(path)
    source, shards = packed_reader(path)
    rows = list(source)
    pack_s = time.monotonic() - t0
    want = packed_segment_rows(SEQ, PACK_SEED)
    for i in range(STEPS):
        if not np.array_equal(rows[i]["segment_ids"][0], next(want)):
            fail(f"the packer's row {i} has other segment ids than "
                 "packed_segment_rows")
    ids = np.concatenate([r["input_ids"].ravel() for r in rows[:STEPS]])
    done = sorted(c[1] for c in shards.calls if c[0] == "task_done")
    if done != list(range(shards.tasks)):
        fail(f"the packer reported tasks {done}, fetched {shards.tasks}")
    log(f"  packer: {len(lengths)} documents ({sum(lengths)} tokens) in "
        f"{os.path.getsize(path)} bytes packed into {len(rows)} rows in "
        f"{pack_s * 1e3:.1f} ms of host time; the first {STEPS} rows' "
        f"segment ids equal packed_segment_rows(SEQ, PACK_SEED)'s; token "
        f"ids {int(ids.min())}-{int(ids.max())}; {shards.tasks} shards, "
        f"each reported done once")

    t0 = time.monotonic()
    native.load_library()
    build_s = time.monotonic() - t0
    if not os.path.exists(native.LIB_PATH):
        fail("the native library was not built")
    torch_spawn_s = spawn_seconds(import_torch)
    t0 = time.monotonic()
    loader = ShmDataLoader(PackedRowsProducer(path, STEPS), num_workers=1,
                           slot_bytes=1 << 20, n_slots=4, timeout=60.0)
    first_s, got = None, []
    try:
        prefetch = DevicePrefetcher(iter(loader), depth=2, device="cuda")
        for batch in prefetch:
            if first_s is None:
                first_s = time.monotonic() - t0
            if any(t.device.type != "cuda" for t in batch.values()):
                fail("a batch of the shm path is not on the card")
            got.append({k: v.cpu().numpy() for k, v in batch.items()})
        prefetch.close()
    finally:
        t1 = time.monotonic()
        clean = loader.shutdown(timeout=10.0)
        shutdown_s = time.monotonic() - t1
    ring_s = time.monotonic() - t0
    if len(got) != STEPS or not all(same_rows(g, w)
                                    for g, w in zip(got, rows)):
        fail(f"the shm ring's {len(got)} rows are not the in-process "
             f"packer's first {STEPS}, bit for bit")
    if not clean:
        fail("the shm loader's coworker did not end cleanly within its "
             "10 s timeout")
    log(f"  native library built and loaded in {build_s:.2f} s "
        f"({os.path.basename(native.LIB_PATH)}); shm ring: one coworker "
        f"packed the corpus, {STEPS} rows through the ring and "
        f"DevicePrefetcher onto the card bit for bit the in-process "
        f"packer's, in {ring_s:.2f} s ({first_s:.2f} s to the first row, "
        f"the spawn included; shutdown {shutdown_s:.3f} s of its 10 s); a "
        f"spawned process importing torch: {torch_spawn_s:.2f} s; {card}")
    return rows, {
        "documents": len(lengths), "rows": len(rows),
        "pack_host_ms": pack_s * 1e3, "native_build_s": build_s,
        "shm_rows_s": ring_s, "shm_first_row_s": first_s,
        "shm_shutdown_s": shutdown_s, "spawn_import_torch_s": torch_spawn_s,
    }


def preloaded_feed(rows, seen):
    """trainer -> ``train_iter_fn``: the rows of ``rows()`` (an iterable
    of host batches, made anew at each call) through DevicePreloader on
    the card (pinned arena, copy stream, prefetch 2), placed by the
    trainer's ``shard_batch``; ``seen`` records each batch the step
    takes (its devices, copies of the first and the last) and every
    preloader made."""
    from dlrover_tpu_torch.trainer.data import DevicePreloader

    def feed(trainer):
        def train_iter():
            pre = DevicePreloader(iter(rows()), sharding=trainer.accelerated,
                                  prefetch=2)
            seen["preloaders"].append(pre)
            for batch in pre:
                seen["devices"].update(t.device.type
                                       for t in batch.values())
                # copies on the card, read back after the run: reading
                # the host copy here would wait for the steps in flight
                copy = {k: v.clone() for k, v in batch.items()}
                seen.setdefault("first", copy)
                seen["last"] = copy
                seen["taken"] += 1
                yield batch
        return train_iter
    return feed


def segment_lengths(row):
    """The lengths of a row's runs of equal ids (its documents)."""
    import numpy as np

    cuts = np.flatnonzero(np.diff(row)) + 1
    return np.diff(np.r_[0, cuts, len(row)])


def document_pairs(row) -> int:
    """The causal (q, k) pairs of a row whose tokens share a document."""
    n = segment_lengths(row).astype("int64")
    return int((n * (n + 1) // 2).sum())


def tile_lists(fa, seg_q, seg_k, causal):
    """What B1-seg, B2-seg and B3-seg schedule for these ids, counted on
    the host from ``fa.segment_tiles`` by ``flash_check.listed_tiles``
    (B1's list is B3's): per kernel,
    the tiles listed and the causal tiles visited without lists (summed
    over the batch), the blocks whose list is empty, and the longest and
    the mean list a block."""
    import torch

    from dlrover_tpu_torch.ops import flash_check

    seg_q, seg_k = (torch.as_tensor(t).cpu() for t in (seg_q, seg_k))
    lists = flash_check.listed_tiles(fa.segment_tiles(seg_q, seg_k),
                                     seg_q.shape[1], seg_k.shape[1], causal)
    out = {}
    for name, (listed, visited) in lists.items():
        per_block = listed.sum(dim=-1).flatten().float()
        out[name] = {"listed": int(listed.sum()),
                     "visited": int(visited.sum()),
                     "empty_blocks": int((per_block == 0).sum()),
                     "blocks": per_block.numel(),
                     "longest": int(per_block.max()),
                     "mean": per_block.mean().item()}
    return out


def log_tile_lists(label, counts):
    log(f"  tiles listed (computed on the host), {label}: " + "; ".join(
        f"{name}_seg {c['listed']} of {c['visited']} "
        f"({c['listed'] / c['visited']:.3f}), {c['empty_blocks']} of "
        f"{c['blocks']} lists empty, longest {c['longest']}, mean "
        f"{c['mean']:.2f}" for name, c in counts.items()))


def check_segment_faults(inputs, ids, right):
    """The row rule must reject every output of kernels whose segment
    mask is shifted by one key or which ignore the ids
    (``flash_check.segment_faults``), on the inputs of the check that
    passed."""
    from dlrover_tpu_torch.ops import flash_check

    q, k, v, do, lse, delta, scale = inputs
    results = []
    for name, fault, got in flash_check.segment_faults(
            q, k, v, do, lse, delta, scale, ids, ids):
        e = flash_check.row_errors(got, right[name])
        caught = not flash_check.rows_close(got, right[name])
        log(f"  planted fault, {name}: {fault}: worst row "
            f"{e['worst_row']:.1f} of its limit, max_abs_err "
            f"{e['max_abs_err']:.3e} -> {'rejected' if caught else 'PASSED'}")
        if not caught:
            fail(f"the kernel check lets a planted segment fault pass: "
                 f"{fault} ({name})")
        results.append({"output": name, "fault": fault, **e})
    return results


def shuffled_documents(row, seed):
    """``row``'s documents in shuffled order under permuted ids, the last
    document taking the first's id (one id recurring far apart)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    lengths = segment_lengths(row)
    out = np.repeat(rs.permutation(len(lengths)),
                    lengths[rs.permutation(len(lengths))]).astype(np.int32)
    out[out == out[-1]] = out[0]
    return out


EMPTY_LISTS = "pair form, the second half of the keys' ids negated"


def segment_layouts():
    """Phase 13's bf16 layouts at the main shape: (label, q-side ids,
    kv-side ids, causal), each a numpy int32 row."""
    import numpy as np

    train_row = next(packed_segment_rows(SEQ, PACK_SEED))
    pad_row = train_row.copy()
    pad_row[-333:] = -1  # pads after higher ids, as the text reader's
    ar = np.arange(SEQ, dtype=np.int32)
    docs = ar // 700
    return [(name, row, row, True) for name, row in (
        ("packed training row", train_row),
        ("documents of 512 tokens", ar // 512),
        ("documents of 700 tokens", docs),
        ("a -1 pad tail", pad_row),
        ("shuffled documents, an id recurring far apart",
         shuffled_documents(train_row, 1)),
        # a length that is no multiple of 64
        ("the packed row cut to 4000 tokens", train_row[:4000]))] + [
        # the pair form: kv-side ids of 700-token documents with every odd
        # id dropped, so the odd documents' rows see no key (out 0, lse
        # NEG_INF, held by the same comparison)
        ("pair form, odd ids missing on the kv side", docs,
         np.where(docs % 2 == 1, docs + 1_000_000, docs), False),
        # empty lists: the second half of the keys carries ids no row
        # has, so their B2 blocks and the rows of the later documents in
        # B3 list no tile and must store zeros
        (EMPTY_LISTS, docs, np.where(ar >= SEQ // 2, -1 - docs, docs),
         False)]


def check_empty_lists(fa, inputs, seg_q, seg_k, causal):
    """B1-seg's blocks whose tile list is empty (computed on the host by
    ``flash_check.listed_tiles`` from the ids' table) run no tile: every
    one of their rows must read out exactly 0 and lse exactly NEG_INF.
    Returns the count of such rows (over the heads)."""
    import torch

    from dlrover_tpu_torch.ops import flash_check

    q, k, v, *_, scale = inputs
    listed, _ = flash_check.listed_tiles(
        fa.segment_tiles(seg_q, seg_k), seg_q.shape[1], seg_k.shape[1],
        causal)["flash_fwd"]
    rows = (listed.sum(dim=-1) == 0).repeat_interleave(128, dim=1)
    rows = rows[:, None, :q.shape[2]].expand(q.shape[:3])
    out, lse = fa.flash_fwd(q, k, v, causal, scale, seg_q=seg_q,
                            seg_k=seg_k)
    torch.cuda.synchronize()
    n = int(rows.sum())
    zeros = bool((out[rows] == 0).all()) and bool((lse[rows] ==
                                                   fa.NEG_INF).all())
    log(f"  B1-seg's empty lists: {n} rows (over the heads) in blocks that "
        f"list no tile; out 0 and lse NEG_INF: {zeros}")
    if n == 0 or not zeros:
        fail(f"B1-seg's empty lists: {n} rows, out 0 and lse NEG_INF: "
             f"{zeros}")
    return n


def packed_kernel_checks(fa):
    """Phase 13 (a): B1-B3 in segment-id mode against their plain
    versions, with the tiles each lists on each layout (computed on the
    host), and B1's empty lists held to out 0 and lse NEG_INF; returns
    ({kernel: max abs error at the main shape}, the planted faults'
    readings, {layout: tiles listed}, the rows of B1's empty lists)."""
    import numpy as np
    import torch

    def dev(*rows):
        return torch.as_tensor(np.stack(rows).astype(np.int32),
                               device="cuda")

    errs, faults, lists, empty_rows = {}, None, {}, None
    for n, (name, row_q, row_k, causal) in enumerate(segment_layouts()):
        seg_q, seg_k = dev(row_q), dev(row_k)
        if not causal:
            blind = int((~np.isin(row_q, row_k)).sum())
            log(f"  {name}: {blind * 32} of {len(row_q) * 32} rows see no "
                f"key")
        lists[name] = tile_lists(fa, seg_q, seg_k, causal)
        log_tile_lists(name, lists[name])
        e, inputs, right = check_kernels(
            fa, 1, 32, 8, len(row_q), 128, torch.bfloat16, causal, 30 + n,
            1e-3, seg=(seg_q, seg_k), label=f"segments: {name}")
        for kernel, err in e.items():
            errs[kernel] = max(errs.get(kernel, 0.0), err)
        if n == 0:
            log("the same check against planted segment faults, same "
                "inputs:")
            faults = check_segment_faults(inputs, seg_q, right)
        if name == EMPTY_LISTS:
            empty_rows = check_empty_lists(fa, inputs, seg_q, seg_k, causal)
        del inputs, right
        torch.cuda.empty_cache()
    if any(c["empty_blocks"] == 0 for c in lists[EMPTY_LISTS].values()):
        fail(f"the empty-list layout leaves some kernel's lists all "
             f"non-empty (B1's among them must be empty): "
             f"{lists[EMPTY_LISTS]}")
    ragged = np.arange(300) // 70
    ragged[-25:] = -1
    ids = dev(ragged, np.arange(300) // 45 + 10)
    check_kernels(fa, 2, 4, 2, 300, 64, torch.float32, True, 41, 1e-4,
                  seg=(ids, ids), label="ragged, a pad tail")
    return errs, faults, lists, empty_rows


def sdpa_backend(q, k, v, mask):
    """The backend SDPA picks for these inputs (``torch._fused_sdp_choice``
    named by ``torch.nn.attention.SDPBackend``)."""
    import torch
    from torch.nn.attention import SDPBackend

    names = {m.value: name for name, m in SDPBackend.__members__.items()}
    choice = torch._fused_sdp_choice(q, k, v, attn_mask=mask, enable_gqa=True)
    return names.get(choice, str(choice))


def varlen_yardstick(q, k, v, do, row, out):
    """A varlen flash call over the row's cumulative document lengths
    (``torch.nn.attention.varlen``, where this torch has it): its forward
    and backward times, and whether its output passes the row rule
    against B1's. None and the reason where it cannot run."""
    import inspect

    import numpy as np
    import torch

    from dlrover_tpu_torch.ops import flash_check

    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError:
        return None, f"torch {torch.__version__} has no varlen_attn"
    params = inspect.signature(varlen_attn).parameters
    lengths = segment_lengths(row)
    cu = torch.as_tensor(np.r_[0, np.cumsum(lengths)], dtype=torch.int32,
                         device="cuda")
    longest = int(lengths.max())
    qt, kt, vt, dot = (t[0].transpose(0, 1).contiguous()
                       for t in (q, k, v, do))  # [S, heads, D]
    kw = {}
    if "window_size" in params:
        kw["window_size"] = (-1, 0)
    elif "is_causal" in params:
        kw["is_causal"] = True
    else:
        return None, "varlen_attn takes no causal option"
    note = "enable_gqa"
    if "enable_gqa" in params:
        kw["enable_gqa"] = True
    else:  # not the kernels' inputs: KV heads repeated first
        group = q.shape[1] // k.shape[1]
        kt, vt = (t.repeat_interleave(group, dim=1) for t in (kt, vt))
        note = "KV heads repeated beforehand"
    try:
        ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
        def fwd():
            return varlen_attn(qt, kt, vt, cu, cu, longest, longest, **kw)

        lout = varlen_attn(ql, kl, vl, cu, cu, longest, longest, **kw)

        def bwd():
            return torch.autograd.grad(lout, (ql, kl, vl), dot,
                                       retain_graph=True)

        fwd_ms, bwd_ms = time_ms(fwd), time_ms(bwd)
        fwd_dev, bwd_dev = device_ms(fwd), device_ms(bwd)
        agrees = flash_check.rows_close(
            lout.detach().transpose(0, 1)[None], out)
    except Exception as e:  # noqa: BLE001 - a yardstick, reported
        return None, f"varlen_attn failed: {type(e).__name__}: {e}"[:300]
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_device_ms": fwd_dev,
            "bwd_device_ms": bwd_dev, "gqa": note,
            "rows_close_to_b1": agrees}, None


def segmented_kernel_times(fa, row):
    """Phase 13 (b): each segmented kernel at the main shape on the
    packed row ``row``: its time through its wrapper (median of 10
    device samples; each wrapper builds the ids' tile table), the
    device's alone, and given the table as the autograd function
    launches it; the same kernel unsegmented, its plain version, its
    bound over the causal pairs and over the within-document pairs, and
    the yardsticks. Then each kernel on other layouts against the share
    of tiles it lists, with a line fitted through them."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    b, h, hkv, s, d = 1, 32, 8, SEQ, 128
    q, k, v, do = attention_inputs(b, h, hkv, s, d, torch.bfloat16, 7)
    scale = 1.0 / math.sqrt(d)
    ids = torch.as_tensor(row[None], device="cuda")
    seg = {"seg_q": ids, "seg_k": ids}
    # the autograd forward builds the ids' tile table once and launches
    # B1 with it, then B2 and B3 in the backward (``fa._launch_*``); the
    # table is timed alone
    table = fa.segment_tiles(ids, ids)
    table_ms = time_ms(lambda: fa.segment_tiles(ids, ids))
    table_dev = device_ms(lambda: fa.segment_tiles(ids, ids))
    given_table = {
        "flash_fwd": lambda: fa._launch_fwd(q, k, v, True, scale, ids, ids,
                                            None, table),
        "flash_bwd_dkv": lambda: fa._launch_bwd_dkv(
            q, k, v, do, lse, delta, True, scale, ids, ids, None, table),
        "flash_bwd_dq": lambda: fa._launch_bwd_dq(
            q, k, v, do, lse, delta, True, scale, ids, ids, None, table)}
    out, lse = fa.flash_fwd(q, k, v, True, scale, **seg)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    pairs = {"causal": s * (s + 1) // 2, "document": document_pairs(row)}
    io = 2
    qb, kb = b * h * s * d * io, b * hkv * s * d * io
    rows, idb = b * h * s * 4, 2 * b * s * 4
    tb = table.numel() * 4  # the ids' tile table
    work = {  # (flops per pair and head, bytes read once and written once)
        "flash_fwd": (4 * d, qb + 2 * kb + qb + rows + idb + tb),
        "flash_bwd_dkv": (8 * d,
                          2 * qb + 2 * kb + 2 * rows + 2 * kb + idb + tb),
        "flash_bwd_dq": (6 * d, 2 * qb + 2 * kb + 2 * rows + qb + idb + tb),
    }
    calls = {
        "flash_fwd": lambda f, **kw: f(q, k, v, True, scale, **kw),
        "flash_bwd_dkv": lambda f, **kw: f(q, k, v, do, lse, delta, True,
                                           scale, **kw),
        "flash_bwd_dq": lambda f, **kw: f(q, k, v, do, lse, delta, True,
                                          scale, **kw),
    }

    # the yardstick: SDPA with the block-diagonal causal boolean mask
    mask = ((ids[:, None, :, None] == ids[:, None, None, :])
            & torch.ones(s, s, dtype=torch.bool, device="cuda").tril())

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask,
                                              enable_gqa=True)

    backend = sdpa_backend(q, k, v, mask)
    lib_fwd = time_ms(lambda: sdpa(q, k, v))
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(ql, kl, vl)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True))
    lib_dev = {"fwd": device_ms(lambda: sdpa(q, k, v)),
               "bwd": device_ms(lambda: torch.autograd.grad(
                   lib_out, (ql, kl, vl), do, retain_graph=True))}
    del lib_out
    varlen, why = varlen_yardstick(q, k, v, do, row, out)
    log(f"  the row: {len(segment_lengths(row))} documents, "
        f"{pairs['document']} of {pairs['causal']} causal pairs within a "
        f"document ({pairs['document'] / pairs['causal']:.3f})")
    log(f"  SDPA with the block-diagonal causal mask (enable_gqa): fwd "
        f"{lib_fwd:.3f} ms, bwd {lib_bwd:.3f} ms (device alone "
        f"{lib_dev['fwd']:.3f}, {lib_dev['bwd']:.3f}); backend {backend}")
    if varlen is None:
        log(f"  varlen flash: not measured ({why})")
    else:
        log(f"  varlen flash ({varlen['gqa']}): fwd {varlen['fwd_ms']:.3f} "
            f"ms, bwd {varlen['bwd_ms']:.3f} ms (device alone "
            f"{varlen['fwd_device_ms']:.3f}, {varlen['bwd_device_ms']:.3f});"
            f" its output passes the row rule against B1's: "
            f"{varlen['rows_close_to_b1']}")
    results = {}
    for name, (per_pair, nbytes) in work.items():
        samples = time_samples(lambda: calls[name](fa.WRAPPERS[name], **seg))
        kernel_ms = statistics.median(samples)
        dev_ms = device_ms(lambda: calls[name](fa.WRAPPERS[name], **seg))
        given = {"ms": time_ms(given_table[name]),
                 "device_ms": device_ms(given_table[name])}
        dense_ms = time_ms(lambda: calls[name](fa.WRAPPERS[name]))
        plain_ms = time_ms(lambda: calls[name](fa.PLAIN[name], **seg),
                           iters=5, warmup=1)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bounds = {key: max(b * h * per_pair * n / PEAK_BF16_FLOPS * 1e3,
                           t_bytes) for key, n in pairs.items()}
        t_ops = b * h * per_pair * pairs["document"] / PEAK_BF16_FLOPS * 1e3
        r = results[name] = {
            "ms": kernel_ms, "samples_ms": samples,
            "unsegmented_ms": dense_ms, "plain_ms": plain_ms,
            # what this row's data needs: the within-document pairs
            "bound_ms": bounds["document"],
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_causal_ms": bounds["causal"],
            "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd,
            "device_ms": dev_ms,
            "library_device_ms": lib_dev["fwd" if name == "flash_fwd"
                                         else "bwd"],
            "given_table": given,
            "varlen_ms": (None if varlen is None else
                          varlen["fwd_ms" if name == "flash_fwd"
                                 else "bwd_ms"]),
        }
        log(f"  {name} segmented: {kernel_ms:.3f} ms (samples "
            f"{min(samples):.3f}-{max(samples):.3f}; device alone "
            f"{dev_ms:.3f} ms; given the table {given['ms']:.3f} ms, "
            f"device alone {given['device_ms']:.3f}), unsegmented "
            f"{dense_ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
            f"{r['bound_ms']:.3f} ms over the within-document pairs "
            f"({r['bound_ms'] / kernel_ms:.3f} of it), "
            f"{r['bound_causal_ms']:.3f} ms over the causal pairs "
            f"({r['bound_causal_ms'] / kernel_ms:.3f}); "
            f"{kernel_ms / r['library_ms']:.2f}x SDPA's masked "
            f"{'forward' if name == 'flash_fwd' else 'backward'}")
    fwd = results["flash_fwd"]
    log(f"  B1-seg through its wrapper: {fwd['ms']:.3f} ms (device alone "
        f"{fwd['device_ms']:.3f}); given the table as the autograd forward "
        f"launches it {fwd['given_table']['ms']:.3f} ms (device alone "
        f"{fwd['given_table']['device_ms']:.3f}); the table (segment_tiles, "
        f"once a layer) {table_ms:.3f} ms (device alone {table_dev:.3f})"
        + ("" if varlen is None else
           f"; varlen's forward {varlen['fwd_ms']:.3f} ms (device alone "
           f"{varlen['fwd_device_ms']:.3f}): "
           f"{fwd['ms'] / varlen['fwd_ms']:.2f}x, device alone "
           f"{fwd['device_ms'] / varlen['fwd_device_ms']:.2f}x, given the "
           f"table {fwd['given_table']['ms'] / varlen['fwd_ms']:.2f}x")
        + f"; {fwd['ms'] / lib_fwd:.2f}x SDPA's masked forward; "
        f"unsegmented B1 {fwd['unsegmented_ms']:.3f} ms")
    bwd = ("flash_bwd_dkv", "flash_bwd_dq")
    pair = {key: sum(results[n][key] for n in bwd)
            for key in ("ms", "device_ms")}
    pair.update({f"given_table_{key}": sum(
        results[n]["given_table"][key] for n in bwd)
        for key in ("ms", "device_ms")})
    log(f"  B2-seg + B3-seg through their wrappers: {pair['ms']:.3f} ms "
        f"(device alone {pair['device_ms']:.3f}); given the table as the "
        f"backward launches them {pair['given_table_ms']:.3f} ms (device "
        f"alone {pair['given_table_device_ms']:.3f})"
        + ("" if varlen is None else
           f"; varlen's backward {varlen['bwd_ms']:.3f} ms (device alone "
           f"{varlen['bwd_device_ms']:.3f}): "
           f"{pair['ms'] / varlen['bwd_ms']:.2f}x, device alone "
           f"{pair['device_ms'] / varlen['bwd_device_ms']:.2f}x")
        + f"; {pair['ms'] / lib_bwd:.2f}x SDPA's masked backward")
    # the same kernels on other layouts: what the segment machinery costs
    # where no tile needs an element mask (one document; documents on
    # tile edges), and where some do, beside the share of tiles each
    # kernel lists; B1 also given the table, as the autograd forward
    # launches it
    ar = np.arange(s, dtype=np.int32)
    layout_ms, layout_lists = {}, {}
    for name, lay in (("one document", np.zeros(s, np.int32)),
                      ("documents of 512", ar // 512),
                      ("documents of 700", ar // 700),
                      ("the packed row", row)):
        lids = torch.as_tensor(lay[None], device="cuda")
        ltab = fa.segment_tiles(lids, lids)
        layout_ms[name] = {k: time_ms(lambda: calls[k](
            fa.WRAPPERS[k], seg_q=lids, seg_k=lids)) for k in work}
        layout_ms[name].update({f"{k}_device": device_ms(lambda: calls[k](
            fa.WRAPPERS[k], seg_q=lids, seg_k=lids)) for k in work})
        layout_ms[name]["flash_fwd_given_table_device"] = device_ms(
            lambda: fa._launch_fwd(q, k, v, True, scale, lids, lids, None,
                                   ltab))
        layout_lists[name] = tile_lists(fa, lids, lids, True)
        log(f"  segmented on {name}: "
            + ", ".join(f"{k} {layout_ms[name][k]:.3f} ms (device alone "
                        f"{layout_ms[name][k + '_device']:.3f})"
                        for k in work)
            + f"; flash_fwd given the table, device alone "
            f"{layout_ms[name]['flash_fwd_given_table_device']:.3f} ms"
            + "; tiles listed (computed on the host) " + ", ".join(
                f"{k} {c['listed'] / c['visited']:.3f}"
                for k, c in layout_lists[name].items()))
    fits, sms = {}, torch.cuda.get_device_properties(0).multi_processor_count
    for key in (*(f"{k}_device" for k in work),
                "flash_fwd_given_table_device"):
        kernel = key.split("_device")[0].split("_given")[0]
        share = [c[kernel]["listed"] / c[kernel]["visited"]
                 for c in layout_lists.values()]
        slope, fixed = np.polyfit(
            share, [m[key] for m in layout_ms.values()], 1)
        # B1 and B3: a block a q tile and head; B2 a key tile and KV head
        blocks = layout_lists["one document"][kernel]["blocks"] * (
            hkv if kernel == "flash_bwd_dkv" else h)
        waves = blocks / sms
        fits[key] = {"fixed_ms": float(fixed), "slope_ms": float(slope),
                     "blocks": blocks, "waves": waves,
                     "fixed_per_block_us": float(fixed) / waves * 1e3}
        log(f"  {key}: about {fixed:.3f} + {slope:.3f} x share listed ms "
            f"(least squares over the four layouts); {blocks} blocks, "
            f"{waves:.2f} waves: {fits[key]['fixed_per_block_us']:.2f} us "
            f"a block at share 0")
    return results, {"sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
                     "sdpa_backend": backend, "varlen": varlen,
                     "varlen_note": why, "pairs": pairs,
                     "bwd_pair": pair, "table_ms": table_ms,
                     "table_device_ms": table_dev,
                     "layout_ms": layout_ms,
                     "layout_lists": layout_lists, "share_fits": fits}


def packed_phases(llama, fa, remat, config, card):
    """Phase 13: packed documents through the segment-id mode of B1-B3."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.telemetry import names as tm
    from dlrover_tpu_torch.telemetry.metrics import process_registry

    phase_t0 = time.monotonic()
    report = {}
    log("packed documents: B1-B3 in segment-id mode vs plain (bf16, B=1 "
        f"H=32/8 S={SEQ} D=128, causal, unless said):")
    (errs, report["planted_segment_faults"], report["tile_lists"],
     report["b1_empty_list_rows"]) = packed_kernel_checks(fa)
    torch.cuda.empty_cache()
    rows = packed_segment_rows(SEQ, PACK_SEED)
    train_rows = [next(rows) for _ in range(STEPS)]
    shares = [document_pairs(r) / (SEQ * (SEQ + 1) // 2) for r in train_rows]
    docs = [len(segment_lengths(r)) for r in train_rows]
    # B1 and B3 list one set of 128 x 128 tiles, B2 (128-key block,
    # 64-row step) pairs
    listed = {name: [] for name in ("flash_fwd", "flash_bwd_dkv")}
    for r in train_rows:
        for name, c in tile_lists(fa, r[None], r[None], True).items():
            if name in listed:
                listed[name].append(c["listed"] / c["visited"])
    report["packing"] = {"documents_per_row": docs,
                         "within_document_share": shares,
                         "listed_tile_share": listed}
    log(f"  packed rows: documents {docs}; within-document share of the "
        f"causal pairs {[round(x, 3) for x in shares]}; causal tiles "
        f"listed (computed on the host), "
        + ", ".join(f"{name}_seg{' and B3-seg' * (name == 'flash_fwd')} "
                    f"{[round(x, 3) for x in xs]} (mean {np.mean(xs):.3f})"
                    for name, xs in listed.items()))
    log(f"segmented kernel times on the first packed row ({card}):")
    times, yard = segmented_kernel_times(fa, train_rows[0])
    report["segmented_kernel_times"], report["segmented_yardsticks"] = \
        times, yard
    torch.cuda.empty_cache()

    log(f"the data path: the port's text reader and packer, the native shm "
        f"ring, DevicePrefetcher ({card}):")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        rows, report["data_path"] = data_path_checks(tmp, card)
        corpus = os.path.join(tmp, "corpus.txt")

        log(f"packed main path: llama3_8b x{LAYERS} layers, batch 1, seq "
            f"{SEQ}, {STEPS} steps of the packer's rows ({DOC_MIN}-{DOC_MAX} "
            f"token documents, log-uniform; {np.mean(docs):.1f} segments a "
            f"row, {np.mean(shares):.3f} of the causal pairs within a "
            f"document) through DevicePreloader on the card:")
        recompute = 1 if remat.remat_enabled(config.remat_policy) else 0
        expected = {**{name: 0 for name in FLASH_KERNELS}, **NO_PFX,
                    "flash_fwd_seg": STEPS * LAYERS * (1 + recompute),
                    "flash_bwd_dkv_seg": STEPS * LAYERS,
                    "flash_bwd_dq_seg": STEPS * LAYERS}
        reg = process_registry()

        def producer_wait():
            h = reg.get(tm.DATA_PRODUCER_WAIT_TIME)
            return (h.count, h.sum) if h is not None else (0, 0.0)

        seen = {"devices": set(), "taken": 0, "preloaders": []}
        wait0 = producer_wait()
        report["train_packed"] = train_main_path(
            llama, config, f"llama3_8b(num_layers={LAYERS}, max_seq_len="
            f"{SEQ}) on packed rows", "llama", (fa,), expected, card,
            batches=lambda: iter(rows),
            feed=preloaded_feed(lambda: packed_reader(corpus)[0], seen))
        wait1 = producer_wait()
    log("  (MFU by llama.flops_per_token, which counts attention over the "
        "whole sequence: the tokens of a packed row attend within their "
        "documents only)")
    slots = [pre.arena_slots() for pre in seen["preloaders"]]
    for pre in seen["preloaders"]:
        pre.close()
    if seen["devices"] != {"cuda"} or seen["taken"] != STEPS:
        fail(f"the step took {seen['taken']} batches on {seen['devices']}, "
             f"expected {STEPS} on the card")
    if not (same_rows(seen["first"], rows[0])
            and same_rows(seen["last"], rows[STEPS - 1])):
        fail("the first or last batch the step took differs from its host "
             "row")
    if slots != [3 * 3]:
        fail(f"preloaders' pinned slots {slots}, expected one preloader "
             "with 3 slots for each of its 3 keys")
    h2d = sum(t.nbytes for t in seen["first"].values())
    depth = reg.get(tm.DATA_PREFETCH_QUEUE_DEPTH)
    waits = wait1[0] - wait0[0]
    train = report["train_packed"]
    report["data_path"].update({
        "input_wait_ms_per_step": train["input_wait_ms_per_step"],
        "input_wait_frac": train["input_wait_frac"],
        "queue_depth": depth.value if depth is not None else None,
        "producer_wait_ms": (wait1[1] - wait0[1]) * 1e3 / max(waits, 1),
        "h2d_bytes_per_step": h2d})
    d = report["data_path"]
    log(f"  data path: {seen['taken']} batches on the card, the first and "
        f"last bit for bit their host rows; the executor's input wait "
        f"{d['input_wait_ms_per_step']:.3f} ms a step (INPUT_WAIT_FRAC "
        f"{d['input_wait_frac']}); preloader queue depth {d['queue_depth']}, "
        f"producer wait {d['producer_wait_ms']:.3f} ms a batch over "
        f"{waits}; H2D {h2d} bytes a step from a pinned arena of "
        f"{slots[0]} slots; steady step {train['steady_step_ms']:.1f} ms; "
        f"{card}")
    torch.cuda.empty_cache()

    log("full-width cross-check on a packed batch (use_flash True vs "
        "False, the reference with the segment bias):")
    report["cross_check_packed"] = cross_check(
        llama, config, (("flash", {"use_flash": True}),
                        ("reference", {"use_flash": False})), (fa,),
        None, GRAD_GAP_LIMIT, batch=packed_batch(config, 1))
    torch.cuda.empty_cache()
    log(f"full-width loss check on packed batches against an exact "
        f"attention with the block-diagonal bias ({card}):")
    controls = [("segment ids ignored", faulty_fwd(fa, ignore_ids=True),
                 "control"),
                ("causal mask one key too wide", faulty_fwd(fa, extra_keys=1),
                 "control"),
                ("P rounded to 5 significant bits",
                 faulty_fwd(fa, round_p=round_bits(5)), "reading")]
    report["loss_check_packed"] = loss_check(
        llama, config, fa, controls, batch_fn=packed_batch,
        b1="flash_fwd_seg")
    torch.cuda.empty_cache()
    report["phase_13_s"] = time.monotonic() - phase_t0
    log(f"phase 13: {report['phase_13_s']:.1f} s wall; the script so far "
        f"{time.monotonic() - START:.1f} s; {card}")
    return report, errs, times


# -- phase 14: GLM prefix-LM training -----------------------------------------

# glm_10b at its published widths, cut to 6 of 48 layers; the reference
# example's instruction rows, 4 x 2048 tokens
GLM_LAYERS, GLM_BATCH, GLM_SEQ = 6, 4, 2048
PFX_DESIGN = {  # the prefix-LM instantiations of B1-B3
    name: (f"{base}'s kernel; the block reads the prompt length once, and "
           "its producer and consumers visit every tile of prompt keys "
           "beside the causal ones; prompt tiles above the diagonal need no "
           "mask, and only the tiles that cross the diagonal and the end of "
           "the prompt mask by element, in the unsegmented mask's "
           "warp-uniform branch" + extra)
    for name, base, extra in (
        ("flash_fwd_pfx", "B1", "; at GLM's 64-wide heads B1's " +
         B1_D64_DESIGN),
        ("flash_bwd_dkv_pfx", "B2", "; at GLM's 64-wide heads B2's " +
         B2_D64_DESIGN),
        ("flash_bwd_dq_pfx", "B3", "; at GLM's 64-wide heads B3's " +
         B3_D64_DESIGN))
}
# The GLM loss check: the flash path's loss against an exact attention's
# (with the prefix-LM bias) over LOSS_BATCHES instruction batches, as the
# dense one. Calibrated on this configuration (PERF.md, section 6): the
# sound paths read rms 1.9e-4 to 2.0e-4 and |mean| under 2e-5; a prompt
# one key too wide reads rms 3.0e-4 (its mean, -4.6e-5, is within two
# standard errors of 0), the prefix ignored 2.8e-3. The rms limit lies
# between the two groups; the mean's stays the dense check's
GLM_LOSS_BIAS_LIMIT = 1e-4
GLM_LOSS_RMS_LIMIT = 2.5e-4


def glm_batch(config, seed):
    """One batch of the reference example's rule on the card:
    ``synth_instruction_batch(vocab, GLM_BATCH, GLM_SEQ, seed)``."""
    import torch

    from dlrover_tpu_torch.examples.train_glm_prefix import (
        synth_instruction_batch,
    )

    rows = synth_instruction_batch(config.vocab_size, GLM_BATCH, GLM_SEQ,
                                   seed)
    return {k: torch.as_tensor(v, device="cuda") for k, v in rows.items()}


def visible_pairs(prefixes, s) -> int:
    """The (q, k) pairs the prefix-LM mask lets through in rows of ``s``
    tokens with these prompt lengths: p keys for each of a row's first p
    queries, i + 1 for query i after them."""
    total = 0
    for p in prefixes:
        p = min(max(int(p), 0), s)
        total += p * p + (s * (s + 1) - p * (p + 1)) // 2
    return total


def check_prefix_faults(inputs, prefix, right):
    """The row rule must reject every output of kernels that ignore the
    prefix, take it one key too wide, or stop at the diagonal tile
    (``flash_check.prefix_faults``), and the bias rule the truncation
    controls in prefix-LM mode, on the inputs of the check that
    passed."""
    from dlrover_tpu_torch.ops import flash_check

    q, k, v, do, lse, delta, scale = inputs
    results = []
    for name, fault, got in flash_check.prefix_faults(
            q, k, v, do, lse, delta, scale, prefix):
        e = flash_check.row_errors(got, right[name])
        caught = not flash_check.rows_close(got, right[name])
        log(f"  planted fault, {name}: {fault}: worst row "
            f"{e['worst_row']:.1f} of its limit, max_abs_err "
            f"{e['max_abs_err']:.3e} -> {'rejected' if caught else 'PASSED'}")
        if not caught:
            fail(f"the kernel check lets a planted prefix fault pass: "
                 f"{fault} ({name})")
        results.append({"output": name, "fault": fault, **e})
        del got
    return results + check_bias_controls(
        flash_check.bias_controls(q, k, v, do, lse, delta, True, scale,
                                  prefix_len=prefix), right)


def check_prefix_edges(fa, b, h, s, d):
    """Prefixes 0 and 1 mask as the causal kernels do, a prefix of the
    whole row as the non-causal ones: every output of the prefix-LM
    kernels must be bit for bit theirs."""
    import torch

    q, k, v, do = attention_inputs(b, h, h, s, d, torch.bfloat16, 53)
    scale = 1.0 / math.sqrt(d)
    for prefixes, causal in (([0, 1] * (b // 2), True), ([s] * b, False)):
        p = torch.tensor(prefixes, dtype=torch.int32, device="cuda")
        ref_out, ref_lse = fa.flash_fwd(q, k, v, causal, scale)
        delta = (do.float() * ref_out.float()).sum(-1).contiguous()
        args = (q, k, v, do, ref_lse, delta)
        got = (*fa.flash_fwd(q, k, v, True, scale, prefix_len=p),
               *fa.flash_bwd_dkv(*args, True, scale, prefix_len=p),
               fa.flash_bwd_dq(*args, True, scale, prefix_len=p))
        want = (ref_out, ref_lse, *fa.flash_bwd_dkv(*args, causal, scale),
                fa.flash_bwd_dq(*args, causal, scale))
        same = {name: torch.equal(g, w) for name, g, w in zip(
            ("out", "lse", "dk", "dv", "dq"), got, want)}
        log(f"  prefixes {sorted(set(prefixes))} against the "
            f"{'causal' if causal else 'non-causal'} kernels: bitwise "
            f"equal {same}")
        if not all(same.values()):
            fail(f"the prefix-LM kernels at prefixes {sorted(set(prefixes))}"
                 f" differ from the {'causal' if causal else 'non-causal'}"
                 f" kernels: {same}")


def prefix_kernel_checks(fa, prefixes):
    """Phase 14 (a): B1-B3 in prefix-LM mode against their plain
    versions at the GLM shape on phase 14's prompts, with planted faults;
    edge prefixes; f32. Returns ({kernel: max abs error}, the faults'
    readings)."""
    import torch

    def dev(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    b, h, s, d = GLM_BATCH, 64, GLM_SEQ, 64
    p = dev(prefixes)
    errs, inputs, right = check_kernels(
        fa, b, h, h, s, d, torch.bfloat16, True, 50, 1e-3, pfx=p,
        label=f"prompts {prefixes}")
    log("the same check against planted prefix faults, same inputs:")
    faults = check_prefix_faults(inputs, p, right)
    del inputs, right
    torch.cuda.empty_cache()
    for n, edge in enumerate(([128, 127, 129, 1000], [0, 1, s, s // 2])):
        e, _, _ = check_kernels(fa, b, h, h, s, d, torch.bfloat16, True,
                                51 + n, 1e-3, pfx=dev(edge),
                                label=f"prompts {edge}")
        for kernel, err in e.items():
            errs[kernel] = max(errs[kernel], err)
        torch.cuda.empty_cache()
    check_prefix_edges(fa, b, h, s, d)
    torch.cuda.empty_cache()
    check_kernels(fa, 2, 4, 2, 300, 64, torch.float32, True, 54, 1e-4,
                  pfx=dev([130, 0]), label="ragged f32, prompts [130, 0]")
    return errs, faults


def flex_yardstick(q, k, v, do, prefix, out):
    """``torch.nn.attention.flex_attention`` with a prefix-LM block mask
    (compiled; it skips masked tiles, as the kernels do): its forward and
    backward times, one call queued behind the last (``ms``) and with
    the device spinning first (``device_ms``, as SDPA's), and whether its
    output passes the row rule against B1's. None and the reason where it
    cannot run."""
    import torch

    from dlrover_tpu_torch.ops import flash_check

    try:
        from torch.nn.attention.flex_attention import (
            create_block_mask,
            flex_attention,
        )

        def mask_mod(b, h, q_idx, kv_idx):
            return (kv_idx <= q_idx) | (kv_idx < prefix[b])

        s = q.shape[2]
        block_mask = create_block_mask(mask_mod, B=q.shape[0], H=None,
                                       Q_LEN=s, KV_LEN=s, device="cuda")
        flex = torch.compile(flex_attention)

        def fwd():
            return flex(q, k, v, block_mask=block_mask)

        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        fout = flex(ql, kl, vl, block_mask=block_mask)

        def bwd():
            return torch.autograd.grad(fout, (ql, kl, vl), do,
                                       retain_graph=True)

        times = {"fwd_ms": time_ms(fwd), "bwd_ms": time_ms(bwd),
                 "fwd_device_ms": device_ms(fwd),
                 "bwd_device_ms": device_ms(bwd)}
        agrees = flash_check.rows_close(fout.detach(), out)
    except Exception as e:  # noqa: BLE001 - a yardstick, reported
        return None, f"flex_attention failed: {type(e).__name__}: {e}"[:300]
    return {**times, "rows_close_to_b1": agrees}, None


def prefix_kernel_times(fa, prefixes, unprefixed):
    """Phase 14 (b): each prefix-LM kernel at the GLM shape on phase 14's
    prompts: its time (median of 10 device samples), its plain version's,
    the bound over the visible pairs, SDPA with the boolean prefix-LM
    mask and flex_attention with a prefix-LM block mask (yardsticks the
    port never calls), beside the same kernels unprefixed
    (``unprefixed``: ``kernel_times`` at this shape)."""
    import torch
    import torch.nn.functional as F

    b, h, s, d = GLM_BATCH, 64, GLM_SEQ, 64
    q, k, v, do = attention_inputs(b, h, h, s, d, torch.bfloat16, 7)
    scale = 1.0 / math.sqrt(d)
    p = torch.tensor(prefixes, dtype=torch.int32, device="cuda")
    out, lse = fa.flash_fwd(q, k, v, True, scale, prefix_len=p)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    pairs = visible_pairs(prefixes, s)  # over the batch's rows
    qb = kb = b * h * s * d * 2
    rows = b * h * s * 4
    work = {  # (flops, bytes read once and written once)
        "flash_fwd": (4 * h * d * pairs, qb + 2 * kb + qb + rows + 4 * b),
        "flash_bwd_dkv": (8 * h * d * pairs,
                          2 * qb + 2 * kb + 2 * rows + 2 * kb + 4 * b),
        "flash_bwd_dq": (6 * h * d * pairs,
                         2 * qb + 2 * kb + 2 * rows + qb + 4 * b),
    }
    calls = {
        "flash_fwd": lambda f: f(q, k, v, True, scale, prefix_len=p),
        "flash_bwd_dkv": lambda f: f(q, k, v, do, lse, delta, True, scale,
                                     prefix_len=p),
        "flash_bwd_dq": lambda f: f(q, k, v, do, lse, delta, True, scale,
                                    prefix_len=p),
    }
    cols = torch.arange(s, device="cuda")
    mask = (cols[None, :] <= cols[:, None])[None, None] | (
        cols < p[:, None, None, None])

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask)

    backend = sdpa_backend(q, k, v, mask)
    lib_fwd = time_ms(lambda: sdpa(q, k, v))
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(ql, kl, vl)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True))
    lib_dev = {"fwd": device_ms(lambda: sdpa(q, k, v)),
               "bwd": device_ms(lambda: torch.autograd.grad(
                   lib_out, (ql, kl, vl), do, retain_graph=True))}
    del lib_out
    flex, why = flex_yardstick(q, k, v, do, p, out)
    log(f"  prompts {prefixes}: {pairs} visible (q, k) pairs, "
        f"{pairs / (b * s * (s + 1) // 2):.4f} of the causal pairs")
    log(f"  SDPA with the boolean prefix-LM mask: fwd {lib_fwd:.3f} ms, bwd "
        f"{lib_bwd:.3f} ms; backend {backend}")
    if flex is None:
        log(f"  flex_attention: not measured ({why})")
    else:
        log(f"  flex_attention with a prefix-LM block mask: fwd "
            f"{flex['fwd_ms']:.3f} ms (device alone "
            f"{flex['fwd_device_ms']:.3f}), bwd {flex['bwd_ms']:.3f} ms "
            f"(device alone {flex['bwd_device_ms']:.3f}); its output passes "
            f"the row rule against B1's: {flex['rows_close_to_b1']}")
    results = {}
    for name, (flops, nbytes) in work.items():
        samples = time_samples(lambda: calls[name](fa.WRAPPERS[name]))
        kernel_ms = statistics.median(samples)
        dev_ms = device_ms(lambda: calls[name](fa.WRAPPERS[name]))
        plain_ms = time_ms(lambda: calls[name](fa.PLAIN[name]), iters=5,
                           warmup=1)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        fwd = name == "flash_fwd"
        r = results[name] = {
            "ms": kernel_ms, "samples_ms": samples, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9,
            "library_ms": lib_fwd if fwd else lib_bwd,
            "device_ms": dev_ms,
            "library_device_ms": lib_dev["fwd" if fwd else "bwd"],
            "flex_ms": (None if flex is None else
                        flex["fwd_ms" if fwd else "bwd_ms"]),
            "flex_device_ms": (None if flex is None else
                               flex["fwd_device_ms" if fwd
                                    else "bwd_device_ms"]),
            "unprefixed_ms": unprefixed[name]["ms"],
            "unprefixed_device_ms": unprefixed[name]["device_ms"],
            "bound_share": max(t_ops, t_bytes) / kernel_ms,
        }
        log(f"  {name} prefix-LM: {kernel_ms:.3f} ms (samples "
            f"{min(samples):.3f}-{max(samples):.3f}; device alone "
            f"{dev_ms:.3f} ms, SDPA's "
            f"{r['library_device_ms']:.3f}), unprefixed (causal) "
            f"{r['unprefixed_ms']:.3f} ms, plain {plain_ms:.3f} ms; bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}, {flops / 1e9:.1f} "
            f"GFLOP over the visible pairs; {r['bound_ms'] / kernel_ms:.3f} "
            f"of it); {kernel_ms / r['library_ms']:.2f}x SDPA's masked "
            f"{'forward' if fwd else 'backward'}")
    # B2 + B3, the backward's two kernels, against the whole backward of
    # flex_attention (prefix-LM) and of SDPA (unprefixed, causal, from
    # ``kernel_times`` at this shape), by each clock
    both = {key: results["flash_bwd_dkv"][key] + results["flash_bwd_dq"][key]
            for key in ("ms", "device_ms", "unprefixed_ms",
                        "unprefixed_device_ms")}
    sdpa = unprefixed["flash_bwd_dkv"]
    against_flex = None
    if flex is not None:
        against_flex = {"ms": both["ms"] / flex["bwd_ms"],
                        "device_ms": both["device_ms"] / flex["bwd_device_ms"]}
        log(f"  B2-pfx + B3-pfx: {both['ms']:.3f} ms, "
            f"{against_flex['ms']:.3f}x flex_attention's backward "
            f"({flex['bwd_ms']:.3f}); device alone "
            f"{both['device_ms']:.3f} ms, {against_flex['device_ms']:.3f}x "
            f"({flex['bwd_device_ms']:.3f})")
    log(f"  B2 + B3 unprefixed (causal): {both['unprefixed_ms']:.3f} ms, "
        f"{both['unprefixed_ms'] / sdpa['library_ms']:.3f}x SDPA's backward "
        f"({sdpa['library_ms']:.3f}); device alone "
        f"{both['unprefixed_device_ms']:.3f} ms, "
        f"{both['unprefixed_device_ms'] / sdpa['library_device_ms']:.3f}x "
        f"({sdpa['library_device_ms']:.3f})")
    return results, {"sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
                     "sdpa_backend": backend, "flex": flex,
                     "flex_note": why, "visible_pairs": pairs,
                     "bwd_pair": both, "bwd_pair_against_flex": against_flex}


def glm_step_flops(config, prefixes, s) -> float:
    """Training FLOPs of one step: 6 x the matmul parameters (the
    projections and lm_head; not the embedding tables, norms and biases)
    x tokens, plus 12 x head_dim x heads x layers x the visible (q, k)
    pairs (two products, forward and backward)."""
    d, f, v = config.hidden_size, config.intermediate_size, config.vocab_size
    matmul = config.num_layers * (4 * d * d + 2 * d * f) + d * v
    attn = (12 * config.head_dim * config.num_heads * config.num_layers
            * visible_pairs(prefixes, s))
    return 6.0 * matmul * len(prefixes) * s + attn


def glm_train(glm, fa, remat, config, label, card):
    """Phase 14's main path: ``accelerate`` with ``glm.make_init_fn`` and
    ``make_loss_fn`` on the example's instruction batch, Adam(2e-3), for
    STEPS steps with every flash counter pinned; then a profile."""
    import types

    import torch

    from dlrover_tpu_torch.examples.train_glm_prefix import (
        adam,
        synth_instruction_batch,
    )
    from dlrover_tpu_torch.parallel.accelerate import accelerate
    from dlrover_tpu_torch.parallel.mesh import MeshPlan
    from dlrover_tpu_torch.parallel.strategy import Strategy

    host = synth_instruction_batch(config.vocab_size, GLM_BATCH, GLM_SEQ, 0)
    prefixes = host["prefix_len"].tolist()
    result = accelerate(glm.make_init_fn(config), glm.make_loss_fn(config),
                        adam(), host,
                        strategy=Strategy(mesh=MeshPlan(data=-1),
                                          rule_set="glm"), device="cuda")
    state = result.init_fn(0)
    batch = result.shard_batch(host)
    recompute = 1 if remat.remat_enabled(config.remat_policy) else 0
    layers = config.num_layers
    expected = {name: 0 for name in fa.launch_counts()}
    expected.update({"flash_fwd_pfx": STEPS * layers * (1 + recompute),
                     "flash_bwd_dkv_pfx": STEPS * layers,
                     "flash_bwd_dq_pfx": STEPS * layers})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    events, metrics = [], []

    def mark():
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    for _ in range(STEPS):
        mark()
        state, m = result.train_step(state, batch)
        metrics.append(m)
    mark()
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = GLM_BATCH * GLM_SEQ
    flops = glm_step_flops(config, prefixes, GLM_SEQ)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = [float(m["loss"]) for m in metrics]
    for step, (ms, m) in enumerate(zip(step_ms, metrics), start=1):
        log(f"  step {step}: loss={losses[step - 1]:.4f} grad_norm="
            f"{float(m['grad_norm']):.4f} {ms:.1f} ms "
            f"{tokens / ms * 1e3:.0f} tokens/s")
        if not (math.isfinite(losses[step - 1]) and bool(m["finite"])):
            fail(f"non-finite GLM loss at step {step}")
    if abs(losses[0] - math.log(config.vocab_size)) > 3.0:
        fail(f"first GLM loss {losses[0]:.3f} is far from ln(vocab) "
             f"{math.log(config.vocab_size):.3f} for a random init")
    if not losses[-1] < losses[0]:
        fail(f"the GLM loss did not fall over {STEPS} steps on one batch: "
             f"{losses}")
    # steps 2..N-1 (the first pays for first-call set-up)
    steady = events[1].elapsed_time(events[-2]) / (STEPS - 2)
    mfu = flops / (steady / 1e3) / PEAK_BF16_FLOPS
    log(f"  launches {counts} (per step: B1-pfx "
        f"{counts['flash_fwd_pfx'] / STEPS:g}, B2-pfx "
        f"{counts['flash_bwd_dkv_pfx'] / STEPS:g}, B3-pfx "
        f"{counts['flash_bwd_dq_pfx'] / STEPS:g}); steady step "
        f"{steady:.1f} ms, {tokens / steady * 1e3:.0f} tokens/s, MFU "
        f"{mfu:.4f} (step FLOPs {flops:.4e}: 6 x matmul parameters incl. "
        f"lm_head x tokens + 12 x head_dim x heads x layers x visible pairs,"
        f" against 989 TFLOP/s); peak memory {peak / 2**30:.2f} GiB; {card}")
    if counts != expected:
        fail(f"kernel launches {counts} on the GLM path, expected {expected}")
    attr = attribution_report(result, host, label, flops, card)
    trainer = types.SimpleNamespace(
        step=lambda st, bt: result.train_step(st, bt))
    profile = profile_steps(trainer, state, batch)
    summary = {
        "profile": profile, "config": label,
        "params": glm.param_count(config), "batch": GLM_BATCH,
        "seq": GLM_SEQ, "prefix_len": prefixes, "steps": STEPS,
        "losses": losses, "step_ms": step_ms, "steady_step_ms": steady,
        "tokens_per_s": tokens / steady * 1e3, "mfu": mfu,
        "step_flops": flops, "peak_memory_bytes": peak,
        "launches": counts, "expected_launches": expected,
        "attribution": attr,
    }
    del state, result
    return summary


def glm_phases(glm, fa, remat, card):
    """Phase 14: GLM prefix-LM training through the prefix-LM mode of
    B1-B3, and the kernels' checks and times at its shape."""
    import torch

    from dlrover_tpu_torch.examples.train_glm_prefix import (
        synth_instruction_batch,
    )

    report = {}
    config = glm.glm_10b(num_layers=GLM_LAYERS)
    prefixes = synth_instruction_batch(config.vocab_size, GLM_BATCH,
                                       GLM_SEQ, 0)["prefix_len"].tolist()
    log(f"prefix-LM: B1-B3 in prefix-LM mode vs plain (bf16, B={GLM_BATCH} "
        f"H=64/64 S={GLM_SEQ} D=64, unless said):")
    errs, report["planted_prefix_faults"] = prefix_kernel_checks(fa,
                                                                 prefixes)
    torch.cuda.empty_cache()
    log(f"kernel times at GLM's heads, unprefixed (bf16, B={GLM_BATCH} "
        f"H=64/64 S={GLM_SEQ} D=64, causal; {card}):")
    report["kernel_times_glm_heads"], report["sdpa_glm_heads"] = \
        kernel_times(fa, GLM_BATCH, 64, 64, GLM_SEQ, 64)
    torch.cuda.empty_cache()
    log(f"prefix-LM kernel times (bf16, B={GLM_BATCH} H=64/64 S={GLM_SEQ} "
        f"D=64; {card}):")
    times, report["prefix_yardsticks"] = prefix_kernel_times(
        fa, prefixes, report["kernel_times_glm_heads"])
    report["prefix_kernel_times"] = times
    torch.cuda.empty_cache()

    label = f"glm_10b(num_layers={GLM_LAYERS})"
    log(f"GLM main path: {label}, batch {GLM_BATCH} x {GLM_SEQ} tokens "
        f"(the example's instruction rows, prompts {prefixes}), Adam(2e-3), "
        f"{STEPS} steps:")
    report["train_glm"] = glm_train(glm, fa, remat, config, label, card)
    torch.cuda.empty_cache()
    log("full-width cross-check on an instruction batch (use_flash True vs "
        "False, the reference with the prefix-LM bias):")
    report["cross_check_glm"] = cross_check(
        glm, config, (("flash", {"use_flash": True}),
                      ("reference", {"use_flash": False})), (fa,),
        None, GRAD_GAP_LIMIT, batch=glm_batch(config, 1))
    torch.cuda.empty_cache()
    log(f"full-width loss check on instruction batches against an exact "
        f"attention with the prefix-LM bias ({card}):")
    controls = [("prefix ignored", faulty_fwd(fa, ignore_prefix=True),
                 "control"),
                ("prefix one key too wide", faulty_fwd(fa, prefix_extra=1),
                 "control"),
                ("P rounded to 5 significant bits",
                 faulty_fwd(fa, round_p=round_bits(5)), "reading")]
    report["loss_check_glm"] = loss_check(
        glm, config, fa, controls, bias_limit=GLM_LOSS_BIAS_LIMIT,
        rms_limit=GLM_LOSS_RMS_LIMIT, batch_fn=glm_batch, b1="flash_fwd_pfx")
    torch.cuda.empty_cache()
    return report, errs, times


# -- phase 15: checkpoint and restore ----------------------------------------

CKPT_SAVE_AT, CKPT_STEPS = 3, 6  # the save after step 3; train to step 6
DIGEST_CHUNK = 1 << 26  # elements a digest reduces at once


def tensor_digest(t):
    """Two position-weighted int64 sums of a tensor's bits per chunk,
    reduced on its device: equal tensors give equal lists, and one
    flipped bit changes the list."""
    import torch

    t = t.detach().reshape(-1)
    bits = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])
    sums = []
    for lo in range(0, bits.numel(), DIGEST_CHUNK):
        c = bits[lo:lo + DIGEST_CHUNK].to(torch.int64)
        w = torch.arange(lo, lo + c.numel(), device=c.device,
                         dtype=torch.int64) * 2654435761 + 1
        sums += [int(c.sum()), int((c * w).sum())]
    return sums


def state_digest(state):
    """``tensor_digest`` of every parameter and optimizer slot."""
    from dlrover_tpu_torch.checkpoint.manager import state_tensors

    tensors, _ = state_tensors(state)
    return [x for name in sorted(tensors)
            for x in tensor_digest(tensors[name])]


class PlantedNaN:
    """The main path's loss with one NaN planted: after ``arm(n)`` the
    n-th call on the card returns NaN, and the calls after it are clean
    again (the attribution capture's calls on the meta device do not
    count)."""

    def __init__(self, loss_fn):
        self.loss_fn, self.countdown = loss_fn, 0

    def arm(self, n):
        self.countdown = n

    def __call__(self, params, batch, rng):
        loss, aux = self.loss_fn(params, batch, rng)
        if self.countdown and batch["input_ids"].device.type != "meta":
            self.countdown -= 1
            if self.countdown == 0:
                loss = loss * float("nan")
        return loss, aux


def meminfo_bytes(key):
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    fail(f"/proc/meminfo has no {key}")


def link_rates():
    """GB/s of a 1 GiB copy card -> page-locked host memory and back
    (median of 5 each)."""
    import torch

    n = 1 << 30
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")

    def rate(dst, src):
        samples = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            samples.append(n / (time.perf_counter() - t0) / 1e9)
        return statistics.median(samples)

    return rate(host, dev), rate(dev, host)


def disk_write_rate(directory):
    """GB/s of one 1 GiB file written and fsynced under ``directory``."""
    block = os.urandom(1 << 24)
    path = os.path.join(directory, "disk_rate.bin")
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(64):
            f.write(block)
        f.flush()
        os.fsync(f.fileno())
    rate = (1 << 30) / (time.perf_counter() - t0) / 1e9
    os.remove(path)
    return rate


def last_event(kind, since, **match):
    """The newest event of ``kind`` after the ``since``-th event of the
    ring whose fields equal ``match``."""
    from dlrover_tpu_torch.telemetry import recent_events

    for event in reversed(recent_events()[since:]):
        if event["kind"] == kind and all(event.get(k) == v
                                         for k, v in match.items()):
            return event
    fail(f"no {kind} event {match} in the phase's timeline")


def free_memory():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def checkpoint_cell(llama, config, label, rule_set, root, rates, card):
    """Phase 15 on one cell, through ElasticTrainer and TrainExecutor
    with ``ckpt_dir`` under ``root``: a HostSnapshot at step 3 and step
    4 run twice from it (determinism); a forced async save at step 3
    and steps 4-6 run on; a fresh trainer restoring in ``prepare`` from
    the staging mirror, another from disk with the mirror cleared, each
    running steps 4-6 on the same batches (losses and the state's bits
    equal); on the last, a NaN planted at step 5 under "rollback"."""
    import torch

    from dlrover_tpu_torch.examples.train_llama import synthetic_batches
    from dlrover_tpu_torch.telemetry import get_registry, names
    from dlrover_tpu_torch.telemetry import recent_events
    from dlrover_tpu_torch.trainer.conf import build_configuration
    from dlrover_tpu_torch.trainer.executor import TrainExecutor, TrainHook

    stream = synthetic_batches(config.vocab_size, 1, SEQ)()
    batches = [next(stream) for _ in range(CKPT_STEPS)]
    ckpt = os.path.join(root, rule_set)
    d2h, h2d, disk = rates
    since = len(recent_events())

    def run(trainer, state, steps):
        losses = []
        for step in steps:
            state, metrics = trainer.step(state, batches[step - 1])
            losses.append(float(metrics["loss"]))
            if not (math.isfinite(losses[-1]) and bool(metrics["finite"])):
                fail(f"{label}: non-finite step {step}")
        return state, losses

    # A: steps 1-3, a snapshot and a forced async save, step 4 twice
    trainer = main_trainer(llama, config, rule_set, batches[0],
                           ckpt_dir=ckpt)
    state = trainer.prepare()
    if state.step != 0:
        fail(f"{label}: {ckpt} held a checkpoint before the phase")
    state, _ = run(trainer, state, range(1, CKPT_SAVE_AT + 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = trainer.snapshot(state)
    take_s = time.perf_counter() - t0
    nbytes = snap.nbytes()
    t0 = time.perf_counter()
    trainer.save(state)
    stage_s = time.perf_counter() - t0
    state, first = run(trainer, state, [CKPT_SAVE_AT + 1])
    first_digest = state_digest(state)
    t0 = time.perf_counter()
    trainer.restore_snapshot(state, snap)
    snap_restore_s = time.perf_counter() - t0
    state, again = run(trainer, state, [CKPT_SAVE_AT + 1])
    digest = state_digest(state)
    deterministic = first == again and first_digest == digest
    tol = 0.0
    if not deterministic:
        # which operations have no deterministic form: run step 4 once
        # more with torch's determinism check warning on each
        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                trainer.restore_snapshot(state, snap)
                state, again = run(trainer, state, [CKPT_SAVE_AT + 1])
            finally:
                torch.use_deterministic_algorithms(False)
        ops = sorted({str(w.message).splitlines()[0] for w in caught
                      if "determinis" in str(w.message)})
        tol = abs(first[0] - again[0]) * 10
        log(f"  {label}: step {CKPT_SAVE_AT + 1} from one snapshot is NOT "
            f"deterministic (losses {first[0]!r} vs {again[0]!r}, state "
            f"bits equal: {first_digest == digest}); torch names {ops}; "
            f"the resumes below are held to 10x the loss difference, "
            f"{tol:.3e}, and their bits are not compared")
    del snap
    state, later = run(trainer, state, range(CKPT_SAVE_AT + 2,
                                              CKPT_STEPS + 1))
    want = again + later
    want_digest = state_digest(state)
    mgr = trainer.checkpoint_manager
    t0 = time.perf_counter()
    if trainer.finalize():
        fail(f"{label}: the staging mirror of step {CKPT_SAVE_AT} timed out")
    drain_s = time.perf_counter() - t0
    commit_s = mgr.commit_seconds[CKPT_SAVE_AT]
    mirror_s = last_event("ckpt_mirror", since,
                          step=CKPT_SAVE_AT)["mirror_seconds"]
    del trainer, state, mgr
    free_memory()

    def check_resume(trainer, source, what):
        mark = len(recent_events())
        t0 = time.perf_counter()
        state = trainer.prepare()
        prepare_s = time.perf_counter() - t0
        event = last_event("ckpt_restore", mark, step=CKPT_SAVE_AT)
        if state.step != CKPT_SAVE_AT or event.get("source") != source:
            fail(f"{label}: {what} restored step {state.step} from "
                 f"{event.get('source')}, expected {CKPT_SAVE_AT} from "
                 f"{source}")
        state, got = run(trainer, state, range(CKPT_SAVE_AT + 1,
                                               CKPT_STEPS + 1))
        same_bits = state_digest(state) == want_digest
        worst = max(abs(a - b) for a, b in zip(got, want))
        if worst > tol or (deterministic and not same_bits):
            fail(f"{label}: resumed from {what}: losses {got} vs {want}, "
                 f"state bits equal: {same_bits}")
        log(f"  {label}: resumed from {what} at step {CKPT_SAVE_AT} "
            f"(restore {event['restore_seconds']:.2f} s, prepare "
            f"{prepare_s:.2f} s): steps {CKPT_SAVE_AT + 1}-{CKPT_STEPS} "
            f"losses {got} equal the uninterrupted run's: {got == want}; "
            f"state bits equal: {same_bits}")
        return state, event["restore_seconds"], got == want, same_bits

    # B: a fresh trainer restores from the staging mirror
    trainer = main_trainer(llama, config, rule_set, batches[0],
                           ckpt_dir=ckpt)
    state, staging_s, staging_losses, staging_bits = check_resume(
        trainer, "staging", "the staging mirror")
    trainer.checkpoint_manager.clear_staging()
    trainer.finalize()
    del trainer, state
    free_memory()

    # C: from disk, then the rollback on the same built trainer
    loss_fn = PlantedNaN(llama.make_loss_fn(config))
    trainer = main_trainer(llama, config, rule_set, batches[0],
                           loss_fn=loss_fn, ckpt_dir=ckpt)
    state, disk_s, disk_losses, disk_bits = check_resume(
        trainer, "primary", "disk (the mirror cleared)")
    mark = len(recent_events())
    state = trainer.restore_state(state)
    if state.step != CKPT_SAVE_AT:
        fail(f"{label}: restore_state gave step {state.step}")

    class Record(TrainHook):
        def __init__(self):
            self.losses = {}

        def after_step(self, step, metrics):
            self.losses[step] = metrics["loss"]

    record = Record()
    executor = TrainExecutor(
        trainer, train_iter_fn=lambda: iter(batches[CKPT_SAVE_AT:]),
        hooks=[record], conf=build_configuration({
            "train_steps": CKPT_STEPS, "check_finite_every_steps": 1,
            "on_nonfinite": "rollback", "log_every_steps": 1}))
    executor.state = state
    rollbacks = get_registry().counter(names.NONFINITE_ROLLBACKS).value
    loss_fn.arm(2)  # the second step from here: step 5
    t0 = time.perf_counter()
    out = executor.train_and_evaluate()
    rollback_run_s = time.perf_counter() - t0
    restored = last_event("rollback_restored", mark)
    rollback_restore = last_event("ckpt_restore", mark)
    got = [record.losses[s] for s in range(CKPT_SAVE_AT + 1, CKPT_STEPS + 1)]
    rollback_bits = state_digest(executor.state) == want_digest
    if (out["step"] != CKPT_STEPS or restored["restored_step"] !=
            CKPT_SAVE_AT or restored["step"] != CKPT_SAVE_AT + 2
            or get_registry().counter(names.NONFINITE_ROLLBACKS).value
            != rollbacks + 1
            or not all(math.isfinite(v) for v in got)):
        fail(f"{label}: the rollback run ended at step {out['step']} with "
             f"losses {got} ({restored})")
    worst = max(abs(a - b) for a, b in zip(got, want))
    if worst > tol or (deterministic and not rollback_bits):
        fail(f"{label}: after the rollback, losses {got} vs {want}, state "
             f"bits equal: {rollback_bits}")
    final = last_event("ckpt_save", mark, step=CKPT_STEPS)
    final_mgr = trainer.checkpoint_manager
    log(f"  {label}: NaN planted at step {CKPT_SAVE_AT + 2} under "
        f"on_nonfinite=rollback: restored step {restored['restored_step']} "
        f"onto the built trainer ({rollback_restore['source']}, "
        f"{rollback_restore['restore_seconds']:.2f} s), finished at step "
        f"{out['step']} with losses {got} (the uninterrupted run's: "
        f"{got == want}; state bits equal: {rollback_bits}); its final "
        f"forced save staged in {final['stage_seconds']:.2f} s and "
        f"committed {final_mgr.commit_seconds[CKPT_STEPS]:.1f} s after; run "
        f"{rollback_run_s:.1f} s")
    final_mgr.clear_staging()
    del trainer, state, executor, final_mgr
    free_memory()
    shutil.rmtree(ckpt, ignore_errors=True)
    cell = {
        "config": label, "state_bytes": nbytes,
        "params": llama.param_count(config),
        "deterministic": deterministic, "loss_tolerance": tol,
        "snapshot_take_s": take_s, "snapshot_restore_s": snap_restore_s,
        "snapshot_take_gbps": nbytes / take_s / 1e9,
        "snapshot_restore_gbps": nbytes / snap_restore_s / 1e9,
        "link_d2h_gbps": d2h, "link_h2d_gbps": h2d,
        "take_bound_s": nbytes / d2h / 1e9,
        "restore_bound_s": nbytes / h2d / 1e9,
        "save_stage_s": stage_s, "commit_s": commit_s,
        "commit_gbps": nbytes / commit_s / 1e9, "mirror_s": mirror_s,
        "finalize_wait_s": drain_s,
        "restore_staging_s": staging_s, "restore_disk_s": disk_s,
        "rollback_restore_s": rollback_restore["restore_seconds"],
        "final_save_stage_s": final["stage_seconds"],
        "disk_write_gbps": disk,
        "losses": want, "staging_losses_equal": staging_losses,
        "staging_bits_equal": staging_bits,
        "disk_losses_equal": disk_losses, "disk_bits_equal": disk_bits,
        "rollback_losses": got, "rollback_bits_equal": rollback_bits,
        "card": card,
    }
    log(f"  {label}: state {nbytes / 1e9:.2f} GB; HostSnapshot.take "
        f"{take_s:.2f} s ({cell['snapshot_take_gbps']:.1f} GB/s; bound "
        f"{cell['take_bound_s']:.2f} s at {d2h:.1f} GB/s), restore "
        f"{snap_restore_s:.2f} s ({cell['snapshot_restore_gbps']:.1f} GB/s; "
        f"bound {cell['restore_bound_s']:.2f} s at {h2d:.1f} GB/s); save "
        f"stage {stage_s:.2f} s (the loop blocked), commit {commit_s:.1f} s "
        f"({cell['commit_gbps']:.2f} GB/s), mirror {mirror_s:.1f} s; "
        f"restore from staging {staging_s:.2f} s, from disk {disk_s:.2f} s, "
        f"rollback's {cell['rollback_restore_s']:.2f} s; disk write "
        f"{disk:.2f} GB/s on 1 GiB; {card}")
    return cell


# phase 15's depth: the dense cell at 2 of phase 5's 4 layers, the MoE
# cell at 1 of phase 8's 2, so that the script with phase 18 stays
# inside its time limit
CKPT_LAYERS = {"dense": 2, "moe": 1}


def checkpoint_phase(llama, config, moe_config, card):
    """Phase 15: checkpoint and restore of the dense and the MoE cell
    (``checkpoint_cell``) at full width."""
    import tempfile

    t0 = time.monotonic()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    disk_free = shutil.disk_usage(root).free
    shm = shutil.disk_usage("/dev/shm")
    ram, avail = meminfo_bytes("MemTotal"), meminfo_bytes("MemAvailable")
    log(f"  free disk under {root}: {disk_free / 2**30:.1f} GiB; /dev/shm "
        f"{shm.total / 2**30:.1f} GiB ({shm.free / 2**30:.1f} free); host "
        f"RAM {ram / 2**30:.1f} GiB ({avail / 2**30:.1f} available)")
    d2h, h2d = link_rates()
    disk = disk_write_rate(root)
    log(f"  host link (1 GiB, page-locked): {d2h:.1f} GB/s to the host, "
        f"{h2d:.1f} GB/s to the card; disk write {disk:.2f} GB/s (1 GiB, "
        f"fsynced); {card}")
    report = {"root_free_bytes": disk_free, "shm_bytes": shm.total,
              "ram_bytes": ram, "ram_available_bytes": avail,
              "link_d2h_gbps": d2h, "link_h2d_gbps": h2d,
              "disk_write_gbps": disk}
    cells = (("dense", config, "llama"), ("moe", moe_config, "moe"))
    for name, cfg, rule_set in cells:
        # the depth that keeps the whole script inside its time limit
        # since phase 18 (every check of the cell kept)
        cfg = dataclasses.replace(cfg, num_layers=CKPT_LAYERS[name])
        # the snapshot, the save's host copy and the staging copy in RAM;
        # steps 3 and 6 on disk
        state_bytes = llama.param_count(cfg) * 3 * 4
        note = ""
        if 3 * state_bytes > avail or 2 * state_bytes > disk_free:
            cfg = dataclasses.replace(cfg, num_layers=1)
            note = (f" (cut to 1 layer: 3 x {state_bytes / 2**30:.1f} GiB "
                    f"of host copies or 2 x of steps on disk do not fit)")
        label = (f"{name}: {'llama3_8b' if name == 'dense' else 'llama2_7b+moe8'}"
                 f" x{cfg.num_layers} layers, batch 1 x {SEQ}")
        log(f"checkpoint cell {label}{note}:")
        report[name] = checkpoint_cell(llama, cfg, label, rule_set, root,
                                       (d2h, h2d, disk), card)
        report[name]["cut"] = note
    shutil.rmtree(root, ignore_errors=True)
    report["wall_s"] = time.monotonic() - t0
    log(f"  phase 15 wall time {report['wall_s']:.1f} s")
    return report


# -- phase 16: in-process recovery ------------------------------------------

# 16 (a): steps at 4 ranks, at 2, and on the cold path (3 before the ring
# leg of phase 18 (a) needed the room)
RECOVERY_STEPS = 2
RECOVERY_SURVIVORS = [0, 1]
RETUNE_K, RETUNE_WINDOW = 4, 4  # 16 (b): K, and the steps in flight


def expert_digests(state, rank):
    """By global expert index: ``tensor_digest`` of that expert's slice
    of each expert leaf ([L, E/P, ...]) and of its Adam moments, so a
    slice is recognised on whichever rank holds it."""
    from dlrover_tpu_torch.checkpoint.manager import state_tensors

    tensors, _ = state_tensors(state)
    out = {}
    for name in sorted(tensors):
        t = tensors[name]
        if "/experts/" not in name or t.dim() != 4:
            continue
        for j in range(t.shape[1]):
            out.setdefault(rank * t.shape[1] + j, {})[name] = tensor_digest(
                t[:, j].contiguous())
    return out


def recovery_ep_rank(config_kw, seq, batch_rows, steps):
    """One rank of phase 16 (a): the phase-12 cell through ElasticTrainer
    on 4 ranks sharing the card, ``steps`` steps, a snapshot for the world
    of ranks 0 and 1 (first into fresh host buffers, then again into the
    same ones), ``live_reshard`` onto it (ranks 2 and 3 leave), ``steps``
    steps at 2 ranks; then on the survivors a cold trainer built for 2
    ranks with the post-change strategy, restored from the same snapshot,
    the same ``steps`` steps. Launch counters are reset just before the
    first step and read after the live steps, and again around the cold
    path."""
    import gc

    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.examples.train_llama import (
        adamw,
        synthetic_batches,
    )
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import grouped_matmul as gm
    from dlrover_tpu_torch.ops import kernel_build
    from dlrover_tpu_torch.parallel.mesh import MeshPlan
    from dlrover_tpu_torch.parallel.strategy import Strategy
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

    rank, ranks = _ep_join()
    config = llama.llama2_7b(**config_kw)

    def init_fn(gen):  # this world's block of experts
        return llama.init(gen, config, expert_shard=(dist.get_rank(),
                                                     dist.get_world_size()))

    def trainer_for(strategy):
        return ElasticTrainer(
            init_fn, llama.make_loss_fn(config), adamw(), first,
            strategy=strategy, device="cuda:0", moe_precision="fp8",
            dispatch_chunks=1)

    gen = synthetic_batches(config.vocab_size, batch_rows, seq)()
    batches = [next(gen) for _ in range(2 * steps)]
    first = batches[0]

    def run(trainer, state, group):
        losses = []
        for batch in group:
            state, metrics = trainer.step(state, batch)
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        return state, losses

    def counts():
        return {**fa.launch_counts(), **gm.launch_counts()}

    trainer = trainer_for(Strategy(mesh=MeshPlan(data=ranks, fsdp=1),
                                   rule_set="moe_ep"))
    state = trainer.prepare()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    gm.reset_launch_counts()
    t0 = time.monotonic()
    state, losses = run(trainer, state, batches[:steps])
    out = {"rank": rank, "losses": losses,
           "before_s": time.monotonic() - t0,
           "accum_before": trainer.accelerated.strategy.grad_accum_steps,
           "experts_before": expert_digests(state, rank),
           "peak_before": torch.cuda.max_memory_allocated()}
    snaps = []
    for _ in range(2):  # fresh host buffers, then the same ones again
        t = time.monotonic()
        snaps.append(trainer.snapshot(state, world_to=RECOVERY_SURVIVORS,
                                      reuse_arena=True))
        out.setdefault("snapshot_s", []).append(time.monotonic() - t)
    snap = snaps[-1]
    out["host_bytes"] = snap.nbytes()
    loads = (dict(kernel_build.LOADS), dict(kernel_build.BUILDS))
    torch.cuda.reset_peak_memory_stats()
    state = trainer.live_reshard(state, devices=RECOVERY_SURVIVORS,
                                 snapshot=snap, reason="chip_smoke")
    if state is None:  # left: give the card back to the survivors
        gc.collect()
        torch.cuda.empty_cache()
        out["left"] = True
        out["launches"] = counts()
        return out
    out["reshard"] = dict(trainer.last_reshard)
    out["rank_after"] = dist.get_rank()
    out["accum_after"] = trainer.accelerated.strategy.grad_accum_steps
    out["experts_after"] = expert_digests(state, dist.get_rank())
    t0 = time.monotonic()
    state, out["live"] = run(trainer, state, batches[steps:])
    out["after_s"] = time.monotonic() - t0
    out["launches"] = counts()
    out["live_digest"] = state_digest(state)
    out["peak_after"] = torch.cuda.max_memory_allocated()
    strategy = trainer.accelerated.strategy
    del state
    gc.collect()
    torch.cuda.empty_cache()
    cold = trainer_for(strategy)
    cstate = cold.restore_snapshot(cold.prepare(), snap)
    fa.reset_launch_counts()
    gm.reset_launch_counts()
    cstate, out["cold"] = run(cold, cstate, batches[steps:])
    out["cold_launches"] = counts()
    out["cold_digest"] = state_digest(cstate)
    out["kernels_again"] = (dict(kernel_build.LOADS) != loads[0]
                            or dict(kernel_build.BUILDS) != loads[1])
    del cstate
    dist.destroy_process_group()
    return out


def recovery_world_change(run_local, llama, moe_config, card):
    """Phase 16 (a): the expert-parallel cell from 4 ranks to 2 in the
    processes (``recovery_ep_rank``)."""
    kw = {"num_experts": MOE_EXPERTS, "moe_top_k": MOE_TOP_K,
          "moe_dispatch": "grouped_ep", "num_layers": MOE_LAYERS}
    log(f"  (a) llama2_7b+moe8 x{MOE_LAYERS} layers, grouped_ep, fp8 wire, "
        f"global batch {EP_RANKS} x {EP_TOKENS}, {EP_RANKS} ranks sharing "
        f"the card (gloo): {RECOVERY_STEPS} steps, live_reshard onto ranks "
        f"{RECOVERY_SURVIVORS}, {RECOVERY_STEPS} steps; the cold path from "
        f"the same snapshot:")
    t0 = time.monotonic()
    ranks = run_local(recovery_ep_rank, EP_RANKS,
                      (kw, EP_TOKENS, EP_RANKS, RECOVERY_STEPS),
                      timeout=EP_TIMEOUT)
    per = MOE_LAYERS  # one microbatch of each rank, per layer
    unit = {"flash_fwd": 2 * per, "flash_bwd_dkv": per, "flash_bwd_dq": per,
            **NO_SEG, **NO_PFX, "grouped_matmul_fwd": 6 * per,
            "grouped_matmul_dw": 2 * per,
            "grouped_matmul_fwd_quant": 2 * per}
    survivors, leavers = ranks[:2], ranks[2:]
    for r in leavers:
        if not r.get("left"):
            fail(f"rank {r['rank']} did not leave the world")
        if r["launches"] != {k: RECOVERY_STEPS * v for k, v in unit.items()}:
            fail(f"rank {r['rank']} launches {r['launches']} before it "
                 f"left")
    experts_before = {}
    for r in ranks:
        experts_before.update(r["experts_before"])
        if r["losses"] != ranks[0]["losses"]:
            fail("the ranks disagree on the global loss")
    report = {"ranks": ranks}
    for t, r in enumerate(survivors):
        if r.get("left") or r["rank_after"] != t:
            fail(f"rank {r['rank']} should be rank {t} of the new world")
        # at 2 ranks each step runs two microbatches a rank
        want = {k: RECOVERY_STEPS * v + 2 * RECOVERY_STEPS * v
                for k, v in unit.items()}
        if r["launches"] != want:
            fail(f"rank {t} launches {r['launches']}, expected {want}")
        want_cold = {k: 2 * RECOVERY_STEPS * v for k, v in unit.items()}
        if r["cold_launches"] != want_cold:
            fail(f"rank {t} cold-path launches {r['cold_launches']}, "
                 f"expected {want_cold}")
        if (r["accum_before"], r["accum_after"]) != (1, 2):
            fail(f"grad accumulation {r['accum_before']} -> "
                 f"{r['accum_after']}, expected 1 -> 2")
        slices = {e: experts_before[e] for e in range(4 * t, 4 * t + 4)}
        if r["experts_after"] != slices:
            fail(f"rank {t}'s expert leaves are not experts "
                 f"{4 * t}..{4 * t + 3} of the pre-change leaves")
        if r["live"] != r["cold"] or r["live_digest"] != r["cold_digest"]:
            fail(f"rank {t}: live path {r['live']} vs cold path "
                 f"{r['cold']} (state bits equal: "
                 f"{r['live_digest'] == r['cold_digest']})")
        if r["kernels_again"]:
            fail(f"rank {t} built or loaded a kernel module again")
        if not all(math.isfinite(x) for x in r["live"]):
            fail("non-finite loss after the change")
        rs = r["reshard"]
        log(f"    rank {t}: losses at 4 ranks {[round(x, 4) for x in r['losses']]}"
            f", at 2 {[round(x, 4) for x in r['live']]} (cold path equal, "
            f"state bits equal); snapshot for the new world "
            f"{r['snapshot_s'][0]:.2f} s fresh host buffers, "
            f"{r['snapshot_s'][1]:.2f} s reused; re-form "
            f"{rs['reform_s']:.3f} s, rebuild {rs['rebuild_s']:.3f} s, "
            f"restore {rs['restore_s']:.2f} s; total with the reused "
            f"snapshot {r['snapshot_s'][1] + rs['seconds']:.2f} s, with the "
            f"fresh {r['snapshot_s'][0] + rs['seconds']:.2f} s; recompiled "
            f"{rs['recompiled']}; experts {4 * t}..{4 * t + 3} held, bit "
            f"for bit; host bytes {r['host_bytes'] / 1e9:.2f} GB; peak "
            f"memory {r['peak_before'] / 2**30:.2f} GiB at 4 ranks, "
            f"{r['peak_after'] / 2**30:.2f} at 2; no kernel module built "
            f"or loaded again; steps {r['before_s']:.1f} s (3 at 4 ranks), "
            f"{r['after_s']:.1f} s (3 at 2)")
    report["wall_s"] = time.monotonic() - t0
    log(f"    ({report['wall_s']:.1f} s with the ranks' start-up; {card})")
    return report


def device_busy(prof):
    """(busy ms, span ms) of the profiled device work: the union of the
    kernels' and copies' intervals, and first start to last end."""
    import torch

    spans = sorted(
        (e.time_range.start / 1e3, e.time_range.end / 1e3)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        # kernel names may hold '#' ("{lambda()#3}"): the annotation
        # flag, not the name, tells a user annotation apart
        and not getattr(e, "is_user_annotation", False))
    if not spans:
        return 0.0, 0.0
    busy, (lo, hi) = 0.0, spans[0]
    first = lo
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    return busy, hi - first


def recovery_retune(llama, config, card):
    """Phase 16 (b): the dense cell, ``prewarm`` and ``retune`` from
    K = 1 to RETUNE_K, two fused calls through the executor's window,
    and from the same snapshot RETUNE_K x 2 single steps, bit for bit;
    the steady step and the device's idle share at K = 1 and K = RETUNE_K
    (readings)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.examples.train_llama import synthetic_batches
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import remat
    from dlrover_tpu_torch.trainer.conf import build_configuration
    from dlrover_tpu_torch.trainer.executor import TrainExecutor, TrainHook

    n = 2 * RETUNE_K
    gen = synthetic_batches(config.vocab_size, 1, SEQ)()
    batches = [next(gen) for _ in range(n + 2)]
    trainer = main_trainer(llama, config, "llama", batches[0])
    state = trainer.prepare()
    for batch in batches[:2]:  # first-call set-up
        state, _ = trainer.step(state, batch)
    torch.cuda.synchronize()
    report = {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, time.monotonic() - t

    _, fresh = timed(lambda: trainer.snapshot(state, reuse_arena=True))
    _, reused = timed(lambda: trainer.snapshot(state, reuse_arena=True))
    state, without = timed(lambda: trainer.retune(state, steps_per_call=2))
    report["retune_without_prewarm"] = dict(trainer.last_reshard,
                                            seconds_wall=without)
    state, back = timed(lambda: trainer.retune(state, steps_per_call=1))
    torch.cuda.reset_peak_memory_stats()
    count = trainer.compile_count
    built, prewarm_s = timed(lambda: trainer.prewarm(steps_per_call=RETUNE_K))
    prewarm_peak = torch.cuda.max_memory_allocated()
    if not built or trainer.compile_count != count + 1:
        fail("prewarm did not build the K-step call")
    state, with_ = timed(lambda: trainer.retune(state,
                                                steps_per_call=RETUNE_K))
    report["retune_with_prewarm"] = dict(trainer.last_reshard,
                                         seconds_wall=with_)
    if trainer.compile_count != count + 1 or \
            trainer.last_reshard["recompiled"]:
        fail("the retune after the prewarm built a step (not a cache hit)")
    log(f"  (b) llama3_8b x{config.num_layers} layers, batch 1 x {SEQ}: "
        f"snapshot {fresh:.2f} s into fresh host buffers, {reused:.2f} s "
        f"reused; retune K 1 -> 2 without a prewarm {without:.2f} s "
        f"(built), back to 1 {back:.2f} s (cache hit); prewarm(K="
        f"{RETUNE_K}) {prewarm_s:.2f} s, peak memory "
        f"{prewarm_peak / 2**30:.2f} GiB; retune K 1 -> {RETUNE_K} after it "
        f"{with_:.2f} s (cache hit: snapshot "
        f"{trainer.last_reshard['snapshot_s']:.2f}, rebuild "
        f"{trainer.last_reshard['rebuild_s']:.4f}, restore "
        f"{trainer.last_reshard['restore_s']:.2f}); {card}")
    report.update(snapshot_fresh_s=fresh, snapshot_reused_s=reused,
                  retune_back_s=back, prewarm_s=prewarm_s,
                  prewarm_peak_bytes=prewarm_peak)

    class Record(TrainHook):
        def __init__(self):
            self.losses, self.events = {}, []

        def _mark(self):
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()

        def before_step(self, step):
            # from the first dispatch: the executor's start (a new
            # step's attribution capture among it) is not a step's time
            if not self.events:
                self._mark()

        def after_step(self, step, metrics):
            self.losses[step] = metrics["loss"]

        def end(self, executor):
            self._mark()

    def through_executor(state, group, prof=None):
        record = Record()
        executor = TrainExecutor(
            trainer, train_iter_fn=lambda: iter(group), hooks=[record],
            conf=build_configuration({
                "train_steps": int(state.step) + len(group),
                "log_every_steps": 0, "train_window": RETUNE_WINDOW,
                "preemption_grace": False}))
        executor.state = state
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        with prof if prof is not None else contextlib.nullcontext():
            executor.train_and_evaluate()
            torch.cuda.synchronize()
        steps = sorted(record.losses)
        if len(steps) != len(group) or steps != list(
                range(steps[0], steps[0] + len(group))):
            fail(f"the executor materialized steps {steps}")
        ms = record.events[0].elapsed_time(record.events[-1]) / len(group)
        return (executor.state, [record.losses[s] for s in steps], ms,
                fa.launch_counts())

    ref = trainer.snapshot(state, reuse_arena=True)
    state, fused, fused_ms, fused_launches = through_executor(
        state, batches[2:])
    fused_digest = state_digest(state)
    trainer.restore_snapshot(state, ref)
    state = trainer.retune(state, steps_per_call=1)
    if trainer.compile_count != count + 1:
        fail("the retune back to K = 1 built a step")
    state, single, single_ms, single_launches = through_executor(
        state, batches[2:])
    single_digest = state_digest(state)
    recompute = 1 if remat.remat_enabled(config.remat_policy) else 0
    want = {"flash_fwd": n * LAYERS * (1 + recompute),
            "flash_bwd_dkv": n * LAYERS, "flash_bwd_dq": n * LAYERS,
            **NO_SEG, **NO_PFX}
    if fused_launches != want or single_launches != want:
        fail(f"launches {fused_launches} (K = {RETUNE_K}) and "
             f"{single_launches} (K = 1), expected {want}")
    if fused != single or fused_digest != single_digest:
        fail(f"K = {RETUNE_K} losses {fused} vs single steps {single} "
             f"(state bits equal: {fused_digest == single_digest})")
    idle = {}
    for k in (1, RETUNE_K):
        if k != trainer.steps_per_call:
            state = trainer.retune(state, steps_per_call=k)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        state, _, prof_ms, _ = through_executor(state, batches[2:], prof)
        busy, span_ms = device_busy(prof)
        idle[k] = {"busy_ms": busy / n, "span_ms": span_ms / n,
                   "idle_share": 1 - busy / span_ms if span_ms else None,
                   "profiled_step_ms": prof_ms}
    log(f"      {n} steps as {n // RETUNE_K} calls of K = {RETUNE_K} through "
        f"the executor (window {RETUNE_WINDOW} steps) and, from the same "
        f"snapshot, {n} single steps: losses equal, state bits equal, "
        f"launches {fused_launches}; losses {[round(x, 4) for x in fused]}")
    for k, ms in ((1, single_ms), (RETUNE_K, fused_ms)):
        i = idle[k]
        share = ("not measured (no device time in the profile)"
                 if i["idle_share"] is None else f"{i['idle_share']:.3f}")
        log(f"      K = {k}: step {ms:.1f} ms (device clock, {n} steps); "
            f"under the profiler {i['profiled_step_ms']:.1f} ms, device "
            f"busy {i['busy_ms']:.1f} of {i['span_ms']:.1f} ms a step, idle "
            f"share {share}")
    report.update(losses=fused, step_ms={1: single_ms, RETUNE_K: fused_ms},
                  idle=idle, launches=fused_launches)
    del state, ref
    return report


def recovery_phase(run_local, llama, config, moe_config, card):
    """Phase 16: in-process recovery on the card (16 (a) the world
    change, 16 (b) the retune)."""
    t0 = time.monotonic()
    report = {"world_change": recovery_world_change(run_local, llama,
                                                    moe_config, card)}
    free_memory()
    report["retune"] = recovery_retune(llama, config, card)
    free_memory()
    report["wall_s"] = time.monotonic() - t0
    log(f"  phase 16 wall time {report['wall_s']:.1f} s")
    return report


def _parse_entry(source, entry):
    """ctypes argument types of ``extern "C" int <entry>(...)`` in a
    kernel source's text: a pointer for each ``*`` parameter, else int
    or float."""
    import ctypes
    import re

    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", source,
                  re.S)
    if m is None:
        fail(f"no entry point {entry}")
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
            for p in m.group(1).split(",")]


def _sass_by_kernel(cuobjdump, cubin):
    """{kernel's mangled name up to the end of its template arguments:
    its SASS text, each run of blanks one space (cuobjdump pads a line to
    the widest instruction of the file)}. The parameters are left out: a
    kernel given one more pointer keeps its key."""
    text = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    return {name.strip().split("EEv")[0]: "\n".join(
                " ".join(line.split()) for line in body.strip().splitlines())
            for name, _, body in (part.partition("\n")
                                  for part in text.split("Function : ")[1:])}


AGAINST_SOURCES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
GROUPED_SOURCES = ("grouped_matmul_fwd", "grouped_matmul_dw",
                   "grouped_matmul_fwd_quant")
# each entry point's inputs (after q, k, v) and outputs
AGAINST_IO = {"flash_fwd": ((), ("out", "lse")),
              "flash_bwd_dkv": (("do", "lse", "delta"), ("dk", "dv")),
              "flash_bwd_dq": (("do", "lse", "delta"), ("dq",))}
# the bf16 entry points held against the other tree, {C name: (source,
# mode)}: segment-id ("_seg"), prefix-LM ("_pfx") and unprefixed ("")
AGAINST_ENTRIES = {f"dlr_{name}{mode}_bf16": (name, mode)
                   for mode in ("_seg", "_pfx", "")
                   for name in AGAINST_SOURCES}
# the kernels timed in turns at GLM's shape (phase 14's prompts; causal)
AGAINST_TIMED = (("flash_fwd", "_pfx"), ("flash_bwd_dkv", "_pfx"),
                 ("flash_bwd_dq", "_pfx"), ("flash_fwd", ""),
                 ("flash_bwd_dkv", ""), ("flash_bwd_dq", ""))
# which of them each timed layout of against_cases times: phase 14's
# prompts and unprefixed causal all, non-causal B1's alone
AGAINST_TIMED_LAYOUTS = {"GLM shape, causal": AGAINST_SOURCES,
                         "GLM shape, non-causal": ("flash_fwd",)}


def against_cases(prompts):
    """The layouts on which both trees' prefix-LM and unprefixed entry
    points are held bit for bit: (label, b, h, hkv, s, d, prompts or
    None, causal). GLM's shape on phase 14's prompts (``prompts``) and on
    the edge prompts of ``prefix_kernel_checks``, unprefixed causal and
    not; ragged rows whose last 128-row step is part full, a prompt
    ending inside a step or on a 64-row edge, GQA groups of 4, and a
    head dim below the 64-wide tile."""
    b, h, s, d = GLM_BATCH, 64, GLM_SEQ, 64
    glm = [(f"GLM shape, prompts {p}", b, h, h, s, d, p, True)
           for p in (prompts, [128, 127, 129, 1000], [0, 1, s, s // 2])]
    return glm + [
        ("GLM shape, causal", b, h, h, s, d, None, True),
        ("GLM shape, non-causal", b, h, h, s, d, None, False),
        ("S=1000, prompts [192, 0]", 2, 4, 4, 1000, 64, [192, 0], True),
        ("S=1000, prompts [64, 320]", 2, 4, 4, 1000, 64, [64, 320], True),
        ("S=960, non-causal", 2, 4, 4, 960, 64, None, False),
        ("S=1000, causal, GQA 8/2", 1, 8, 2, 1000, 64, None, True),
        ("S=1000, prompts [300], GQA 8/2", 1, 8, 2, 1000, 64, [300], True),
        ("S=300, D=48, prompts [130, 0]", 2, 4, 2, 300, 48, [130, 0],
         True),
    ]


def ulps(a, b) -> int:
    """The largest distance in units in the last place between two
    tensors of one floating type (bf16 or f32), 0 when they are bit for
    bit equal."""
    import torch

    bits, mask = ((torch.int16, 0x7FFF) if a.dtype == torch.bfloat16
                  else (torch.int32, 0x7FFFFFFF))

    def ordered(x):
        i = x.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & mask), i)

    return int((ordered(a) - ordered(b)).abs().max().item())


def _ptxas_lines(text):
    """The lines of ``nvcc -Xptxas -v`` output that give a kernel's
    registers or spills, or a C75xx message, each after its kernel's
    mangled name."""
    lines, kernel = [], ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif any(key in line for key in ("C75", "registers", "spill")):
            lines.append(f"{kernel.split('EEv')[0]}: {line.strip()}")
    return lines


def against(other, may_differ, variant=False, stress=0):
    """``--against DIR``: this tree's flash and grouped kernels against
    another tree's (DIR holds its ``dlrover_tpu_torch/csrc``: a parent
    from ``git archive``, or a variant of this tree's sources). Fails
    when a kernel of the six sources whose mangled name holds none of
    ``may_differ`` has other SASS (``nvcc -cubin``, ``cuobjdump -sass``)
    or is in one tree only, or
    when an output of B1's, B2's or B3's bf16 entry points differs by a
    bit between the trees: the segment-id ones on phase 13's layouts (a
    tile one tree skips adds exact zeros in the other), the prefix-LM
    and unprefixed ones on ``against_cases``. Then times both trees'
    entry points in turns (other, this, this, other): the segment-id
    ones on the packed row and on documents of 700 tokens, B1, B2 and B3
    prefix-LM and unprefixed causal at GLM's shape, and B1 non-causal
    there. An entry point's
    arguments are read from its tree's source. Then the grouped f32
    entry points (``against_grouped``). With ``variant`` (DIR is
    a variant made by hand, a stage compiled out, to time what it costs)
    outputs that differ are reported with their distance in ulps and do
    not fail the run."""
    import ctypes

    import numpy as np
    import torch

    from dlrover_tpu_torch.models import glm
    from dlrover_tpu_torch.examples.train_glm_prefix import (
        synth_instruction_batch,
    )
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import kernel_build

    report = {"card": card_line(), "other": os.path.abspath(other),
              "variant": variant}
    log(f"card: {report['card']}")
    trees = {"other": os.path.join(os.path.abspath(other),
                                   "dlrover_tpu_torch", "csrc"),
             "this": str(kernel_build.CSRC)}
    work = kernel_build.BUILD_DIR / "against"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    nvcc = kernel_build.nvcc_path()
    jobs = []
    for tree, csrc in trees.items():
        for name in AGAINST_SOURCES + GROUPED_SOURCES:
            src, out = os.path.join(csrc, f"{name}.cu"), work / f"{tree}_{name}"
            jobs.append([nvcc, "-cubin", *kernel_build.NVCC_FLAGS[:4], "-o",
                         f"{out}.cubin", src])
            jobs.append([nvcc, *kernel_build.NVCC_FLAGS, "-o", f"{out}.so",
                         src])
    t0 = time.monotonic()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in jobs]
    report["ptxas"] = {}
    for cmd, proc in zip(jobs, procs):
        text, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed for {cmd[-1]}:\n{text[-4000:]}")
        if cmd[-2].endswith(".so"):
            tree = "this" if cmd[-1].startswith(trees["this"]) else "other"
            report["ptxas"][f"{tree} {os.path.basename(cmd[-1])}"] = \
                _ptxas_lines(text)
    log(f"built both trees: {time.monotonic() - t0:.1f} s")
    for key, lines in report["ptxas"].items():
        if key.startswith("this"):
            for line in lines:
                log(f"  ptxas {key}: {line}")

    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    report["sass"] = {}
    for name in AGAINST_SOURCES + GROUPED_SOURCES:
        old, new = (_sass_by_kernel(cuobjdump, str(work / f"{t}_{name}.cubin"))
                    for t in ("other", "this"))
        for kernel in sorted(set(old) | set(new)):
            same = old.get(kernel) == new.get(kernel)
            allowed = any(m in kernel for m in may_differ)
            state = ("identical" if same else "differs" if kernel in old
                     and kernel in new else "only in the other tree"
                     if kernel in old else "only in this tree")
            report["sass"][kernel] = state
            log(f"  SASS {kernel}: {state}"
                f"{' (may differ)' if allowed else ''}")
            if not same and not allowed:
                fail(f"{kernel}: SASS {state}, against the other tree's")

    entries = {}
    for tree, csrc in trees.items():
        for entry, (name, mode) in AGAINST_ENTRIES.items():
            with open(os.path.join(csrc, f"{name}.cu")) as f:
                source = f.read()
            fn = getattr(ctypes.CDLL(str(work / f"{tree}_{name}.so")), entry)
            fn.argtypes = _parse_entry(source, entry)
            fn.restype = ctypes.c_int
            # pointers: q k v, the inputs, the outputs, the mode's own
            # (ids, prefix lengths), the stream
            ins, outs = AGAINST_IO[name]
            extra = sum(t == ctypes.c_void_p for t in fn.argtypes) - 4 - len(
                ins) - len(outs)
            entries[(tree, name, mode)] = (fn, extra)

    def run(tree, name, mode, q, k, v, do, lse, delta, extra, causal,
            scale):
        fn, n_extra = entries[(tree, name, mode)]
        ins, names = AGAINST_IO[name]
        given = {"do": do, "lse": lse, "delta": delta}
        outs = [torch.empty_like(q) if o in ("out", "dq") else
                torch.empty_like(lse) if o == "lse" else torch.empty_like(k)
                for o in names]
        code = fn(*(t.data_ptr() for t in (q, k, v, *(given[i] for i in ins),
                                          *outs)),
                  *(t.data_ptr() for t in extra[:n_extra]),
                  *q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                  q.shape[3], scale, int(causal),
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            fail(f"{tree} {name}{mode}: launch failed ({code})")
        return outs

    def compare(label, mode, args):
        same = {}
        for name in AGAINST_SOURCES:
            pairs = list(zip(run("other", name, mode, *args),
                             run("this", name, mode, *args)))
            same[name + mode] = {
                "equal": all(torch.equal(a, b) for a, b in pairs),
                "ulps": max(ulps(a, b) for a, b in pairs)}
        report["outputs"][label] = same
        log(f"  outputs, {label}: " + ", ".join(
            f"{name} {'bit for bit' if r['equal'] else 'DIFFER'}"
            + ("" if r["equal"] else f" (at most {r['ulps']} ulps)")
            for name, r in same.items()))
        if not variant and not all(r["equal"] for r in same.values()):
            fail(f"a {mode or 'unprefixed'} kernel differs from the other "
                 f"tree's on {label}: {same}")

    def in_turns(label, name, mode, args):
        samples = {t: {"ms": [], "device_ms": []} for t in trees}
        for tree in ("other", "this", "this", "other"):
            for key, spin in (("ms", False), ("device_ms", True)):
                samples[tree][key] += time_samples(
                    lambda: run(tree, name, mode, *args), spin=spin)
        got = report["times_ms"].setdefault(label, {})[name + mode] = {
            t: {key: statistics.median(xs) for key, xs in d.items()}
            for t, d in samples.items()}
        log(f"  {name}{mode}, {label} (medians of 20 samples in turns): "
            + "; ".join(f"{t} {m['ms']:.3f} ms, device alone "
                        f"{m['device_ms']:.3f}" for t, m in got.items()))

    report["outputs"], report["times_ms"] = {}, {}
    for n, (label, row_q, row_k, causal) in enumerate(segment_layouts()):
        q, k, v, do = attention_inputs(1, 32, 8, len(row_q), 128,
                                       torch.bfloat16, 50 + n)
        scale = 128 ** -0.5
        seg_q, seg_k = (torch.as_tensor(r[None].astype(np.int32),
                                        device="cuda")
                        for r in (row_q, row_k))
        out, lse = fa.flash_fwd(q, k, v, causal, scale, seg_q=seg_q,
                                seg_k=seg_k)
        delta = (do.float() * out.float()).sum(-1).contiguous()
        args = (q, k, v, do, lse, delta,
                (seg_q, seg_k, fa.segment_tiles(seg_q, seg_k)), causal,
                scale)
        compare(label, "_seg", args)
        if n in (0, 2):  # the packed row, documents of 700
            for name in AGAINST_SOURCES:
                in_turns(label, name, "_seg", args)

    prompts = synth_instruction_batch(glm.glm_10b().vocab_size, GLM_BATCH,
                                      GLM_SEQ, 0)["prefix_len"].tolist()
    for n, (label, b, h, hkv, s, d, p, causal) in enumerate(
            against_cases(prompts)):
        q, k, v, do = attention_inputs(b, h, hkv, s, d, torch.bfloat16,
                                       60 + n)
        scale = d ** -0.5
        mode = "" if p is None else "_pfx"
        extra = () if p is None else (
            torch.tensor(p, dtype=torch.int32, device="cuda"),)
        out, lse = fa.flash_fwd(q, k, v, causal, scale,
                                **({} if p is None else {"prefix_len":
                                                         extra[0]}))
        delta = (do.float() * out.float()).sum(-1).contiguous()
        args = (q, k, v, do, lse, delta, extra, causal, scale)
        compare(label, mode, args)
        timed_here = (AGAINST_SOURCES if n == 0 else  # phase 14's prompts
                      AGAINST_TIMED_LAYOUTS.get(label, ()))
        for name, timed in AGAINST_TIMED:
            if timed == mode and name in timed_here:
                in_turns(label, name, mode, args)
        del q, k, v, do, out, lse, delta, args
        torch.cuda.empty_cache()
    report["grouped"] = against_grouped(trees, work, variant, stress)
    shutil.rmtree(work, ignore_errors=True)
    return report


def against_grouped(trees, work, variant, stress=0):
    """``--against``'s grouped part: B4's f32 entry point (its four
    forms), B5's (dw at the up and the down projection) and B6's of both
    trees on rank 0's expert-parallel layout (phase 10's): outputs
    against each other (this tree without ``live_rows`` and with it, rows
    past it zero in both; B5's inputs zero past it, as the layout leaves
    them) and against the f64 product, this tree's norm ratio no more than
    twice the other's and its bias no more than twice the other's in
    magnitude; then both timed in turns (other, this, this, other; both
    clocks), this tree with the layout's ``live_rows`` (as the main path
    calls it) and without. B5's outputs also on phase 10's skewed and
    ragged layouts. A tree's entry point takes ``live_rows`` when its
    source declares one more pointer."""
    import ctypes

    import torch

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import moe, quantize

    cfg = llama.llama2_7b()
    d, f = cfg.hidden_size, cfg.intermediate_size
    v, s, w_up, rl, real = ep_received_rows(moe, quantize, d, f, 0)
    te, live = rl.tile_expert, rl.live_rows
    rows, el, n_live = v.shape[0], w_up.shape[0], live.item()
    log(f"grouped f32 kernels on rank 0's layout: {rows} rows "
        f"({sum(real)} real, live_rows {n_live}), D={d}, F={f}, {el} local "
        f"experts:")
    fns = {}
    for tree, csrc in trees.items():
        for name, entry, base in (
                ("grouped_matmul_fwd", "dlr_grouped_matmul_fwd_f32", 5),
                ("grouped_matmul_fwd_quant",
                 "dlr_grouped_matmul_fwd_quant_f32", 6),
                ("grouped_matmul_dw", "dlr_grouped_matmul_dw_f32", 5)):
            with open(os.path.join(csrc, f"{name}.cu")) as src:
                argtypes = _parse_entry(src.read(), entry)
            fn = getattr(ctypes.CDLL(str(work / f"{tree}_{name}.so")), entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            takes_live = sum(t == ctypes.c_void_p for t in argtypes) > base
            fns[(tree, name)] = (fn, takes_live)

    def call(tree, name, pointers, ints, out, with_live, live_rows=None):
        fn, takes_live = fns[(tree, name)]
        live_rows = live if live_rows is None else live_rows
        lr = [live_rows.data_ptr() if with_live else 0] if takes_live else []
        code = fn(*(t.data_ptr() for t in pointers), *lr, out.data_ptr(),
                  *ints, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            fail(f"{tree} {name}: launch failed ({code})")
        return out

    gen = torch.Generator(device="cuda").manual_seed(20)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def dead_zero(t):
        t[n_live:] = 0.0
        return t

    w_down = rnd(el, f, d, scale=f ** -0.5).to(torch.bfloat16).float()
    xd = quantize.dequantize_block_scaled(v, s)
    cases = {  # label: (a, w, transpose_w), B4's f32 forms
        "y up": (xd, w_up, 0),
        "y down": (dead_zero(rnd(rows, f)), w_down, 0),
        "dx through w_down^T": (dead_zero(rnd(rows, d)), w_down, 1),
        "dx through w_up^T": (dead_zero(rnd(rows, f)), w_up, 1)}
    dw_cases = {  # label: (x, dy), B5's f32 forms
        "dw up": (xd, dead_zero(rnd(rows, f))),
        "dw down": (dead_zero(rnd(rows, f)), dead_zero(rnd(rows, d)))}
    ends = expert_ends(te)
    report = {"outputs": {}, "times_ms": {}}

    def dw_run(x, dy, te_, lr=None):
        def run(tree, with_live):
            out = torch.empty((el, x.shape[1], dy.shape[1]), device="cuda")
            return call(tree, "grouped_matmul_dw", (x, dy, te_),
                        (x.shape[0], x.shape[1], dy.shape[1], el,
                         te_.shape[0], BLOCK_T), out, with_live, lr)
        return run

    def runner(label):
        if label in dw_cases:
            return dw_run(*dw_cases[label], te), None, None, None
        if label == "B6":
            def run(tree, with_live):
                y = torch.empty((rows, f), device="cuda")
                return call(tree, "grouped_matmul_fwd_quant",
                            (v, s, w_up, te), (rows, d, f, el, s.shape[1],
                                               BLOCK_T), y, with_live)
            return run, xd, w_up, 0
        a, w, tw = cases[label]
        n = w.shape[1] if tw else w.shape[2]

        def run(tree, with_live):
            y = torch.empty((rows, n), device="cuda")
            return call(tree, "grouped_matmul_fwd", (a, w, te),
                        (rows, w.shape[1], w.shape[2], el, BLOCK_T, tw), y,
                        with_live)
        return run, a, w, tw

    for label in (*cases, "B6", *dw_cases):
        run, a, w, tw = runner(label)
        if label in dw_cases:
            x, dy = dw_cases[label]
            ref64 = torch.stack([x[ends[i]:ends[i + 1]].double().t()
                                 @ dy[ends[i]:ends[i + 1]].double()
                                 for i in range(el)])
        else:
            ref64 = torch.cat([a[ends[i]:ends[i + 1]].double() @ (
                w[i].double().t() if tw else w[i].double())
                for i in range(el)])
        outs = {"other": run("other", False), "this": run("this", False),
                "this, live_rows": run("this", True)}
        torch.cuda.synchronize()
        errs = {t: f64_errors(o, ref64) for t, o in outs.items()}
        same = torch.equal(outs["this"], outs["other"])
        # dw has no rows past live_rows: its sums end there
        cut = None if label in dw_cases else n_live
        dead = (0 if cut is None else
                torch.count_nonzero(outs["this, live_rows"][cut:]).item())
        same_live = torch.equal(outs["this, live_rows"][:cut],
                                outs["other"][:cut])
        mine, theirs = errs["this, live_rows"], errs["other"]
        within = (mine["norm_ratio"] <= 2 * theirs["norm_ratio"]
                  and abs(mine["bias"]) <= 2 * abs(theirs["bias"]))
        report["outputs"][label] = {
            "bit_for_bit": same, "ulps": ulps(outs["this"], outs["other"]),
            "live_rows_bit_for_bit": same_live, "dead_nonzero": dead,
            "f64": errs, "precision_within_2x": within}
        log(f"  {label}: this tree {'bit for bit' if same else 'DIFFERS'} "
            f"the other's"
            + ("" if same else f" (at most {ulps(outs['this'], outs['other'])}"
               " ulps)")
            + f"; with live_rows the live rows "
            f"{'bit for bit' if same_live else 'DIFFER'}, {dead} nonzero "
            f"past it; f64 norm ratio / bias: other "
            f"{theirs['norm_ratio']:.3e} / {theirs['bias']:.3e}, this "
            f"{mine['norm_ratio']:.3e} / {mine['bias']:.3e} "
            f"({'within' if within else 'NOT within'} twice the other's)")
        if not variant and (dead or not within or not (same and same_live)):
            fail(f"{label}: outputs, live_rows or the precision against the "
                 f"other tree")
        del outs, ref64
        samples = {t: {"ms": [], "device_ms": []}
                   for t in ("other", "this", "this, all rows")}
        for tree in ("other", "this", "this", "other"):
            for key, spin in (("ms", False), ("device_ms", True)):
                samples[tree][key] += time_samples(
                    lambda: run(tree, True), spin=spin)
                if tree == "this":
                    samples["this, all rows"][key] += time_samples(
                        lambda: run(tree, False), spin=spin)
        got = report["times_ms"][label] = {
            t: {key: statistics.median(xs) for key, xs in dd.items()}
            for t, dd in samples.items()}
        log(f"  {label} (medians of 20 samples in turns): " + "; ".join(
            f"{t} {m['ms']:.3f} ms, device alone {m['device_ms']:.3f}"
            for t, m in got.items()))
        torch.cuda.empty_cache()
    del cases, dw_cases
    for label, (lv, ls, _, lrl) in (
            ("skewed", ep_received_rows(
                moe, quantize, d, f, 1,
                bias=[-30.0, 3.0] + [0.0] * (MOE_EXPERTS - 2))[:4]),
            ("ragged", ep_received_rows(moe, quantize, 200, 96, 2,
                                        tokens=75)[:4])):
        n = lrl.live_rows.item()
        x_up = quantize.dequantize_block_scaled(lv, ls)
        width = 96 if label == "ragged" else f
        for form, (x, dy) in (("up", (x_up, rnd(x_up.shape[0], width))),
                              ("down", (rnd(x_up.shape[0], width), x_up))):
            x, dy = x.clone(), dy.clone()
            x[n:], dy[n:] = 0.0, 0.0
            run = dw_run(x, dy, lrl.tile_expert, lrl.live_rows)
            other = run("other", False)
            same = {"all rows": torch.equal(run("this", False), other),
                    "live_rows": torch.equal(run("this", True), other)}
            report["outputs"][f"dw {form}, {label}"] = same
            log(f"  dw {form} on the {label} layout ({x.shape[0]} rows, "
                f"live_rows {n}): this tree without and with live_rows "
                + ", ".join("bit for bit" if ok else "DIFFERS"
                            for ok in same.values()) + " the other's")
            if not variant and not all(same.values()):
                fail(f"dw {form} on the {label} layout differs from the other "
                     f"tree's")
        torch.cuda.empty_cache()
    if stress:
        report["stress"] = against_stress(call, v, s, w_up, rl, stress,
                                          variant)
    return report


def against_stress(call, v, s, w, rl, calls, variant):
    """``--stress N``: ``stress_layout`` over phase 10's three layouts
    (rank 0's, the skewed one and the ragged one, whose layout ``v``,
    ``s``, ``w``, ``rl`` is the first) with both trees' B6 and B4-f32
    entry points, N calls of each on each layout; with ``--variant`` a
    wrong output is reported, not failed."""
    import torch

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import moe, quantize

    cfg = llama.llama2_7b()
    d, f = cfg.hidden_size, cfg.intermediate_size
    layouts = (("main", lambda: (v, s, w, rl)),
               ("skewed", lambda: ep_received_rows(
                   moe, quantize, d, f, 1,
                   bias=[-30.0, 3.0] + [0.0] * (MOE_EXPERTS - 2))[:4]),
               ("ragged", lambda: ep_received_rows(
                   moe, quantize, 200, 96, 2, tokens=75)[:4]))
    counts = {}
    for label, make in layouts:
        lv, ls, lw, lrl = make()
        rows, dd, ff, el = lv.shape[0], lv.shape[1], lw.shape[2], lw.shape[0]

        def b6(tree):
            return lambda v_, s_, xd, w_, te, lr: call(
                tree, "grouped_matmul_fwd_quant", (v_, s_, w_, te),
                (rows, dd, ff, el, s_.shape[1], BLOCK_T),
                torch.empty((rows, ff), device="cuda"), True, lr)

        def b4(tree):
            return lambda v_, s_, xd, w_, te, lr: call(
                tree, "grouped_matmul_fwd", (xd, w_, te),
                (rows, dd, ff, el, BLOCK_T, 0),
                torch.empty((rows, ff), device="cuda"), True, lr)

        runs = {f"{k} ({tree})": fn(tree) for tree in ("other", "this")
                for k, fn in (("B6", b6), ("B4 f32", b4))}
        counts[label] = stress_layout(runs, label, lv, ls, lw, lrl, calls,
                                      report_only=variant)
        del lv, ls, lw, lrl
        torch.cuda.empty_cache()
    return counts


# -- phase 17: attribution ---------------------------------------------------

ATTR_STEPS = 30  # phase 17's measured run (steps 4 to 30 - window read)
PAIR_STEPS = 8  # each of the paired runs with attribution on and off
MFU_AGREEMENT = 0.01  # the live gauge against the events' MFU


def attribution_phase(llama, fa, remat, config, card):
    """Phase 17: the attribution plane (``telemetry.attribution``,
    ``utils.prof``) on the dense cell through TrainExecutor's window, as
    phase 5: the record counted on the meta device beside
    ``llama.flops_per_token``, B1-B3's reported FLOPs against the Bound
    column's (``kernel_times``' formula), a capture leaving the state
    bit for bit, the live MFU gauge within MFU_AGREEMENT of
    ``derived_mfu`` over the CUDA events' step time, the peak and
    headroom gauges, a profile through the package's trace parser, and
    the executor's per-step cost of the gauges (paired runs, on and
    off)."""
    import torch

    from dlrover_tpu_torch.common.config import get_context
    from dlrover_tpu_torch.examples.train_llama import synthetic_batches
    from dlrover_tpu_torch.telemetry import attribution, names as tm
    from dlrover_tpu_torch.telemetry.metrics import process_registry
    from dlrover_tpu_torch.trainer.conf import build_configuration
    from dlrover_tpu_torch.trainer.executor import TrainExecutor
    from dlrover_tpu_torch.utils.prof import derived_mfu

    reg = process_registry()
    batches = synthetic_batches(config.vocab_size, 1, SEQ, seed=17)
    host = next(batches())
    trainer = main_trainer(llama, config, "llama", host)
    observe_s, sampled = [], []
    observe = TrainExecutor._observe_attribution

    def timed(self, per_step):
        t0 = time.perf_counter()
        observe(self, per_step)
        observe_s.append(time.perf_counter() - t0)
        sampled.append(per_step)

    def run(steps, state=None, hooks=()):
        executor = TrainExecutor(
            trainer, train_iter_fn=batches, hooks=list(hooks),
            conf=build_configuration({
                "train_steps": steps + (state.step if state else 0),
                "log_every_steps": 0}))
        executor.state = state
        executor.train_and_evaluate()
        return executor

    recompute = 1 if remat.remat_enabled(config.remat_policy) else 0
    expected = {"flash_fwd": ATTR_STEPS * LAYERS * (1 + recompute),
                "flash_bwd_dkv": ATTR_STEPS * LAYERS,
                "flash_bwd_dq": ATTR_STEPS * LAYERS, **NO_SEG, **NO_PFX}
    record = step_record()
    reg.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    TrainExecutor._observe_attribution = timed
    try:
        executor = run(ATTR_STEPS, hooks=[record])
    finally:
        TrainExecutor._observe_attribution = observe
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  {ATTR_STEPS} steps, launches {counts} (expected {expected})")
    if counts != expected:
        fail(f"kernel launches {counts} in phase 17, expected {expected}")
    rec = trainer.attribution()
    if rec is None or rec.peak_flops_per_s != PEAK_BF16_FLOPS:
        fail(f"the trainer's attribution record {rec} is missing or not "
             f"priced at the card's {PEAK_BF16_FLOPS:.4g} FLOP/s")
    tokens = SEQ
    formula = llama.flops_per_token(config) * tokens
    report = attribution_report(trainer.accelerated, host, "dense", formula,
                                card)
    if report["record"]["flops_per_step"] != rec.flops_per_step:
        fail("a fresh count differs from the trainer's record")
    # B1-B3 against the Bound column's operations (kernel_times' formula)
    b, h, d = 1, config.num_heads, config.head_dim
    pairs = SEQ * (SEQ + 1) // 2
    bound = {"flash_fwd": 4 * b * h * d * pairs,
             "flash_bwd_dkv": 8 * b * h * d * pairs,
             "flash_bwd_dq": 6 * b * h * d * pairs}
    per_step = {"flash_fwd": LAYERS * (1 + recompute),
                "flash_bwd_dkv": LAYERS, "flash_bwd_dq": LAYERS}
    for name, ops in bound.items():
        got = report["kernels"][name]
        per_call = got["flops"] / got["calls"]
        log(f"  {FLASH_KERNELS[name]} ({name}): {got['calls']:g} calls a "
            f"step, {per_call / 1e9:.4f} GFLOP a call reported; the Bound "
            f"column's {ops / 1e9:.4f}")
        if per_call != ops or got["calls"] != per_step[name]:
            fail(f"{name} reports {per_call} FLOPs over {got['calls']} "
                 f"calls, the bound's {ops} over {per_step[name]}")
    # a capture leaves the live state and the rng stream bit for bit
    before = state_digest(executor.state)
    rng = trainer._rng.get_state().clone()
    t0 = time.monotonic()
    again = attribution.capture_attribution(trainer.accelerated, 1, host,
                                            emit=False)
    capture_s = time.monotonic() - t0
    same = (state_digest(executor.state) == before
            and torch.equal(rng, trainer._rng.get_state()))
    log(f"  a capture ({capture_s:.3f} s) leaves the state bit for bit: "
        f"{same} ({len(before)} digest values)")
    if not same or again.flops_per_step != rec.flops_per_step:
        fail("a capture changed the state or counted differently")
    # the live gauge against the device's clock. The executor
    # materializes step s right after it dispatched step s + window, and
    # that dispatch returns only when the device's launch queue has room
    # (the host runs ahead of the device), so the gauge's sample of step
    # s is the device's time for step s + window. Its samples of steps
    # 4..last (the last `window` steps are materialized in the final
    # drain, where the interval is the host's) are held against the
    # events of steps 4 + window..ATTR_STEPS; the events of steps
    # 4..last are printed beside them
    window = get_context().train_window
    last = ATTR_STEPS - window
    step_ms = [a.elapsed_time(z) for a, z in zip(record.events,
                                                 record.events[1:])]
    timed_ms = step_ms[3 + window:last + window]
    steady_s = statistics.mean(timed_ms) / 1e3
    same_s = statistics.mean(step_ms[3:last]) / 1e3
    events_mfu = derived_mfu(rec.flops_per_step, steady_s, PEAK_BF16_FLOPS)
    same_mfu = derived_mfu(rec.flops_per_step, same_s, PEAK_BF16_FLOPS)
    live = gauge_mfu(record, 4, last)
    agreement = (live / events_mfu - 1) if live else float("inf")
    per_step_rows = [
        (s, round(sampled[s - 1] * 1e3, 3), round(step_ms[s - 1], 3),
         round((record.materialized[s] - record.dispatched[s]) * 1e3, 3))
        for s in range(1, ATTR_STEPS + 1)]
    log(f"  per step (step, the gauge's sample ms, the CUDA events' ms, "
        f"host ms from dispatch to materialization; window {window}): "
        f"{per_step_rows}")
    log(f"  the gauge's samples of steps 4..{last} sum to "
        f"{sum(sampled[3:last]) * 1e3:.3f} ms (the host clock between the "
        f"materializations of steps 3 and {last}: "
        f"{(record.materialized[last] - record.materialized[3]) * 1e3:.3f}"
        f" ms); the events of steps {4 + window}..{last + window} to "
        f"{sum(timed_ms):.3f} ms, of steps 4..{last} to "
        f"{sum(step_ms[3:last]):.3f} ms; {card}")
    log(f"  live MFU gauge over steps 4..{last}: {live or 0.0:.5f} "
        f"(peak {rec.peak_flops_per_s:.4g} FLOP/s); derived_mfu over the "
        f"CUDA events' mean step of steps {4 + window}..{last + window} "
        f"{steady_s * 1e3:.2f} ms: {events_mfu:.5f} ({agreement:+.5f}; "
        f"limit {MFU_AGREEMENT}); over steps 4..{last} {same_s * 1e3:.2f} "
        f"ms: {same_mfu:.5f} ({(live or 0.0) / same_mfu - 1:+.5f}, not "
        f"held); by llama.flops_per_token "
        f"{derived_mfu(formula, steady_s, PEAK_BF16_FLOPS):.5f}; {card}")
    if abs(agreement) > MFU_AGREEMENT:
        fail(f"the live MFU gauge {live} is not within {MFU_AGREEMENT} of "
             f"the events' {events_mfu}")
    gauges = {name: reg.get(name).value if reg.get(name) else None
              for name in (tm.ATTR_MFU, tm.ATTR_EXPOSED_COMM_FRAC,
                           tm.ATTR_FLOPS_PER_STEP, tm.ATTR_ARITH_INTENSITY,
                           tm.ATTR_PEAK_HBM_MB, tm.ATTR_COMM_PREDICTED_S,
                           tm.ATTR_HBM_HEADROOM_MB)}
    if None in (gauges[tm.ATTR_PEAK_HBM_MB], gauges[tm.ATTR_HBM_HEADROOM_MB]):
        fail(f"a memory gauge is missing on the card: {gauges}")
    free, total = torch.cuda.mem_get_info()
    log(f"  gauges {gauges}; peak memory gauge "
        f"{gauges[tm.ATTR_PEAK_HBM_MB]:.1f} MB against "
        f"torch.cuda.max_memory_allocated {peak / 2**20:.1f} MB; headroom "
        f"gauge {gauges[tm.ATTR_HBM_HEADROOM_MB]:.1f} MB, mem_get_info now "
        f"{free / 2**20:.1f} of {total / 2**20:.1f} MB; {card}")
    profile = profile_steps(trainer, executor.state, host)
    # the gauges' own cost: paired runs with attribution on and off
    ctx = get_context()
    state = executor.state
    del executor
    pairs_ms = {True: [], False: []}
    try:
        for enabled in (True, False, False, True):
            ctx.attribution_enabled = enabled
            rec_pair = step_record()
            state = run(PAIR_STEPS, state, hooks=[rec_pair]).state
            ms = [a.elapsed_time(z) for a, z in zip(rec_pair.events,
                                                    rec_pair.events[1:])]
            pairs_ms[enabled].append(statistics.mean(ms[2:]))
    finally:
        ctx.attribution_enabled = True
    on, off = statistics.mean(pairs_ms[True]), statistics.mean(pairs_ms[False])
    log(f"  _observe_attribution: {statistics.mean(observe_s) * 1e6:.1f} us "
        f"a call over {len(observe_s)} calls (the slowest "
        f"{max(observe_s) * 1e3:.2f} ms); paired runs "
        f"(on, off, off, on; {PAIR_STEPS} steps each, steps 3.. read): on "
        f"{on:.2f} ms, off {off:.2f} ms a step, {on / off - 1:+.4f} "
        f"(the reference's gate is 0.05); {card}")
    del state, trainer
    return {"record": rec.to_dict(), "report": report,
            "capture_s": capture_s, "state_unchanged": same,
            "gauges": gauges, "peak_allocated_bytes": peak,
            "mem_free_bytes": free, "step_ms": step_ms,
            "live_mfu": live, "events_mfu": events_mfu,
            "mfu_agreement": agreement, "events_mfu_same_steps": same_mfu,
            "gauge_samples_ms": [x * 1e3 for x in sampled],
            "profile": profile,
            "observe_us": statistics.mean(observe_s) * 1e6,
            "paired_step_ms": pairs_ms, "overhead": on / off - 1,
            "launches": counts}



# -- phase 18: FSDP ----------------------------------------------------------

# one step a run (5 a mesh before phase 19 came, 3 before the fp8 legs,
# 2 before the prefetch leg): the exact wires at (1, 2), the layer
# prefetch at (1, 2), the exact wires at (2, 1), then each mesh under the
# fp8 FSDP and gradient wires, each run from the seeded init on the same
# batch. The exact (1, 2) run's blocks after the AdamW step are held
# against the prefetch run's bit for bit and against the matching
# slices of the (2, 1) run's parameters (FSDP_PARAM_ATOL), which holds
# the sharded update against data parallel: the script's time stays
# under 1,140 s of its 1,200
FSDP_LAYERS, FSDP_SEQ, FSDP_ROWS, FSDP_STEPS = 2, 2048, 2, 1
FSDP_MESHES = ((1, 2), (2, 1))  # (data, fsdp): the fsdp run, then data
# each run: (mesh, the FSDP and gradient wires' precision, the layer
# prefetch)
FSDP_RUNS = (
    (FSDP_MESHES[0], "bf16", False),
    (FSDP_MESHES[0], "bf16", True),
    (FSDP_MESHES[1], "bf16", False),
    # (data, fsdp, seq): each rank 1,024 of each row's 2,048 tokens, ring
    # attention over the two; held against the (2, 1) run's step
    ((1, 1, 2), "bf16", False),
    *((m, "fp8", False) for m in FSDP_MESHES))
# phase 18 (b)'s steps (3 before the ring leg of (a) needed the room)
FSDP_MOE_STEPS = 2
# the largest relative gap of a step's loss between the fsdp and the
# data-parallel run: on the CPU tests/test_torch_fsdp.py holds (1, 4) and
# (2, 2) against (4, 1) to 1e-6 (the sums group differently); over 2
# ranks a reduce-scatter sums what the all-reduce sums
FSDP_LOSS_RTOL = 1e-5
# the largest gap of a parameter after the AdamW step between the fsdp
# and the data-parallel run: 1 % of the step's lr (the first AdamW step
# moves each element by about the lr), so one element moved wrong shows;
# a rank's gradients are the same sums of two values at both meshes
FSDP_PARAM_ATOL = 3e-6
# the MoE cell at (2, 2) against (4, 1): tests/test_torch_ep.py's
# tolerance for the expert-parallel trajectory
FSDP_MOE_RTOL = 1e-4


# -- phase 18 (a)'s ring leg: long context (ROADMAP A13) ----------------------

# The ring body at seq = 2 on phase 18 (a)'s two ranks, before the train
# runs: (name, rows, heads, kv heads, global tokens, head dim, mode).
# Llama-3-8B's attention at 4096 tokens a rank (causal, and on phase
# 13's packed layout over 8192 tokens, whose document 5 spans the bound);
# GLM's [4, 64, 1024, 64] a rank on phase 14's training prompts (all in
# the first shard: rank 0 skips its future shard) and on two of them
# with a prompt straddling the bound (1500) and one on it (1024)
RING_CASES = (
    ("llama", 1, 32, 8, 8192, 128, "causal"),
    ("llama_packed", 1, 32, 8, 8192, 128, "packed"),
    ("glm", 4, 64, 64, 2048, 64, "prefix"),
    ("glm_bound", 4, 64, 64, 2048, 64, "prefix_bound"),
)
RING_SEED = 26
# query heads a chunk of the plain f32 reference (a multiple of the GQA
# group): its S x S scores, probabilities and their gradients stay a few
# GiB a rank
RING_REF_HEADS = 4
# the (1, 1, 2) train run: the same batch and global function as (2, 1)
FSDP_RING_MESH = (1, 1, 2)


def ring_prompts(vocab):
    """(phase 14's training prompts, two of them with 1500 and 1024)."""
    from dlrover_tpu_torch.examples.train_glm_prefix import (
        synth_instruction_batch,
    )

    p = [int(x) for x in synth_instruction_batch(
        vocab, GLM_BATCH, GLM_SEQ, 0)["prefix_len"]]
    return p, p[:2] + [1500, 1024]


def ring_reference(q, k, v, dout, scale, seg=None, prefix=None):
    """The plain attention over the whole sequence (causal, with the
    ids' or the prompt's mask) and its gradients given ``dout``: (out,
    dq, dk, dv) in q's dtype, by B1-B3's plain versions (f32 arithmetic,
    P and dS rounded to bf16 where the kernels round them, the rule's
    reference in every kernel check), RING_REF_HEADS query heads at a
    time with their KV heads."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    h, hkv = q.shape[1], k.shape[1]
    g = h // hkv
    step = max(g, RING_REF_HEADS)
    out, dq = torch.empty_like(q), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(k)
    for h0 in range(0, h, step):
        k0, k1 = h0 // g, (h0 + step) // g
        qs, do = q[:, h0:h0 + step], dout[:, h0:h0 + step]
        ks, vs = k[:, k0:k1], v[:, k0:k1]
        o, lse = fa.flash_fwd_plain(qs, ks, vs, True, scale, seg, seg,
                                    prefix)
        delta = (do.float() * o.float()).sum(dim=-1)
        args = (qs, ks, vs, do, lse, delta, True, scale, seg, seg, prefix)
        dk[:, k0:k1], dv[:, k0:k1] = fa.flash_bwd_dkv_plain(*args)
        dq[:, h0:h0 + step] = fa.flash_bwd_dq_plain(*args)
        out[:, h0:h0 + step] = o
        del o, lse, delta, args
    return out, dq, dk, dv


def ring_expected(mode, rank):
    """The launches of B1-B3 by mode that the ring's schedule gives seq
    rank ``rank`` of 2 in one forward and backward: the diagonal, and on
    rank 1 the past shard; rank 0's future shard only where a prompt
    reaches it (the column bound, through the pair-segmented kernels)."""
    counts = {f"{name}{m}": 0 for name in FLASH_KERNELS
              for m in ("", "_seg", "_pfx")}

    def add(suffix, n=1):
        for name in FLASH_KERNELS:
            counts[name + suffix] += n

    if mode == "causal":
        add("", 1 + rank)
    elif mode == "packed":
        add("_seg", 1 + rank)
    else:
        add("_pfx")
        if rank == 1:
            add("")
        elif mode == "prefix_bound":
            add("_seg")
    return counts


def ring_bytes(b, hkv, s_local, d, packed, n=2):
    """A rank's bytes in one forward and backward of the ring over n
    ranks (bf16 K/V): the forward's n - 1 K/V hops (with the int32 ids
    when packed), the backward's n - 1 again and its n hops of the f32
    dK/dV accumulators."""
    kv = 2 * b * hkv * s_local * d * 2 + (b * s_local * 4 if packed else 0)
    acc = 2 * b * hkv * s_local * d * 4
    return 2 * (n - 1) * kv + n * acc


def ring_body_leg(rank, ranks):
    """One rank of the ring leg (RING_CASES): the ring's forward and
    backward with host syncs forbidden, its out, dq, dk, dv against the
    matching slices of ``ring_reference`` by ``ops/flash_check.py``'s
    row and bias rules, B1-B3's launches by mode, the shifts' bytes and
    statistics; on the causal case the planted controls (a future shard
    attended, a past shard merged twice), which the row rule must
    reject on the rank they change."""
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.models import glm
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import flash_check as fc
    from dlrover_tpu_torch.ops import ring
    from dlrover_tpu_torch.ops import ring_attention as ra

    prompts = ring_prompts(glm.glm_10b().vocab_size)
    out = {}
    for name, b, h, hkv, s, d, mode in RING_CASES:
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(RING_SEED)

        def draw(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16)

        q, k, v, dout = (draw(b, h, s, d), draw(b, hkv, s, d),
                         draw(b, hkv, s, d), draw(b, h, s, d))
        scale = 1.0 / math.sqrt(d)
        seg = prefix = host = None
        if mode == "packed":
            row = next(packed_segment_rows(s, PACK_SEED))
            seg = torch.as_tensor(row, device="cuda")[None].to(torch.int32)
        elif mode.startswith("prefix"):
            host = prompts[mode == "prefix_bound"]
            prefix = torch.tensor(host, dtype=torch.int32, device="cuda")
        ref = ring_reference(q, k, v, dout, scale, seg, prefix)
        sl = s // ranks
        lo = rank * sl

        def local(t):
            return t[:, :, lo:lo + sl].contiguous()

        ql, kl, vl = (local(t).requires_grad_() for t in (q, k, v))
        seg_l = None if seg is None else seg[:, lo:lo + sl].contiguous()
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        ring.reset_stats()
        sync_error = ""
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            o = ra.ring_attention_local(
                ql, kl, vl, None, causal=True, impl="flash",
                segment_ids=seg_l, prefix_len=prefix, prefix_host=host)
            o.backward(local(dout))
        except RuntimeError as exc:
            sync_error = str(exc)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ring_s = time.perf_counter() - t1
        launches = fa.launch_counts()
        stats = ring.stats().get("ring_shift", {})
        rec = {"launches": launches, "expected": ring_expected(mode, rank),
               "stats": stats, "sync_error": sync_error,
               "bytes_want": ring_bytes(b, hkv, sl, d, seg is not None),
               "ring_s": ring_s, "checks": {}}
        if not sync_error:
            for key, got, want in (
                    ("out", o, local(ref[0])), ("dq", ql.grad,
                                                local(ref[1])),
                    ("dk", kl.grad, local(ref[2])),
                    ("dv", vl.grad, local(ref[3]))):
                rec["checks"][key] = {
                    **fc.row_errors(got, want), "bias": fc.bias(got, want),
                    "ok": fc.rows_close(got, want)
                    and fc.bias_close(got, want)}
        if mode == "causal":
            plan = ra.ring_plan(ql, None, True, scale)
            want = local(ref[0])
            qd, kd, vd = ql.detach(), kl.detach(), vl.detach()
            bad, _ = ra._ring_forward(qd, kd, vd, _future_attended(plan))
            merge = ra._merge_lse

            def twice(o_, l_, oi, li):
                o_, l_ = merge(o_, l_, oi, li)
                return merge(o_, l_, oi, li)

            ra._merge_lse = twice
            try:
                bad2, _ = ra._ring_forward(qd, kd, vd, plan)
            finally:
                ra._merge_lse = merge
            rec["controls"] = {
                "future_attended": {"changes": rank == 0,
                                    "rejected": not fc.rows_close(bad,
                                                                  want),
                                    **fc.row_errors(bad, want)},
                "past_twice": {"changes": rank == 1,
                               "rejected": not fc.rows_close(bad2, want),
                               **fc.row_errors(bad2, want)}}
            del bad, bad2
        rec["wall_s"] = time.perf_counter() - t0
        out[name] = rec
        del q, k, v, dout, ref, ql, kl, vl, o
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _future_attended(plan):
    """A planted control: ``plan`` (a ``RingPlan``) attending each
    future shard of the causal ring (no mask) instead of skipping it."""
    import dataclasses as dc

    from dlrover_tpu_torch.ops import ring_attention as ra

    class FutureAttended(ra.RingPlan):
        def step(self, owner, seg_k=None):
            if self.causal and owner > self.my:
                return ra.Step("full", False)
            return super().step(owner, seg_k)

    return FutureAttended(**{f.name: getattr(plan, f.name)
                             for f in dc.fields(plan)})


def ring_body_checks(ranks, card):
    """Phase 18 (a)'s ring leg on both ranks' records (``ring_body_leg``):
    logs each case and fails on a sync, a rule, a launch count, the
    bytes or a control the rule let through."""
    for r in ranks:
        for name, b, h, hkv, s, d, mode in RING_CASES:
            rec = r["ring"][name]
            checks = " ".join(
                f"{k} worst row {c['worst_row']:.3f} bias {c['bias']:.2e}"
                for k, c in rec["checks"].items())
            st = rec["stats"]
            log(f"    rank {r['rank']} ring {name} ([{b}, {h}/{hkv}, "
                f"{s // 2} of {s}, {d}], {mode}): {checks}; launches "
                f"{ {k: v for k, v in rec['launches'].items() if v} }; "
                f"shifts {st.get('calls', 0)} calls {st.get('bytes', 0)} B "
                f"(formula {rec['bytes_want']}), exposed wait "
                f"{st.get('wait_seconds', 0.0):.3f} s; forward and "
                f"backward {rec['ring_s']:.3f} s host, the case "
                f"{rec['wall_s']:.1f} s with its reference; {card}")
            if rec["sync_error"]:
                fail(f"ring {name} waits for the device: "
                     f"{rec['sync_error']}")
            bad = [k for k, c in rec["checks"].items() if not c["ok"]]
            if bad or len(rec["checks"]) != 4:
                fail(f"rank {r['rank']} ring {name}: {bad} outside the row "
                     f"or bias rule: {rec['checks']}")
            if rec["launches"] != rec["expected"]:
                fail(f"rank {r['rank']} ring {name}: launches "
                     f"{rec['launches']}, the schedule gives "
                     f"{rec['expected']}")
            if st.get("bytes") != rec["bytes_want"]:
                fail(f"rank {r['rank']} ring {name}: shift bytes "
                     f"{st.get('bytes')}, formula {rec['bytes_want']}")
            for control, c in rec.get("controls", {}).items():
                log(f"      control {control}: worst row "
                    f"{c['worst_row']:.3f}, rejected {c['rejected']}")
                if c["changes"] and not c["rejected"]:
                    fail(f"rank {r['rank']}: the planted control {control} "
                         f"passed the row rule")


def _leaf_bytes(state):
    """This rank's bytes of each parameter and of its optimizer moments,
    by path."""
    from dlrover_tpu_torch.parallel.accelerate import _named_leaves

    out = {}
    for path, p in _named_leaves(state.params):
        moments = sum(v.numel() * v.element_size() for key, v in
                      state.opt_state.state.get(p, {}).items()
                      if key != "step")
        out[path] = (p.numel() * p.element_size(), moments)
    return out


def _split_bytes(leaf_bytes, sharded):
    """{"params"|"moments": {"sharded"|"replicated": bytes}} over the
    paths in ``sharded`` and the rest."""
    out = {k: {"sharded": 0, "replicated": 0} for k in ("params",
                                                        "moments")}
    for path, (p, m) in leaf_bytes.items():
        kind = "sharded" if path in sharded else "replicated"
        out["params"][kind] += p
        out["moments"][kind] += m
    return out


def fsdp_run_key(data, fsdp, precision, prefetch, seq=1):
    """A phase 18 (a) run's key: (data, fsdp, precision), the prefetch
    leg's precision named "prefetch", the ring leg's "seq2"."""
    label = "prefetch" if prefetch else precision
    return (data, fsdp, f"seq{seq}" if seq > 1 else label)


def fsdp_dense_rank(layers, seq, rows, steps):
    """One rank of phase 18 (a): llama3_8b at its published widths,
    ``layers`` layers, through ElasticTrainer (rule set "llama", the
    example's AdamW) on 2 ranks sharing the card over gloo, on the same
    batches (the example's token stream, ``rows`` x ``seq`` global): the
    runs of FSDP_RUNS, each from the seeded init. After the exact (1, 2)
    run's step its blocks are copied to the host; after the prefetch
    leg's step (the same state, the same batch) every block is held
    against them bit for bit, and after the (2, 1) run's step its
    parameters' matching slices (``after_update``). Launch counters,
    exchange and held-layer statistics and the peak are reset just
    before each run's first step and read after its last."""
    import functools
    import gc

    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.examples.train_llama import (
        adamw,
        synthetic_batches,
    )
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import ring
    from dlrover_tpu_torch.parallel import layer_prefetch
    from dlrover_tpu_torch.parallel.accelerate import _named_leaves
    from dlrover_tpu_torch.parallel.mesh import MeshPlan
    from dlrover_tpu_torch.parallel.strategy import Strategy
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

    rank, ranks = _ep_join()
    config = llama.llama3_8b(num_layers=layers, max_seq_len=seq)
    gen = synthetic_batches(config.vocab_size, rows, seq)()
    batches = [next(gen) for _ in range(steps)]
    out = {"rank": rank, "runs": {}}
    # the ring leg's body first, on a card that holds no model yet
    out["ring"] = ring_body_leg(rank, ranks)
    # the exact (1, 2) step's blocks on the host, and where each lies in
    # its leaf: {path: (dim, index)} of the sharded ones; the (2, 1)
    # step's leaves, for the ring run
    exact, cuts, data_parallel = {}, {}, {}
    for mesh, precision, prefetch in FSDP_RUNS:
        data, fsdp, ring_n = (*mesh, 1)[:3]
        # the fp8 legs step SGD: their checks read the first loss, the
        # gathers and the residual, none of which the optimizer moves,
        # and AdamW's moments beside the residual do not fit two ranks
        # at (2, 1) on one card
        run_t0 = time.perf_counter()
        optimizer = (adamw() if precision == "bf16" else
                     functools.partial(torch.optim.SGD, lr=3e-4))
        trainer = ElasticTrainer(
            llama.make_init_fn(config), llama.make_loss_fn(
                dataclasses.replace(config, fsdp_prefetch=prefetch,
                                    seq_axis="seq" if ring_n > 1 else None)),
            optimizer, batches[0],
            strategy=Strategy(mesh=MeshPlan(data=data, fsdp=fsdp,
                                            seq=ring_n),
                              rule_set="llama"),
            device="cuda:0", fsdp_precision=precision,
            grad_precision=precision)
        state = trainer.prepare()
        result = trainer.accelerated
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        ring.reset_stats()
        layer_prefetch.reset_stats()
        losses, host_s = [], []
        for batch in batches:
            t = time.perf_counter()
            state, metrics = trainer.step(state, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            host_s.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        # the steps' own peak, before the checks below copy blocks out
        peak = torch.cuda.max_memory_allocated()
        layout = result.layout
        # the leaves the FSDP wire quantizes: the gathered rank-3 layer
        # stacks, never split along their last dim
        wired = sorted(p for p in layout.leaves
                       if precision == "fp8" and p.startswith("layers/")
                       and len(layout.shapes[p]) == 3)
        gathered = {p: 4 * math.prod(layout.shapes[p])
                    for p in layout.leaves}
        residual = None
        if state.wire_residual is not None:
            blocks = dict(_named_leaves(state.params))
            residual = {
                "layout_matches": all(
                    tuple(r.shape) == tuple(blocks[p].shape)
                    and r.dtype == blocks[p].dtype
                    for p, r in _named_leaves(state.wire_residual))
                and len(_named_leaves(state.wire_residual)) == len(blocks),
                "abs_sum": sum(float(r.abs().sum()) for _, r in
                               _named_leaves(state.wire_residual)),
                "bytes": sum(r.numel() * r.element_size() for _, r in
                             _named_leaves(state.wire_residual))}
        blocks_differ = after_update = None
        named = _named_leaves(state.params)
        if precision == "bf16" and (data, fsdp) == FSDP_MESHES[0]:
            if not prefetch:
                exact = {p: t.detach().cpu() for p, t in named}
                cuts = {p: (s.dim, dist.get_rank(result.mesh.group(s.axes)))
                        for p, s in layout.leaves.items()}
            else:  # no reference to a block outlives the check
                blocks_differ = sorted(
                    {p for p, t in named if p not in exact or not
                     torch.equal(exact[p], t.detach().cpu())}
                    | (set(exact) - {p for p, _ in named}))
        elif precision == "bf16" and ring_n == 1:
            # (2, 1): each leaf whole on every rank
            after_update = _after_update(exact, cuts, named)
            exact = {}
            data_parallel = {p: t.grad.cpu() for p, t in named}
        elif precision == "bf16":  # the ring's gradients against (2, 1)'s
            after_update = {
                "grads": _grad_gap(data_parallel, named),
                "missing": sorted(set(data_parallel)
                                  ^ {p for p, _ in named})}
            data_parallel = {}
        del named
        out["runs"][fsdp_run_key(data, fsdp, precision, prefetch,
                                 ring_n)] = {
            "losses": losses, "host_step_s": host_s,
            "launches": fa.launch_counts(), "exchange": ring.stats(),
            "held": layer_prefetch.stats(), "blocks_differ": blocks_differ,
            "after_update": after_update, "peak_bytes": peak,
            "leaf_bytes": _leaf_bytes(state),
            "gathered_leaf_bytes": gathered,
            "wired_elements": {p: math.prod(layout.shapes[p])
                               for p in wired},
            "split_dims": {p: layout.leaves[p].dim for p in wired},
            "effective": (trainer.fsdp_precision, trainer.grad_precision),
            "residual": residual, "steps": len(batches),
            "sharded": sorted(layout.leaves),
            "specs": {p: result.specs[p] for p in sorted(result.specs)}}
        del state, trainer, result
        gc.collect()
        torch.cuda.empty_cache()
        # the run's seconds: build, step, checks and release
        out["runs"][fsdp_run_key(data, fsdp, precision, prefetch,
                                 ring_n)]["wall_s"] = (time.perf_counter()
                                                       - run_t0)
    dist.destroy_process_group()
    return out


def _after_update(exact, cuts, named):
    """The exact (1, 2) run's blocks after its step (``exact``, on the
    host; ``cuts``: {path: (dim, index)} of the sharded ones) against the
    matching slices of a data-parallel run's whole leaves after its step
    (``named``): the largest absolute gap, the elements that differ at
    all, and the paths either side lacks."""
    gap, differ = 0.0, 0
    for path, t in named:
        if path not in exact:
            continue
        want = exact[path]
        if path in cuts:
            dim, index = cuts[path]
            n = want.shape[dim]
            t = t.detach().narrow(dim, index * n, n)
        got = t.detach().cpu()
        if got.shape != want.shape:
            return {"max_abs": math.inf, "differ": -1,
                    "missing": [path]}
        d = (got - want).abs()
        gap = max(gap, float(d.max()))
        differ += int((d > 0).sum())
    return {"max_abs": gap, "differ": differ,
            "missing": sorted(set(exact) ^ {p for p, _ in named})}


def _grad_gap(want, named, chunk=1 << 25):
    """Each leaf's gradient after a step (``named``, on the card) against
    another run's (``want``, on the host) as phase 6's cross-check holds
    a model's gradients: ||g - g_want|| / ||g_want|| over every leaf
    (``gap``) and per leaf (``leaf_gap``), accumulated in f64 about
    ``chunk`` elements at a time (a whole leaf's f64 copies do not fit
    beside two ranks' states)."""
    import torch

    diff2 = ref2 = 0.0
    leaf_gap = {}
    for path, t in named:
        if path not in want:
            continue
        got, ref = t.grad.reshape(-1), want[path].reshape(-1)
        d2 = r2 = 0.0
        for lo in range(0, got.numel(), chunk):
            g = got[lo:lo + chunk].double()
            r = ref[lo:lo + chunk].to(got.device).double()
            d2 += float(torch.sum((g - r) ** 2))
            r2 += float(torch.sum(r * r))
            del g, r
        leaf_gap[path] = math.sqrt(d2 / r2) if r2 else math.sqrt(d2)
        diff2, ref2 = diff2 + d2, ref2 + r2
    return {"gap": math.sqrt(diff2 / ref2), "leaf_gap": leaf_gap}


def fsdp_moe_rank(argv, steps):
    """One rank of phase 18 (b): phase 12's configuration (the example's
    flags ``argv``, its init, loss, AdamW and token stream) through
    ElasticTrainer at (data=4, fsdp=1), ``steps`` steps."""
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.examples import train_llama
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import grouped_matmul as gm
    from dlrover_tpu_torch.parallel.mesh import MeshPlan
    from dlrover_tpu_torch.parallel.strategy import Strategy
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

    rank, ranks = _ep_join()
    flags = dict(zip(argv[::2], argv[1::2]))
    config, _ = train_llama.preset_config(
        flags["--preset"], int(flags["--layers"]),
        int(flags["--moe_experts"]), moe_top_k=int(flags["--moe_top_k"]),
        moe_dispatch=flags["--moe_dispatch"])
    batches = train_llama.synthetic_batches(
        config.vocab_size, int(flags["--batch"]), int(flags["--seq"]))
    trainer = ElasticTrainer(
        llama.make_init_fn(config, (rank, ranks)),
        llama.make_loss_fn(config), train_llama.adamw(), next(batches()),
        strategy=Strategy(mesh=MeshPlan(data=ranks, fsdp=1),
                          rule_set="moe_ep", remat_policy=""),
        device="cuda:0", moe_precision=flags["--moe_precision"],
        dispatch_chunks=int(flags["--dispatch_chunks"]))
    state = trainer.prepare()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    gm.reset_launch_counts()
    losses, stream = [], batches()  # the example's first batches
    for _ in range(steps):
        state, metrics = trainer.step(state, next(stream))
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    out = {"rank": rank, "losses": losses,
           "launches": {**fa.launch_counts(), **gm.launch_counts()},
           "peak_bytes": torch.cuda.max_memory_allocated()}
    dist.destroy_process_group()
    return out


def fsdp_wire_checks(r, config, card):
    """Phase 18 (a)'s fp8 runs on one rank's record: the two meshes'
    losses within FSDP_LOSS_RTOL; at (1, 2) the all-gather bytes equal
    to the planner's formula (``fsdp_wire_bytes_per_elem`` a wired
    element, 4 bytes every other gathered element) and no wired leaf
    split along its last dim; the gradient wire's residual nonzero and
    in the parameters' layout at both meshes."""
    from dlrover_tpu_torch.parallel.planner import ModelSpec

    fs, dp = FSDP_MESHES
    qa, qb = r["runs"][fs + ("fp8",)], r["runs"][dp + ("fp8",)]
    ba = r["runs"][fs + ("bf16",)]
    gap = max(abs(x - y) / abs(y) for x, y in zip(qa["losses"],
                                                  qb["losses"]))
    per = ModelSpec(param_count=0, num_layers=config.num_layers,
                    hidden_size=config.hidden_size, param_bytes=4,
                    fsdp_precision="fp8").fsdp_wire_bytes_per_elem()
    wired = qa["wired_elements"]
    other = {p: n for p, n in qa["gathered_leaf_bytes"].items()
             if p not in wired}
    want = qa["steps"] * (sum(wired.values()) * per + sum(other.values()))
    calls = qa["steps"] * (2 * len(wired) + len(other))
    got = qa["exchange"].get("all_gather", {})
    full = ba["exchange"].get("all_gather", {})
    log(f"      fp8 wires (fsdp_precision and grad_precision): losses at "
        f"{fs} {qa['losses']}, at {dp} {qb['losses']}, relative gap "
        f"{gap:.3e} (limit {FSDP_LOSS_RTOL:.0e}); all-gather at {fs} "
        f"{got.get('calls', 0)} calls {got.get('bytes', 0)} B "
        f"{got.get('seconds', 0.0):.2f} s a step (formula: "
        f"{len(wired)} wired leaves x {per} B an element + the other "
        f"{len(other)} gathered leaves' {sum(other.values())} B = "
        f"{want:.0f} B in {calls} calls), against the bf16 run's "
        f"{full.get('bytes', 0) / ba['steps']:.0f} B "
        f"{full.get('seconds', 0.0) / ba['steps']:.2f} s a step; residual "
        f"{qa['residual']} at {fs}, {qb['residual']} at {dp}; host s "
        f"{qa['host_step_s']}, {qb['host_step_s']}; {card}")
    if gap > FSDP_LOSS_RTOL:
        fail(f"fp8 wires: losses {qa['losses']} at {fs} vs {qb['losses']} "
             f"at {dp}: gap {gap:.3e}")
    if not wired or any(d == 2 for d in qa["split_dims"].values()):
        fail(f"the wired leaves {qa['split_dims']} at {fs}")
    if got.get("bytes") != want or got.get("calls") != calls:
        fail(f"fp8 all-gather {got} against the formula's {want} B in "
             f"{calls} calls")
    for mesh, run in ((fs, qa), (dp, qb)):
        res = run["residual"]
        if not (res and res["layout_matches"] and res["abs_sum"] > 0):
            fail(f"the gradient wire's residual at {mesh}: {res}")
    return {"loss_gap": gap, "bytes_per_elem": per, "want_bytes": want,
            "want_calls": calls, "bf16_gather_bytes_a_step":
            full.get("bytes", 0) / ba["steps"]}


def fsdp_prefetch_checks(r, expected, card):
    """Phase 18 (a)'s prefetch leg on one rank's record, against the
    exact (1, 2) step from the same state on the same batch: the loss
    and every block after the optimizer step bit for bit; B1-B3's
    launches as that step's; at most two layers' gathered parameters
    held, each layer fetched twice (the forward, the recompute); the
    exchange bytes and calls by the formula (the sharded
    leaves outside the layers gathered once and the layer stacks twice,
    a layer at a time, by a broadcast from the rank holding the layer;
    every sharded leaf's gradient reduced once). Prints, with no gate,
    both legs' peak memory and host step and each exchange's exposed
    wait (the host seconds its ``wait()`` blocked)."""
    fs = FSDP_MESHES[0]
    off, on = r["runs"][fs + ("bf16",)], r["runs"][fs + ("prefetch",)]
    layers = {p: b for p, b in on["gathered_leaf_bytes"].items()
              if p.startswith("layers/")}
    other = {p: b for p, b in on["gathered_leaf_bytes"].items()
             if p not in layers}
    steps = on["steps"]
    want = {"gather": (steps * (sum(other.values())
                                + 2 * sum(layers.values())),
                       steps * (len(other) + 2 * FSDP_LAYERS * len(layers))),
            "reduce": (steps * (sum(other.values()) + sum(layers.values())),
                       steps * (len(other) + FSDP_LAYERS * len(layers)))}
    x = on["exchange"]

    def side(kinds):
        return (sum(x.get(k, {}).get("bytes", 0) for k in kinds),
                sum(x.get(k, {}).get("calls", 0) for k in kinds))

    got = {"gather": side(("all_gather", "broadcast")),
           "reduce": side(("reduce_scatter", "reduce"))}
    waits = {k: (round(v.get("wait_seconds", 0.0), 3),
                 round(v["seconds"], 3)) for k, v in sorted(x.items())}
    log(f"      prefetch leg (fsdp_prefetch on, from the exact {fs} run's "
        f"seeded state, its batch): loss {on['losses']} against "
        f"{off['losses']}; blocks differing after the optimizer step "
        f"{on['blocks_differ']}; held layers at most "
        f"{on['held']['held_high_water']} ({on['held']['fetches']} "
        f"fetches), against {off['held']['held_high_water']} for the "
        f"whole-tree step; exchanges (bytes, calls) {got} against the "
        f"formula's {want}; launches {on['launches']}; {card}")
    log(f"      prefetch leg, not gated: peak memory "
        f"{on['peak_bytes'] / 2**30:.2f} GiB against the exact step's "
        f"{off['peak_bytes'] / 2**30:.2f}; host s a step "
        f"{[round(t, 3) for t in on['host_step_s']]} against "
        f"{[round(t, 3) for t in off['host_step_s']]}; exposed wait and "
        f"host seconds by exchange {waits}; {card}")
    if on["losses"] != off["losses"]:
        fail(f"prefetch loss {on['losses']} against {off['losses']}")
    if on["blocks_differ"]:
        fail(f"prefetch: blocks differ after the step: "
             f"{on['blocks_differ']}")
    if on["launches"] != expected:
        fail(f"prefetch launches {on['launches']}, expected {expected}")
    # at FSDP_LAYERS = 2 the whole-tree step holds 2 layers too: the
    # fetches (a layer at a time, forward and recompute) and the
    # per-layer exchanges tell the schedules apart
    fetches = 2 * FSDP_LAYERS * steps
    if not 0 < on["held"]["held_high_water"] <= 2 or \
            on["held"]["fetches"] != fetches or off["held"]["fetches"]:
        fail(f"prefetch held {on['held']} layers, {fetches} fetches "
             f"expected; the whole-tree step {off['held']}")
    if got != want:
        fail(f"prefetch exchanges {got} against the formula's {want}")
    return {"want": want, "got": got, "exposed_wait_and_seconds": waits,
            "peak_bytes": (on["peak_bytes"], off["peak_bytes"]),
            "host_step_s": (on["host_step_s"], off["host_step_s"])}


def fsdp_phase(run_local, llama, ep_train, card):
    """Phase 18: FSDP on the card. (a) the dense cell at (1, 2) against
    (2, 1), and under the fp8 wires; (b) phase 12's MoE run (the
    example, which picks (2, 2) at four ranks) against the same
    configuration at (4, 1)."""
    report = {"dense": fsdp_dense_part(run_local, llama, card)}
    report["moe"] = fsdp_moe_part(run_local, ep_train, card)
    return report


def fsdp_dense_part(run_local, llama, card):
    """Phase 18 (a)."""
    from dlrover_tpu_torch.ops import remat

    report = {}
    t0 = time.monotonic()
    config = llama.llama3_8b(num_layers=FSDP_LAYERS, max_seq_len=FSDP_SEQ)
    log(f"  (a) llama3_8b x{FSDP_LAYERS} layers (hidden "
        f"{config.hidden_size}, heads {config.num_heads}/"
        f"{config.num_kv_heads}, ffn {config.intermediate_size}, vocab "
        f"{config.vocab_size}), global batch {FSDP_ROWS} x {FSDP_SEQ}, "
        f"AdamW, rule set llama, 2 ranks sharing the card (gloo: the "
        f"all-gathers and reduce-scatters go through host memory; no "
        f"multi-GPU rate is claimed), {FSDP_STEPS} step a run from the "
        f"same state: at (data, fsdp) = {FSDP_MESHES[0]} with the layer "
        f"prefetch off and on, at {FSDP_MESHES[1]}, at (data, fsdp, seq) = "
        f"{FSDP_RING_MESH} (ring attention, 1,024 tokens of each row a "
        f"rank), then at {FSDP_MESHES} under the fp8 FSDP and gradient "
        f"wires; before them the ring body at seq = 2 (RING_CASES):")
    ranks = run_local(fsdp_dense_rank, 2,
                      (FSDP_LAYERS, FSDP_SEQ, FSDP_ROWS, FSDP_STEPS),
                      timeout=EP_TIMEOUT)
    ring_body_checks(ranks, card)
    recompute = 1 if remat.remat_enabled(config.remat_policy) else 0

    def expected_for(rank, seq):
        """One run's launches: a layer's B1 (twice under the remat), B2
        and B3; under the ring each once more on seq rank 1 (its past
        shard)."""
        n = FSDP_STEPS * FSDP_LAYERS * (1 + (rank if seq > 1 else 0))
        return {"flash_fwd": n * (1 + recompute), "flash_bwd_dkv": n,
                "flash_bwd_dq": n, **NO_SEG, **NO_PFX}

    expected = expected_for(0, 1)
    fs, dp = FSDP_MESHES
    for r in ranks:
        for mesh, precision, prefetch in FSDP_RUNS:
            run = r["runs"][fsdp_run_key(mesh[0], mesh[1], precision,
                                         prefetch, *mesh[2:])]
            want = expected_for(r["rank"], (*mesh, 1)[2])
            if run["launches"] != want:
                fail(f"rank {r['rank']} at {mesh} ({precision}): launches "
                     f"{run['launches']}, expected {want}")
            if not all(math.isfinite(x) for x in run["losses"]):
                fail(f"non-finite loss at {mesh} ({precision})")
            if run["effective"] != (precision, precision):
                fail(f"rank {r['rank']} at {mesh}: the wires run as "
                     f"{run['effective']}, asked {precision}")
        a, b = r["runs"][fs + ("bf16",)], r["runs"][dp + ("bf16",)]
        gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                      b["losses"]))
        # both runs' bytes on the leaves the fsdp run shards
        sb = _split_bytes(a["leaf_bytes"], a["sharded"])
        db = _split_bytes(b["leaf_bytes"], a["sharded"])
        nbytes = sum(a["gathered_leaf_bytes"].values())
        want_x = a["steps"] * nbytes
        got_g = a["exchange"].get("all_gather", {})
        got_s = a["exchange"].get("reduce_scatter", {})
        half = {k: (sb[k]["sharded"], db[k]["sharded"]) for k in sb}
        upd = b["after_update"]
        log(f"    rank {r['rank']}: losses at {fs} "
            f"{[round(x, 6) for x in a['losses']]}, at {dp} "
            f"{[round(x, 6) for x in b['losses']]}; largest relative gap "
            f"{gap:.3e} (limit {FSDP_LOSS_RTOL:.0e}); the blocks at {fs} "
            f"after the AdamW step against the matching slices at {dp}: "
            f"largest gap {upd['max_abs']:.3e} (limit "
            f"{FSDP_PARAM_ATOL:.0e}), {upd['differ']} elements differ, "
            f"missing {upd['missing']}; {card}")
        log(f"      state bytes a rank at {fs} / {dp}: parameters of the "
            f"leaves {fs} shards {sb['params']['sharded']} / "
            f"{db['params']['sharded']} B, of the rest "
            f"{sb['params']['replicated']} / {db['params']['replicated']}; "
            f"moments {sb['moments']['sharded']} / "
            f"{db['moments']['sharded']}, of the rest "
            f"{sb['moments']['replicated']} / "
            f"{db['moments']['replicated']}; sharded leaves {a['sharded']}; "
            f"{card}")
        log(f"      peak memory (max_memory_allocated) "
            f"{a['peak_bytes'] / 2**30:.2f} GiB at {fs}, "
            f"{b['peak_bytes'] / 2**30:.2f} at {dp}; exchanges at {fs}: "
            f"all-gather {got_g.get('calls', 0)} calls "
            f"{got_g.get('bytes', 0)} B {got_g.get('seconds', 0.0):.2f} s, "
            f"reduce-scatter {got_s.get('calls', 0)} calls "
            f"{got_s.get('bytes', 0)} B {got_s.get('seconds', 0.0):.2f} s "
            f"(formula: {a['steps']} steps x the sharded leaves' "
            f"{nbytes} B = {want_x} B each), all-reduce "
            f"{a['exchange'].get('all_reduce', {}).get('seconds', 0.0):.2f}"
            f" s; at {dp} all-reduce "
            f"{b['exchange'].get('all_reduce', {}).get('seconds', 0.0):.2f}"
            f" s; launches {a['launches']}; host s a step at {fs} "
            f"{[round(x, 3) for x in a['host_step_s']]}, at {dp} "
            f"{[round(x, 3) for x in b['host_step_s']]}; {card}")
        if gap > FSDP_LOSS_RTOL:
            fail(f"fsdp losses {a['losses']} vs data parallel "
                 f"{b['losses']}: gap {gap:.3e}")
        if not upd["max_abs"] <= FSDP_PARAM_ATOL or upd["missing"]:
            fail(f"rank {r['rank']}: the blocks after the step at {fs} "
                 f"against {dp}: {upd}")
        for kind, (got, full) in half.items():
            if 2 * got != full:
                fail(f"rank {r['rank']}: {kind} of the sharded leaves "
                     f"{got} B at {fs}, not half of {full} B at {dp}")
        for name, x in (("all_gather", got_g), ("reduce_scatter", got_s)):
            if x.get("bytes") != want_x or x.get("calls") != \
                    a["steps"] * len(a["sharded"]):
                fail(f"{name}: {x} against the formula's {want_x} B")
        r["loss_gap"] = gap
        r["ring_run"] = fsdp_ring_checks(r, b, card)
        r["wire"] = fsdp_wire_checks(r, config, card)
        r["prefetch"] = fsdp_prefetch_checks(r, expected, card)
        # JSON keys: "data x fsdp precision"
        r["runs"] = {f"{d}x{f} {p}": run
                     for (d, f, p), run in r["runs"].items()}
    report["dense"] = {"ranks": ranks, "expected_launches": expected,
                       "tolerance": FSDP_LOSS_RTOL,
                       "wall_s": time.monotonic() - t0}
    log(f"    ({report['dense']['wall_s']:.1f} s with the ranks' start-up; "
        f"{card})")
    return report["dense"]


def fsdp_ring_checks(r, dp_run, card):
    """Phase 18 (a)'s (1, 1, 2) run on one rank's record, against the
    (2, 1) run ``dp_run`` on the same batch (the same global function):
    the loss within FSDP_LOSS_RTOL, and the gradients as phase 6's
    cross-check holds two attention paths' (||g - g_(2,1)|| over
    ||g_(2,1)|| within GRAD_GAP_LIMIT, ``_grad_gap``); its launches
    (checked with the others), peak memory, host step and the ring's
    shifts logged. The parameters after the AdamW step are not held to
    FSDP_PARAM_ATOL: the ring sums a gradient in another order than the
    one-device attention (not bit for bit, as (1, 2) is with (2, 1)),
    and AdamW's first step moves an element by lr sign(g) for any |g|
    above eps, so an element whose gradient is of rounding size moves 2
    lr the other way (5.996e-4 = 2 x 3e-4, 639,437,558 elements
    differing, on an NVIDIA H100 80GB HBM3 at 700 W)."""
    run = r["runs"][FSDP_RING_MESH[:2] + ("seq2",)]
    gap = max(abs(x - y) / abs(y) for x, y in zip(run["losses"],
                                                  dp_run["losses"]))
    upd = run["after_update"]
    grads = upd["grads"]
    worst = max(grads["leaf_gap"], key=grads["leaf_gap"].get)
    st = run["exchange"].get("ring_shift", {})
    log(f"    rank {r['rank']} at (data, fsdp, seq) = {FSDP_RING_MESH}: "
        f"losses {[round(x, 6) for x in run['losses']]} against (2, 1)'s "
        f"{[round(x, 6) for x in dp_run['losses']]}, relative gap "
        f"{gap:.3e} (limit {FSDP_LOSS_RTOL:.0e}); gradient gap "
        f"||g - g_(2,1)|| / ||g_(2,1)|| {grads['gap']:.3e} (limit "
        f"{GRAD_GAP_LIMIT:.0e}), worst leaf {worst} "
        f"{grads['leaf_gap'][worst]:.3e}, missing {upd['missing']}; "
        f"launches { {k: v for k, v in run['launches'].items() if v} }; "
        f"peak memory {run['peak_bytes'] / 2**30:.2f} GiB (at (2, 1) "
        f"{dp_run['peak_bytes'] / 2**30:.2f}); host s a step "
        f"{[round(x, 3) for x in run['host_step_s']]} (at (2, 1) "
        f"{[round(x, 3) for x in dp_run['host_step_s']]}); ring shifts "
        f"{st.get('calls', 0)} calls {st.get('bytes', 0)} B "
        f"{st.get('seconds', 0.0):.2f} s, exposed wait "
        f"{st.get('wait_seconds', 0.0):.2f} s; the run {run['wall_s']:.1f} "
        f"s with its build and checks; {card}")
    if gap > FSDP_LOSS_RTOL:
        fail(f"rank {r['rank']}: the ring run's losses {run['losses']} vs "
             f"(2, 1)'s {dp_run['losses']}: gap {gap:.3e}")
    if not grads["gap"] <= GRAD_GAP_LIMIT or upd["missing"]:
        fail(f"rank {r['rank']}: the ring run's gradients against (2, 1)'s: "
             f"gap {grads['gap']:.3e}, per leaf {grads['leaf_gap']}, "
             f"missing {upd['missing']}")
    return {"loss_gap": gap, "after_update": upd, "ring_shift": st}


def fsdp_moe_part(run_local, ep_train, card):
    """Phase 18 (b)."""
    report = {}
    t0 = time.monotonic()
    argv = ep_train["argv"]
    log(f"  (b) phase 12's run (the example picks (data, fsdp) = (2, 2) at "
        f"{EP_RANKS} ranks) against the same configuration at (4, 1) "
        f"through ElasticTrainer, {FSDP_MOE_STEPS} steps on the same "
        f"batches:")
    ranks = run_local(fsdp_moe_rank, EP_RANKS, (argv, FSDP_MOE_STEPS),
                      timeout=EP_TIMEOUT)
    per = FSDP_MOE_STEPS * MOE_LAYERS
    expected = {"flash_fwd": 2 * per, "flash_bwd_dkv": per,
                "flash_bwd_dq": per, **NO_SEG, **NO_PFX,
                "grouped_matmul_fwd": 6 * per,
                "grouped_matmul_dw": 2 * per,
                "grouped_matmul_fwd_quant": 2 * per}
    fsdp_losses = ep_train["losses"][:FSDP_MOE_STEPS]
    for r in ranks:
        gap = max(abs(x - y) / abs(y) for x, y in zip(fsdp_losses,
                                                      r["losses"]))
        p12 = ep_train["ranks"][r["rank"]]["peak_bytes"]
        log(f"    rank {r['rank']}: losses at (2, 2) (phase 12) "
            f"{[round(x, 6) for x in fsdp_losses]}, at (4, 1) "
            f"{[round(x, 6) for x in r['losses']]}; largest relative gap "
            f"{gap:.3e} (limit {FSDP_MOE_RTOL:.0e}); peak memory "
            f"{p12 / 2**30:.2f} GiB at (2, 2), "
            f"{r['peak_bytes'] / 2**30:.2f} at (4, 1); launches "
            f"{r['launches']}; {card}")
        if r["launches"] != expected:
            fail(f"rank {r['rank']} launches {r['launches']}, expected "
                 f"{expected}")
        if gap > FSDP_MOE_RTOL:
            fail(f"the MoE cell at (2, 2) against (4, 1): gap {gap:.3e}")
        r["loss_gap"] = gap
    report["moe"] = {"ranks": ranks, "fsdp_losses": fsdp_losses,
                     "expected_launches": expected,
                     "tolerance": FSDP_MOE_RTOL,
                     "wall_s": time.monotonic() - t0}
    log(f"    ({report['moe']['wall_s']:.1f} s with the ranks' start-up; "
        f"{card})")
    return report["moe"]


# -- phase 19: serving -------------------------------------------------------
#
# Runs right after phase 5, on its trained weights (promoted through a
# HostSnapshot of the parameters), so that the trainer's state is freed
# before phase 6 and never resident through phases 11-18.

SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_PAGE = 8, 2048, 16
SERVE_CHUNK, SERVE_WINDOW, SERVE_NEW = 256, 2, 48
SERVE_REQUESTS, SERVE_SEED = 12, 19
SERVE_PROMPTS = (64, 1536)  # log-uniform prompt lengths, tokens
SERVE_LEAD = 512  # the prefix check's shared lead (two chunks)
SPEC_K = 4
# decode logits against one teacher-forced llama.apply with its attention
# exact in f32 (bf16 compute everywhere else): the sound path within it,
# the planted faults beyond. Set from probe runs of phases 5 and 19 on
# phase 5's weights: sound 0.0312, the mask fault 0.0938, the RoPE fault
# 0.330 (on random weights the faults read 1.64-1.68)
SERVE_LOGIT_LIMIT = 0.055
INT8_LOGIT_LIMIT = 0.25  # the reference's documented int8-pool bound


def serve_jobs(vocab, n=SERVE_REQUESTS, seed=SERVE_SEED, lead=()):
    """``n`` requests (id, prompt, max new tokens): prompt lengths
    log-uniform over SERVE_PROMPTS from ``seed`` (after ``lead``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = SERVE_PROMPTS
    lengths = np.exp(rng.uniform(math.log(lo), math.log(hi), n)).astype(int)
    return [(f"r{i}", list(lead) + rng.integers(0, vocab, int(p)).tolist(),
             SERVE_NEW) for i, p in enumerate(lengths)]


def serve_engine(config, params, **kw):
    """A ServeEngine on the card at the phase's geometry, ``params`` (a
    HostSnapshot or a tree) promoted into it."""
    from dlrover_tpu_torch.serving.engine import ServeEngine

    eng = ServeEngine(config, serve_slots=SERVE_SLOTS,
                      prefill_chunk=SERVE_CHUNK, max_seq=SERVE_MAX_SEQ,
                      page_size=SERVE_PAGE, **{"kv_precision": "f32", **kw})
    eng.load_from_snapshot(params)
    return eng


def spy_rows(program, ex, rows, stack):
    """Record each request's logits (its final prefill chunk's, then its
    row of each decode step) from ``program``'s calls, as
    ``serve_capture``'s spies do, until ``stack`` closes."""
    decode, prefill = program.decode, program.prefill

    def decode_spy(params, cache, tokens, active):
        owners = {i: r.request_id for i, r in enumerate(ex._slots)
                  if r is not None and ex._active_host[i]}
        out = decode(params, cache, tokens, active)
        for slot, rid in owners.items():
            rows[rid].append(out[1][slot])
        return out

    def prefill_spy(params, cache, tokens, slot, start, n_valid):
        out = prefill(params, cache, tokens, slot, start, n_valid)
        state = ex._slots[slot]
        if start + n_valid == len(state.prompt):
            rows[state.request_id].append(out[1])
        return out

    stack.enter_context(swapped(program, "decode", decode_spy))
    stack.enter_context(swapped(program, "prefill", prefill_spy))


def serve_capture(engine, jobs, proposer=None, capture=True):
    """Serve ``jobs`` through ServeExecutor on a fresh pool; with
    ``capture`` each request's logits too (its final prefill chunk's, then
    its row of each decode step, read on the device by spies around the
    program's calls). Returns (records by id, logits rows by id, the
    executor, serve wall s)."""
    from dlrover_tpu_torch.serving.engine import ServeExecutor

    engine.cache = engine.fresh_cache()
    ex = ServeExecutor(engine, serve_window=SERVE_WINDOW,
                       spec_proposer=proposer)
    rows = {rid: [] for rid, _, _ in jobs}
    with contextlib.ExitStack() as stack:
        if capture:
            spy_rows(engine.program, ex, rows, stack)
        for rid, prompt, new in jobs:
            ex.submit(prompt, max_new_tokens=new, request_id=rid)
        t0 = time.monotonic()
        done = {r["request_id"]: r for r in ex.serve()}
        wall = time.monotonic() - t0
    for rid, _, new in jobs:
        if done[rid]["error_code"] or len(done[rid]["tokens"]) != new:
            fail(f"serving request {rid}: {done[rid]}")
    return done, rows, ex, wall


def apply_check(llama, params, config, jobs, done, rows):
    """Each request's captured logits against one teacher-forced
    ``llama.apply`` over its prompt and generated tokens, its attention
    exact in f32 (``exact_attention``, as phase 6's loss check computes
    its reference; the decode path's attention is f32 too), and beside
    it against ``apply`` through B1 (whose P.V product rounds P to bf16).
    Returns {"exact": max |logit difference|, "exact_rms", "b1",
    "wrong": positions whose token is not the exact apply's argmax where
    its top-2 margin exceeds SERVE_LOGIT_LIMIT, "positions"}."""
    import torch

    exact_cfg = dataclasses.replace(config, use_flash=False)
    out = {"exact": 0.0, "b1": 0.0, "wrong": [], "positions": 0}
    squares = 0.0
    for rid, prompt, _ in jobs:
        toks = done[rid]["tokens"]
        n = len(toks)
        got = torch.stack(rows[rid][:n]).float()
        ids = torch.tensor([prompt + toks[:-1]], device="cuda")
        with torch.inference_mode():
            with swapped(llama, "mha_reference", exact_attention):
                want = llama.apply(params, ids, exact_cfg)[0][
                    0, len(prompt) - 1:]
            b1 = llama.apply(params, ids, config)[0][0, len(prompt) - 1:]
        diff = (got - want).abs()
        out["exact"] = max(out["exact"], diff.max().item())
        out["b1"] = max(out["b1"], (got - b1).abs().max().item())
        squares += diff.square().sum().item()
        top2 = want.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > SERVE_LOGIT_LIMIT
        bad = sure & (want.argmax(dim=-1).cpu() != torch.tensor(toks)).to(
            sure.device)
        out["wrong"] += [(rid, i) for i in bad.nonzero().flatten().tolist()]
        out["positions"] += n
    out["exact_rms"] = math.sqrt(squares / (out["positions"]
                                            * config.vocab_size))
    return out


def prefill_sequence_check(llama, fa, engine, config, card):
    """(a) ``prefill_sequence`` of one SEQ-token prompt into a one-slot
    f32 pool SEQ deep: B1 launched once a layer and nothing else, the last
    hidden row ``apply_hidden``'s bit for bit, the first token ``apply``'s
    argmax, the slot's K/V rows ``_attention_block``'s ``return_kv`` bit
    for bit."""
    import torch

    from dlrover_tpu_torch.serving.kv_cache import (
        KVCacheSpec,
        init_kv_cache,
    )

    spec = KVCacheSpec.from_model(config, num_slots=1, max_seq=SEQ,
                                  page_size=SERVE_PAGE, precision="f32")
    cache = init_kv_cache(spec, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
    toks = torch.randint(0, config.vocab_size, (SEQ,), generator=gen,
                         device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.monotonic()
    cache, last, hidden = llama.prefill_sequence(
        engine.params, cache, toks, 0, config, spec, return_hidden=True)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = fa.launch_counts()
    expected = {**{name: 0 for name in counts}, "flash_fwd": LAYERS}
    if counts != expected:
        fail(f"prefill_sequence launched {counts}, expected {expected}")
    captured = []
    block = llama._attention_block

    def spy(x, layer, cfg, positions, segment_ids=None, return_kv=False):
        out, kv = block(x, layer, cfg, positions, segment_ids,
                        return_kv=True)
        captured.append(kv)
        return (out, kv) if return_kv else out

    with torch.inference_mode():
        with swapped(llama, "_attention_block", spy):
            h, _ = llama.apply_hidden(engine.params, toks[None].long(),
                                      config)
        want = llama.apply(engine.params, toks[None].long(), config)[0][0, -1]
    if not torch.equal(hidden, h[0, -1]):
        fail("prefill_sequence's last hidden row differs from "
             "apply_hidden's")
    first, first_apply = int(last.argmax()), int(want.argmax())
    if first != first_apply:
        fail(f"prefill_sequence's first token {first}, apply's {first_apply}")
    head_err = (last - want).abs().max().item()
    kv_equal = len(captured) == LAYERS and all(
        torch.equal(cache[name][i, 0], kv[j][0].float())
        for i, kv in enumerate(captured) for j, name in enumerate("kv"))
    if not kv_equal or int(cache["length"][0]) != SEQ:
        fail("prefill_sequence's K/V rows differ from _attention_block's "
             "return_kv")
    log(f"  (a) prefill_sequence, {SEQ} tokens into a one-slot f32 pool "
        f"{SEQ} deep ({spec.total_bytes() / 1e6:.1f} MB): launches {counts}; "
        f"last hidden row bit for bit apply_hidden's, first token {first} = "
        f"apply's argmax, K/V rows bit for bit return_kv's; the one-row head "
        f"{'bit for bit' if head_err == 0 else f'max |logit diff| {head_err:.3e}'}"
        f" against apply's [{SEQ}, D] head; {seconds * 1e3:.1f} ms host "
        f"wall; {card}")
    return {"launches": counts, "b1_launches": counts["flash_fwd"],
            "head_max_abs_diff": head_err, "seconds": seconds,
            "first_token": first}


def planted_serve_faults(llama, engine, config, jobs):
    """(b)'s planted faults, each served through the executor and held
    against apply the same way: the decode mask ``t < pos`` and RoPE at
    ``pos + 1`` in the decode step."""
    out = {}
    paged, rope = llama._paged_attention, llama._rope
    program = engine.program
    decode = program.decode

    def mask_lt(q, k_l, ks_l, v_l, vs_l, pos, spec, cfg):
        return paged(q, k_l, ks_l, v_l, vs_l, pos - 1, spec, cfg)

    def rope_decode(params, cache, tokens, active):
        with swapped(llama, "_rope",
                     lambda x, positions, theta: rope(x, positions + 1,
                                                      theta)):
            return decode(params, cache, tokens, active)

    for name, ctx in (("mask t < pos", swapped(llama, "_paged_attention",
                                               mask_lt)),
                      ("RoPE at pos + 1", swapped(program, "decode",
                                                  rope_decode))):
        with ctx:
            done, rows, _, _ = serve_capture(engine, jobs)
        out[name] = apply_check(llama, engine.params, config, jobs, done,
                                rows)
        if out[name]["exact"] <= SERVE_LOGIT_LIMIT:
            fail(f"the planted serving fault '{name}' stays within the "
                 f"logit limit: {out[name]} <= {SERVE_LOGIT_LIMIT}")
    return out


class ServeOracle:
    """Drafts a request's true greedy continuation (from a plain serve):
    every draft accepted. ``wrong``: each token plus one (none accepted);
    ``alternate``: right and wrong by turns; ``half``: prompts named get
    half-length drafts, ``none``: prompts named get none (mixed draft
    lengths in one verify step)."""

    def __init__(self, refs, vocab, mode="right", half=(), none=()):
        self.refs, self.vocab, self.mode = refs, vocab, mode
        self.half, self.none, self.calls = set(half), set(none), 0

    def propose(self, history, k):
        for prompt, stream in self.refs.items():
            if tuple(history[:len(prompt)]) != prompt:
                continue
            if prompt in self.none:
                return []
            done = len(history) - len(prompt)
            draft = list(stream[done:done + (max(1, k // 2)
                                              if prompt in self.half
                                              else k)])
            self.calls += 1
            wrong = (self.mode == "wrong"
                     or (self.mode == "alternate" and self.calls % 2 == 0))
            return [(t + 1) % self.vocab for t in draft] if wrong else draft
        return []


def spec_legs(engine, jobs, expect, vocab, label):
    """(c) speculative decode (K = SPEC_K) against the plain greedy
    stream ``expect``, with the n-gram proposer and forced ones."""
    refs = {tuple(p): expect[rid] for rid, p, _ in jobs}
    prompts = [tuple(p) for _, p, _ in jobs]
    legs = {
        "ngram": None,
        "right": lambda: ServeOracle(refs, vocab),
        "wrong": lambda: ServeOracle(refs, vocab, "wrong"),
        "alternating": lambda: ServeOracle(refs, vocab, "alternate"),
        "mixed": lambda: ServeOracle(refs, vocab, half=prompts[1:2],
                                     none=prompts[2:]),
    }
    out = {}
    for name, factory in legs.items():
        done, _, ex, wall = serve_capture(engine, jobs, proposer=factory,
                                          capture=False)
        drafted = sum(r["spec_drafted_tokens"] for r in done.values())
        accepted = sum(r["spec_accepted_tokens"] for r in done.values())
        for rid, _, _ in jobs:
            if done[rid]["tokens"] != expect[rid]:
                fail(f"{label} spec decode ({name} drafts) differs from "
                     f"plain greedy on {rid}")
        if (name == "right" and accepted != drafted) or (
                name == "wrong" and accepted) or (
                name != "ngram" and not drafted):
            fail(f"{label} spec decode ({name}): drafted {drafted}, "
                 f"accepted {accepted}")
        out[name] = {"drafted": drafted, "accepted": accepted,
                     "verify_steps": ex.decode_steps, "wall_s": wall}
    log(f"  (c) {label} pool, K = {SPEC_K}: token for token plain greedy "
        "with drafts " + ", ".join(
            f"{n} {v['accepted']}/{v['drafted']} in {v['verify_steps']} "
            f"steps" for n, v in out.items()))
    return out


def no_host_sync(name, fn):
    """(e) ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as exc:
        fail(f"{name} waits for the device: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def decode_profile(decode, n=5):
    """``n`` decode steps back to back under torch.profiler, the trace
    read by ``telemetry.attribution``: device busy ms a step, the idle
    share of the steps' span, time by kernel group and the top kernels."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.telemetry import attribution

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            decode()
        end.record()
        end.synchronize()
    step_ms = start.elapsed_time(end) / n
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "decode.pt.trace.json")
        prof.export_chrome_trace(path)
        buckets = attribution.parse_trace_path(path)
        view = attribution.kernel_breakdown(attribution.load_trace(path), n,
                                            top=6)
    busy = buckets["busy_s"] * 1e3 / n
    if busy == 0.0:
        log("    decode profile: no device time recorded (not measured)")
        return {"device_ms": None, "step_ms": step_ms}
    log(f"    decode step profiled ({n} steps): device busy {busy:.3f} ms "
        f"of {step_ms:.3f} ms a step (idle share {1 - busy / step_ms:.3f}); "
        + ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(
            view["groups_ms"].items(), key=lambda kv: -kv[1])))
    for ms, count, name in view["top"]:
        log(f"      top kernel {ms:.3f} ms x{count:g}: {name[:80]}")
    return {"device_ms": busy, "step_ms": step_ms,
            "idle_share": 1 - busy / step_ms,
            "groups_ms": view["groups_ms"],
            "top": [(ms, count, name[:200])
                    for ms, count, name in view["top"]]}


def serve_step_times(llama, engine, spec_engine, config, card):
    """The decode step at SERVE_SLOTS active slots (CUDA events around
    calls queued back to back, and the device's busy time by the
    profiler) beside its bound from the bytes and FLOPs ``CostCounter``
    counts for one step on the meta device, the prefill chunk and the
    verify step; each step also once with host syncs forbidden."""
    import torch

    from dlrover_tpu_torch.models.common import tree_leaves, tree_map
    from dlrover_tpu_torch.utils.prof import CostCounter

    program = engine.program
    s = SERVE_SLOTS
    scratch = engine.fresh_cache()
    scratch["length"].fill_(SERVE_MAX_SEQ // 2)
    tokens = torch.zeros((s,), dtype=torch.int32, device="cuda")
    active = torch.ones((s,), dtype=torch.bool, device="cuda")
    chunk = torch.zeros((SERVE_CHUNK,), dtype=torch.int32, device="cuda")

    def decode():
        program.decode(engine.params, scratch, tokens, active)

    def prefill():
        program.prefill(engine.params, scratch, chunk, 0, 0, SERVE_CHUNK)

    spec_scratch = spec_engine.fresh_cache()
    spec_scratch["length"].fill_(SERVE_MAX_SEQ // 2)
    draft = torch.zeros((s, SPEC_K + 1), dtype=torch.int32, device="cuda")
    n_draft = torch.full((s,), SPEC_K, dtype=torch.int32, device="cuda")

    def verify():
        spec_engine.program.verify(spec_engine.params, spec_scratch, draft,
                                   active, n_draft)

    for name, fn in (("decode_step", decode), ("prefill_chunk", prefill),
                     ("verify_step", verify)):
        fn()
        no_host_sync(name, fn)
    out = {"decode_ms": time_ms(decode, 20),
           "decode_host_ms": host_ms(decode, 20),
           "prefill_ms": time_ms(prefill, 10),
           "verify_ms": time_ms(verify, 10),
           "profile": decode_profile(decode)}

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def counted(c):
        """The CostCounter of one decode step of ``c`` on the meta
        device (``c.num_layers`` of the engine's layers)."""
        with CostCounter() as cc:
            llama.decode_step(tree_map(meta, engine.params),
                              {k: meta(v) for k, v in scratch.items()},
                              meta(tokens), meta(active), c, program.spec)
        return cc

    cc = counted(config)
    # the ops a step dispatches, and how many of them a layer adds
    ops = int(sum(v[2] for v in cc.by_op.values()))
    one = counted(dataclasses.replace(config, num_layers=1))
    ops_1 = int(sum(v[2] for v in one.by_op.values()))
    per_layer = (ops - ops_1) / max(1, config.num_layers - 1)
    out.update({"ops": ops, "ops_per_layer": per_layer,
                "ops_outside_layers": ops_1 - per_layer})
    emb = engine.params["embed_tokens"]["embedding"]
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(engine.params)) - emb.numel() * \
        emb.element_size() + s * emb.shape[1] * emb.element_size()
    pool = program.spec.total_bytes()
    out.update({
        "counted_bytes": cc.bytes, "counted_flops": cc.flops,
        "bound_ms": max(cc.bytes / PEAK_BYTES,
                        cc.flops / PEAK_BF16_FLOPS) * 1e3,
        "once_bytes": weights + pool,
        "once_bound_ms": (weights + pool) / PEAK_BYTES * 1e3,
        "pool_bytes": pool,
    })
    out["decode_tokens_per_s"] = s / out["decode_ms"] * 1e3
    busy = out["profile"]["device_ms"]
    log(f"  decode step at {s} active slots: {out['decode_ms']:.3f} ms a "
        f"step queued back to back ({out['decode_tokens_per_s']:.0f} "
        f"tokens/s), the host {out['decode_host_ms']:.3f} ms to queue one "
        f"step from an empty queue ({ops} ops, {per_layer:g} a layer, "
        f"{out['ops_outside_layers']:g} outside the layers), the device busy "
        + (f"{busy:.3f} ms of it (profiler)" if busy else "not measured")
        + f"; bound "
        f"{out['bound_ms']:.3f} ms from CostCounter's "
        f"{cc.bytes / 1e9:.3f} GB and {cc.flops / 1e9:.1f} GFLOP a step "
        f"(each op's inputs and outputs), {out['once_bound_ms']:.3f} ms "
        f"reading the weights and the pool once "
        f"({(weights + pool) / 1e9:.3f} GB); prefill chunk of "
        f"{SERVE_CHUNK}: {out['prefill_ms']:.3f} ms; verify step, K = "
        f"{SPEC_K}: {out['verify_ms']:.3f} ms "
        f"({out['verify_ms'] / out['decode_ms']:.2f}x the decode step: "
        f"each position at a decode step's shapes); KV pool "
        f"{pool / 1e6:.1f} MB; no host sync in any of the three; {card}")
    return out


# phase 19's elastic legs: the plans a stub master serves during one replay
# of the 12 requests, each issued once the previous one is acked and its
# condition holds (``PlanStub``)
RETUNE_SLOTS = 16
RETUNE_CHUNK, UNFIT_CHUNK = 128, 300  # 300 does not divide 2048: nacked
RETUNE_POOL_BYTES = 1_073_741_824  # the f32 pool at 16 slots
RESIZE_AT = 12  # decode steps before the live resize


class PlanStub:
    """A master for one executor: serves the plans of ``schedule``
    ([(plan id, knobs, condition(executor))]) through
    ``get_parallel_config`` and records the executor's config reports
    (its acks) and the decode step at which each plan went out."""

    def __init__(self, schedule):
        self.schedule = list(schedule)
        self.reports, self.issued = [], {}
        self.executor = None

    def serve_lease(self, max_requests):
        return []

    def serve_complete(self, **record):
        pass

    def report_serve_config(self, **fields):
        self.reports.append(fields)

    def acked(self, plan_id):
        return any(r["plan_id"] == plan_id for r in self.reports)

    def get_parallel_config(self):
        ex = self.executor
        for i, (plan_id, knobs, ready) in enumerate(self.schedule):
            if self.acked(plan_id):
                continue
            if plan_id not in self.issued:
                if i and not self.acked(self.schedule[i - 1][0]):
                    break
                if not ready(ex):
                    break
                self.issued[plan_id] = {
                    "decode_steps": ex.decode_steps,
                    "live": live_requests(ex),
                    "mid_prefill": mid_prefill(ex)}
            return types.SimpleNamespace(
                plan_id=plan_id, serve_prefix_pool_pages=-1,
                serve_spec_draft_len=-1, prewarm=True,
                **{"serve_slots": 0, "serve_prefill_chunk": 0, **knobs})
        return types.SimpleNamespace(plan_id="")


def live_requests(ex):
    return sum(r is not None for r in ex._slots)


def mid_prefill(ex):
    return sum(r is not None and not ex._active_host[i]
               and 0 < r.cursor < len(r.prompt)
               for i, r in enumerate(ex._slots))


def timing_stats(records):
    ttft = [r["ttft_s"] * 1e3 for r in records]
    tpot = [(r["e2e_s"] - r["ttft_s"]) / (len(r["tokens"]) - 1) * 1e3
            for r in records]
    return statistics.median(ttft), statistics.median(tpot)


def tokens_differing(done, base):
    """(positions, requests) whose tokens differ from ``base``'s."""
    positions = requests = 0
    for rid, rec in done.items():
        diff = sum(a != b for a, b in zip(rec["tokens"], base[rid]["tokens"]))
        positions += diff
        requests += bool(diff)
    return positions, requests


def retune_leg(llama, engine, config, jobs, base, card):
    """(d) The 12 requests replayed under a stub master's plans: 16 slots
    (prewarmed) after the first decode steps, chunk 128 while prompts are
    mid-prefill, chunk 300 (negative-acked), back to 8 slots once at most
    8 requests are live. Every plan acked as the reference acks it, no
    build in a prewarmed retune, the pool's bytes at 16 slots, every
    request's logits through apply_check."""
    import torch

    from dlrover_tpu_torch.serving.engine import ServeExecutor

    schedule = [
        ("wide", {"serve_slots": RETUNE_SLOTS},
         lambda ex: ex.decode_steps >= 1),
        ("chunk", {"serve_prefill_chunk": RETUNE_CHUNK},
         lambda ex: ex.decode_steps >= 4 and mid_prefill(ex) > 0),
        ("unfit", {"serve_prefill_chunk": UNFIT_CHUNK}, lambda ex: True),
        ("narrow", {"serve_slots": SERVE_SLOTS},
         lambda ex: live_requests(ex) <= SERVE_SLOTS),
    ]
    stub = PlanStub(schedule)
    engine.cache = engine.fresh_cache()
    ex = ServeExecutor(engine, router_client=stub, serve_window=SERVE_WINDOW,
                       plan_poll_secs=1e-9)
    stub.executor = ex
    rows = {rid: [] for rid, _, _ in jobs}
    calls = []
    prewarm, retune = engine.prewarm, engine.retune

    def timed_prewarm(**knobs):
        # prompts at cursor 0 but not decoding were restarted by a chunk
        # change just before (admission prefills a chunk at once)
        restarted = sum(r is not None and not ex._active_host[i]
                        and r.cursor == 0 for i, r in enumerate(ex._slots))
        t0 = time.monotonic()
        built = prewarm(**knobs)
        torch.cuda.synchronize()
        knobs = {k: v for k, v in knobs.items() if v is not None}
        calls.append({"call": "prewarm", "knobs": knobs, "built": built,
                      "s": time.monotonic() - t0, "restarted": restarted})
        return built

    with contextlib.ExitStack() as stack:
        spied = set()

        def spy_active():
            if id(engine.program) not in spied:
                spied.add(id(engine.program))
                spy_rows(engine.program, ex, rows, stack)

        def timed_retune(**knobs):
            before = engine.compile_count
            t0 = time.monotonic()
            built = retune(**knobs)
            calls.append({
                "call": "retune", "knobs": {
                    k: v for k, v in knobs.items()
                    if k != "slot_map" and v is not None},
                "built": built, "builds": engine.compile_count - before,
                "s": time.monotonic() - t0,
                "slots": engine.program.spec.num_slots,
                "pool_bytes": sum(t.numel() * t.element_size()
                                  for t in engine.cache.values()
                                  if t.dim() > 1)})
            spy_active()
            return built

        stack.enter_context(swapped(engine, "prewarm", timed_prewarm))
        stack.enter_context(swapped(engine, "retune", timed_retune))
        spy_active()
        for rid, prompt, new in jobs:
            ex.submit(prompt, max_new_tokens=new, request_id=rid)
        t0 = time.monotonic()
        done = {r["request_id"]: r for r in ex.serve()}
        wall = time.monotonic() - t0
    for rid, _, new in jobs:
        if done[rid]["error_code"] or len(done[rid]["tokens"]) != new:
            fail(f"retuned serving request {rid}: {done[rid]}")
    acks = [(r["plan_id"], r["apply_failed"]) for r in stub.reports
            if r["plan_id"]]
    want = [("wide", False), ("chunk", False), ("unfit", True),
            ("narrow", False)]
    if acks != want:
        fail(f"serve plans acked {acks}, the reference acks {want}")
    retunes = [c for c in calls if c["call"] == "retune"]
    prewarms = [c for c in calls if c["call"] == "prewarm"]
    if len(retunes) != 3 or any(c["builds"] for c in retunes):
        fail(f"a prewarmed retune built a program: {calls}")
    if retunes[0]["slots"] != RETUNE_SLOTS or \
            retunes[0]["pool_bytes"] != RETUNE_POOL_BYTES:
        fail(f"the pool at {RETUNE_SLOTS} slots: {retunes[0]} (expected "
             f"{RETUNE_POOL_BYTES} B)")
    if not stub.issued["chunk"]["mid_prefill"] or not prewarms[1][
            "restarted"]:
        fail(f"the chunk plan restarted no prompt mid-prefill: "
             f"{stub.issued}, {prewarms}")
    check = apply_check(llama, engine.params, config, jobs, done, rows)
    if check["exact"] > SERVE_LOGIT_LIMIT or check["wrong"]:
        fail(f"retuned batching against apply: {check} (limit "
             f"{SERVE_LOGIT_LIMIT})")
    differ = tokens_differing(done, base)
    ttft, tpot = timing_stats(list(done.values()))
    out = {"acks": acks, "issued": stub.issued, "calls": calls,
           "apply_check": check, "tokens_differing": differ,
           "wall_s": wall, "ttft_ms_median": ttft, "tpot_ms_median": tpot,
           "decode_steps": ex.decode_steps, "ledger": ex.slot_ledger()}
    log(f"  elastic (d) retune under traffic, the {SERVE_REQUESTS} requests "
        f"again under a stub master's plans: acks {acks} (issued at "
        + ", ".join(f"{k} step {v['decode_steps']}, {v['live']} live, "
                    f"{v['mid_prefill']} mid-prefill"
                    for k, v in stub.issued.items())
        + "); "
        + "; ".join(f"{c['call']} {c['knobs']} built {c['built']} in "
                    f"{c['s']:.3f} s" for c in calls)
        + f"; {prewarms[1]['restarted']} prompts restarted by the chunk "
        f"change"
        + f"; pool {retunes[0]['pool_bytes']} B at {RETUNE_SLOTS} slots; "
        f"logits within {check['exact']:.4f} of the exact apply (limit "
        f"{SERVE_LOGIT_LIMIT}; through B1 {check['b1']:.4f}), no wrong token; "
        f"{differ[0]} tokens in {differ[1]} requests differ from the "
        f"unretuned run; TTFT median {ttft:.1f} ms, TPOT median {tpot:.2f} "
        f"ms; {ex.decode_steps} decode steps in {wall:.3f} s; slot ledger "
        f"resize_frozen {out['ledger']['resize_frozen']:.3f} of "
        f"{out['ledger']['slot_seconds']:.3f} slot-s; {card}")
    return out


def resize_leg(engine, jobs, base, card):
    """(e) The 12 requests again, resized live onto the same card after
    RESIZE_AT decode steps (the engine prewarmed first): the tokens equal
    the resize-free run's, SERVE_RESIZE_DONE reads recompiled 0; the
    snapshot's bytes, its take and restore seconds, the resize's."""
    import torch

    from dlrover_tpu_torch.serving.engine import ServeExecutor
    from dlrover_tpu_torch.telemetry import EventKind, recent_events

    target = torch.device("cuda", torch.cuda.current_device())
    prewarmed = engine.prewarm(devices=[target])
    builds = engine.compile_count
    parts = {}
    take = engine.snapshot

    def timed_snapshot():
        t0 = time.monotonic()
        snap = take()
        parts["take_s"] = time.monotonic() - t0
        parts["bytes"] = snap.nbytes()
        restore = snap.restore_tree

        def timed_restore(device):
            t1 = time.monotonic()
            tree = restore(device)
            parts["restore_s"] = time.monotonic() - t1
            return tree

        snap.restore_tree = timed_restore
        return snap

    engine.cache = engine.fresh_cache()
    ex = ServeExecutor(engine, serve_window=SERVE_WINDOW)
    for rid, prompt, new in jobs:
        ex.submit(prompt, max_new_tokens=new, request_id=rid)
    since = len(recent_events())
    with swapped(engine, "snapshot", timed_snapshot):
        ex.serve(max_steps=RESIZE_AT, until_idle=False)
        live = sum(ex._active_host)
        if not live:
            fail("no request mid-decode at the live resize")
        ex.request_resize([target])
        t0 = time.monotonic()
        done = {r["request_id"]: r for r in ex.serve()}
        wall = time.monotonic() - t0
    event = last_event(EventKind.SERVE_RESIZE_DONE, since)
    differ = tokens_differing(done, base)
    if differ[0] or set(done) != set(base):
        fail(f"continuations across the live resize differ from the "
             f"resize-free run: {differ[0]} tokens in {differ[1]} requests")
    if event["recompiled"] or engine.compile_count != builds:
        fail(f"the live resize built a program: {event}")
    out = {"prewarm_built": prewarmed, "live_decoding": live,
           "event": {k: event[k] for k in ("world_from", "world_to",
                                           "reshard_seconds", "recompiled")},
           "snapshot_bytes": parts["bytes"], "take_s": parts["take_s"],
           "restore_s": parts["restore_s"], "serve_wall_s": wall}
    log(f"  elastic (e) live resize onto {target} after {RESIZE_AT} decode "
        f"steps ({live} slots decoding; prewarm built {prewarmed}): every "
        f"request's tokens the resize-free run's; SERVE_RESIZE_DONE "
        f"{out['event']}; snapshot {parts['bytes']} B, take "
        f"{parts['take_s']:.3f} s, restore {parts['restore_s']:.3f} s, the "
        f"resize {event['reshard_seconds']:.3f} s; {card}")
    return out


def decode_estimate_line(config, steps, card):
    """(f) ``planner.estimate_decode`` for phase 19's geometry on the
    card's DeviceSpec, beside the measured decode step, and the host ms a
    layer this run measured beside the planner's constant. No gate."""
    from dlrover_tpu_torch.parallel import planner

    m = planner.model_spec_from_llama(config)
    est = planner.estimate_decode(m, 1, SERVE_SLOTS, SERVE_CHUNK,
                                  SERVE_MAX_SEQ, "f32",
                                  page_size=SERVE_PAGE)
    host_layer_ms = steps["decode_host_ms"] / config.num_layers
    out = {"step_ms": est["step_s"] * 1e3,
           "tokens_per_s": est["tokens_per_s"],
           "breakdown_ms": {k: v * 1e3 for k, v in est["breakdown"].items()
                            if k.endswith("_s")},
           "measured_decode_ms": steps["decode_ms"],
           "measured_host_ms_per_layer": host_layer_ms,
           "planner_host_ms_per_layer":
               planner.HOST_DISPATCH_PER_LAYER_S * 1e3,
           "outside_layers_op_share":
               steps["ops_outside_layers"] / steps["ops"]}
    log(f"  elastic (f) estimate_decode at {SERVE_SLOTS} slots, chunk "
        f"{SERVE_CHUNK}, f32 pool {SERVE_MAX_SEQ} deep: step "
        f"{out['step_ms']:.3f} ms ({out['tokens_per_s']:.0f} tokens/s; "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["breakdown_ms"].items())
        + f" ms) beside the measured {steps['decode_ms']:.3f} ms; the host "
        f"{host_layer_ms:.3f} ms a layer in this run against the planner's "
        f"{out['planner_host_ms_per_layer']:.3f} (the ops outside the "
        f"layers {out['outside_layers_op_share']:.3f} of a step's); {card}")
    return out


def serving_phase(llama, fa, config, snapshot, card):
    """Phase 19: serving on the card, phase 5's trained weights promoted
    through ``ServeEngine.load_from_snapshot``."""
    import torch

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    report = {}
    main_engine = serve_engine(config, snapshot)
    report["prefill_sequence"] = prefill_sequence_check(
        llama, fa, main_engine, config, card)
    torch.cuda.empty_cache()

    jobs = serve_jobs(config.vocab_size)
    done, rows, ex, wall = serve_capture(main_engine, jobs)
    check = apply_check(llama, main_engine.params, config, jobs, done, rows)
    worst, positions = check["exact"], check["positions"]
    if worst > SERVE_LOGIT_LIMIT or check["wrong"]:
        fail(f"continuous batching against apply: {check} (limit "
             f"{SERVE_LOGIT_LIMIT})")
    records = list(done.values())
    ttft, tpot = timing_stats(records)
    ledger = ex.slot_ledger()
    shares = {k: ledger[k] / ledger["slot_seconds"]
              for k in ("decode", "prefill", "admitted_idle", "vacant",
                        "resize_frozen")}
    generated = sum(len(r["tokens"]) for r in records)
    log(f"  (b) against apply: exact {check['exact']:.4f} (rms "
        f"{check['exact_rms']:.2e}), through B1 {check['b1']:.4f}")
    faults = planted_serve_faults(llama, main_engine, config, jobs[:4])
    report["batching"] = {
        "prompt_lengths": [len(p) for _, p, _ in jobs],
        "apply_check": check, "positions": positions,
        "faults": faults, "limit": SERVE_LOGIT_LIMIT,
        "decode_steps": ex.decode_steps, "wall_s": wall,
        "tokens": generated, "tokens_per_s": generated / wall,
        "ttft_ms_median": ttft, "tpot_ms_median": tpot, "ledger": ledger,
        "ledger_shares": shares}
    log(f"  (b) {SERVE_REQUESTS} requests (prompts "
        f"{sorted(len(p) for _, p, _ in jobs)} tokens, {SERVE_NEW} new "
        f"each; {SERVE_SLOTS} slots, f32 pool {SERVE_MAX_SEQ} deep, page "
        f"{SERVE_PAGE}, chunk {SERVE_CHUNK}, window {SERVE_WINDOW}): decode "
        f"logits at {positions} positions within {worst:.4f} of one "
        f"teacher-forced apply's with exact f32 attention (rms "
        f"{check['exact_rms']:.2e}; limit {SERVE_LOGIT_LIMIT}; against "
        f"apply through B1 {check['b1']:.4f}), every token the exact "
        f"apply's argmax where its top-2 margin exceeds the limit; planted "
        + ", ".join(f"'{k}' {v['exact']:.4f} (rms {v['exact_rms']:.2e}, "
                    f"through B1 {v['b1']:.4f})" for k, v in faults.items())
        + f" (beyond it); {ex.decode_steps} decode steps, {generated} tokens "
        f"in {wall:.3f} s ({generated / wall:.0f} tokens/s, prefill "
        f"included); TTFT median {ttft:.1f} ms, TPOT median "
        f"{tpot:.2f} ms; slot ledger shares "
        + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
        + f"; {card}")

    # (c) prefix reuse: 8 requests sharing a SERVE_LEAD-token lead, the
    # pool seeded by one request first
    import numpy as np

    lead = np.random.default_rng(SERVE_SEED + 1).integers(
        0, config.vocab_size, SERVE_LEAD).tolist()
    pjobs = [(rid, p[:SERVE_LEAD + 256], n) for rid, p, n in serve_jobs(
        config.vocab_size, 8, SERVE_SEED + 2, lead)]
    pooled = serve_engine(config, main_engine.params,
                          prefix_pool_pages=128)
    serve_capture(pooled, [("seed", lead + [1] * 64, 1)], capture=False)
    want, _, _, _ = serve_capture(main_engine, pjobs, capture=False)
    plain_cache = main_engine.cache
    got, _, _, _ = serve_capture(pooled, pjobs, capture=False)
    hits = [got[rid]["prefix_hit_tokens"] for rid, _, _ in pjobs]
    for slot, (rid, prompt, _) in enumerate(pjobs):
        rows_n = int(plain_cache["length"][slot])
        if got[rid]["tokens"] != want[rid]["tokens"] or not all(
                torch.equal(pooled.cache[name][:, slot, :rows_n],
                            plain_cache[name][:, slot, :rows_n])
                for name in ("k", "v")):
            fail(f"prefix reuse differs from the pool off on {rid}")
    if hits != [SERVE_LEAD] * len(pjobs):
        fail(f"prefix hits {hits}, expected {SERVE_LEAD} each")
    log(f"  (c) prefix pool on ({pooled.program.spec.prefix_pool_pages} "
        f"pages), {len(pjobs)} requests sharing a {SERVE_LEAD}-token lead: "
        f"hits {hits}, tokens and the admitted slots' pages bit for bit the "
        f"pool off's; pool {pooled.prefix_stats()}")
    report["prefix"] = {"hits": hits, "stats": pooled.prefix_stats()}
    compiles = {"f32": main_engine.compile_count,
                "prefix": pooled.compile_count}
    del pooled, plain_cache
    torch.cuda.empty_cache()

    # (c) speculative decode, f32 and int8 pools; (d) the pools' logits
    sjobs = jobs[:4]
    spec_report, precision = {}, {}
    plain_rows = {}
    for kvp in ("f32", "int8"):
        plain = (main_engine if kvp == "f32"
                 else serve_engine(config, main_engine.params,
                                   kv_precision=kvp))
        ref, plain_rows[kvp], _, _ = serve_capture(plain, sjobs)
        expect = {rid: ref[rid]["tokens"] for rid, _, _ in sjobs}
        if kvp == "f32":
            f32_tokens = expect
        spec_engine = serve_engine(config, main_engine.params,
                                   kv_precision=kvp, spec_draft_len=SPEC_K)
        spec_report[kvp] = spec_legs(spec_engine, sjobs, expect,
                                     config.vocab_size, kvp)
        compiles[f"{kvp} spec"] = spec_engine.compile_count
        if kvp == "f32":
            report["steps"] = serve_step_times(llama, main_engine,
                                               spec_engine, config, card)
        else:
            compiles[kvp] = plain.compile_count
            precision[kvp] = expect
            del plain
        del spec_engine
        torch.cuda.empty_cache()
    report["spec"] = spec_report
    bf16 = serve_engine(config, main_engine.params, kv_precision="bf16")
    done16, plain_rows["bf16"], _, _ = serve_capture(bf16, sjobs)
    precision["bf16"] = {rid: done16[rid]["tokens"] for rid, _, _ in sjobs}
    compiles["bf16"] = bf16.compile_count
    del bf16
    pools = {}
    for kvp in ("bf16", "int8"):
        worst_p, agree = 0.0, 0
        for rid, _, _ in sjobs:
            a, b = precision[kvp][rid], f32_tokens[rid]
            same = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                        len(a))
            # position i's logits share their context while the tokens
            # before it agree
            for i in range(min(same + 1, len(a))):
                worst_p = max(worst_p, (plain_rows[kvp][rid][i].float()
                                        - plain_rows["f32"][rid][i].float()
                                        ).abs().max().item())
                agree += 1
        pools[kvp] = {"max_abs_logit_diff": worst_p, "positions": agree}
    if pools["int8"]["max_abs_logit_diff"] >= INT8_LOGIT_LIMIT:
        fail(f"the int8 pool's logits stray {pools['int8']} from the f32 "
             f"pool's (limit {INT8_LOGIT_LIMIT})")
    log(f"  (d) pools on {len(sjobs)} requests, logits against the f32 "
        f"pool's where the context agrees: bf16 "
        f"{pools['bf16']['max_abs_logit_diff']:.4f} over "
        f"{pools['bf16']['positions']} positions, int8 "
        f"{pools['int8']['max_abs_logit_diff']:.4f} over "
        f"{pools['int8']['positions']} (limit {INT8_LOGIT_LIMIT})")
    report["pools"] = pools
    if set(compiles.values()) != {1}:
        fail(f"serve programs built more than once: {compiles}")
    report["compile_count"] = compiles
    report["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    report["wall_s"] = time.monotonic() - t_phase
    log(f"  (e) no host sync in decode_step, verify_step, prefill_chunk; "
        f"compile_count 1 on every engine {compiles}; peak memory "
        f"{report['peak_memory_bytes'] / 2**30:.2f} GiB; B1 serving launches "
        f"{report['prefill_sequence']['b1_launches']}; phase 19 "
        f"{report['wall_s']:.1f} s wall; {card}")

    # elastic serving on the same engine, after the checks above
    report["retune"] = retune_leg(llama, main_engine, config, jobs, done,
                                  card)
    main_engine.retune(prefill_chunk=SERVE_CHUNK, slot_map={})
    report["resize"] = resize_leg(main_engine, jobs, done, card)
    report["estimate"] = decode_estimate_line(config, report["steps"], card)
    report["wall_s"] = time.monotonic() - t_phase
    log(f"  phase 19 with the elastic legs {report['wall_s']:.1f} s wall")
    del main_engine
    return report


def train_and_serve(llama, fa, remat, card, report):
    """Phase 5, the dense main path, then phase 19 on its trained
    weights; returns phase 5's config."""
    import torch

    log(f"main path: llama3_8b x{LAYERS} layers, batch 1, seq {SEQ}, "
        f"{STEPS} steps:")
    config = llama.llama3_8b(num_layers=LAYERS, max_seq_len=SEQ)
    recompute = 1 if remat.remat_enabled(config.remat_policy) else 0
    flash_expected = {"flash_fwd": STEPS * LAYERS * (1 + recompute),
                      "flash_bwd_dkv": STEPS * LAYERS,
                      "flash_bwd_dq": STEPS * LAYERS, **NO_SEG, **NO_PFX}
    report["train"] = train_main_path(
        llama, config, f"llama3_8b(num_layers={LAYERS}, max_seq_len={SEQ})",
        "llama", (fa,), flash_expected, card, keep_params=True)
    torch.cuda.empty_cache()

    log(f"phase 19, serving (phase 5's trained weights promoted through "
        f"ServeEngine.load_from_snapshot; {card}):")
    report["serving"] = serving_phase(
        llama, fa, config, report["train"].pop("params_snapshot"), card)
    free_memory()
    return config


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", default="",
                        help="also write the run's measurements here")
    parser.add_argument("--against", default="", metavar="DIR",
                        help="only hold the flash and grouped kernels "
                             "against another tree's under DIR (see "
                             "against())")
    parser.add_argument("--may-differ", nargs="*", default=[],
                        metavar="PART", help="with --against: kernels "
                        "whose mangled name holds PART may change SASS, or "
                        "be in one tree only")
    parser.add_argument("--variant", action="store_true",
                        help="with --against: DIR is a variant made by hand "
                             "(a stage compiled out); outputs that differ "
                             "are reported, not failed")
    parser.add_argument("--stress", type=int, default=0, metavar="N",
                        help="with --against: also N calls of both trees' "
                             "B6 and B4-f32 on each of phase 10's layouts, "
                             "each held bit for bit (against_stress)")
    parser.add_argument("--only-serving", action="store_true",
                        help="only build the kernels and run phase 5, "
                             "then phase 19 (serving and its elastic "
                             "legs) on its trained weights")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, ROOT)
    try:
        from dlrover_tpu_torch.models import glm, llama
        from dlrover_tpu_torch.ops import flash_attention as fa
        from dlrover_tpu_torch.ops import grouped_matmul as gm
        from dlrover_tpu_torch.ops import kernel_build, moe, quantize, remat
        from dlrover_tpu_torch.trainer.run import run_local
    except ImportError as e:
        fail(f"the dlrover_tpu_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.against:
        report = against(args.against, args.may_differ, args.variant,
                         args.stress)
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                        exist_ok=True)
            with open(args.json, "w") as out:
                json.dump(report, out, indent=1)
        print(json.dumps({"ok": True, "against": report["other"]}),
              flush=True)
        return
    report = {}

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    report["card"] = card

    t0 = time.monotonic()
    build_s = kernel_build.build()
    log(f"kernel build: {time.monotonic() - t0:.1f} s wall "
        + ", ".join(f"{n} {s:.1f} s" for n, s in build_s.items()))
    for name in kernel_build.SOURCES:
        logfile = kernel_build.library_path(name).with_suffix(".log")
        for line in logfile.read_text().splitlines():
            # C7515/C7518: ptxas serialized the kernel's wgmma
            if any(key in line for key in ("registers", "spill", "C75")):
                log(f"  ptxas {name}: {line.strip()}")
    report["build_s"] = build_s
    if args.only_serving:
        train_and_serve(llama, fa, remat, card, report)
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                        exist_ok=True)
            with open(args.json, "w") as out:
                json.dump(report, out, indent=1, default=str)
        print(json.dumps({"ok": True, "only": "serving"}), flush=True)
        return

    log("kernel vs plain:")
    errs, inputs, right = check_kernels(fa, 1, 32, 8, SEQ, 128,
                                        torch.bfloat16, True, 0, 1e-3)
    log("the same check against planted faults, same inputs:")
    report["planted_faults"] = check_planted_faults(inputs, right)
    del inputs, right
    for causal in (True, False):
        check_kernels(fa, 2, 4, 2, 1000, 64, torch.float32, causal, 1, 1e-4)
    check_kernels(fa, 1, 4, 1, 1000, 128, torch.bfloat16, True, 2, 1e-3)
    # the edges of B1's bf16 tiles: 64-wide head tile, a head dim padded
    # to 128, a ragged q tile beside a head boundary, cross attention, one
    # row past a tile
    check_kernels(fa, 1, 4, 2, 1000, 64, torch.bfloat16, False, 3, 1e-3)
    check_kernels(fa, 1, 4, 2, 1000, 80, torch.bfloat16, True, 4, 1e-3)
    check_kernels(fa, 2, 8, 2, 1000, 128, torch.bfloat16, True, 5, 1e-3)
    check_kernels(fa, 1, 4, 2, 300, 128, torch.bfloat16, False, 6, 1e-3,
                  sk=1000)
    check_kernels(fa, 1, 4, 2, 129, 128, torch.bfloat16, True, 7, 1e-3)
    # head dims below the 64-wide tile (the tiny preset's 16), zero-filled
    # past D
    check_kernels(fa, 1, 4, 2, 1000, 16, torch.bfloat16, True, 8, 1e-3)
    check_kernels(fa, 1, 4, 2, 1000, 32, torch.bfloat16, False, 9, 1e-3)
    check_kernels(fa, 2, 4, 2, 300, 48, torch.bfloat16, True, 10, 1e-3)
    # B2's edges: group 1 (the MoE cell's heads), group 8, and batch 2 on
    # the 64-wide head tile without the causal mask
    check_kernels(fa, 1, 4, 4, 1000, 128, torch.bfloat16, True, 12, 1e-3)
    check_kernels(fa, 1, 8, 1, 1000, 128, torch.bfloat16, True, 13, 1e-3)
    check_kernels(fa, 2, 4, 2, 1000, 64, torch.bfloat16, False, 14, 1e-3)
    # B3's edge: a q tile shorter than one warpgroup's 64 rows (the
    # second warpgroup has none)
    check_kernels(fa, 1, 4, 2, 40, 128, torch.bfloat16, True, 19, 1e-3)
    # the MoE path's own shapes (group 1 at 32/32 heads): one card's
    # sequence, and an expert-parallel rank's
    check_kernels(fa, 1, 32, 32, SEQ, 128, torch.bfloat16, True, 15, 1e-3)
    torch.cuda.empty_cache()
    check_kernels(fa, 1, 32, 32, EP_TOKENS, 128, torch.bfloat16, True, 16,
                  1e-3)
    # the bias of sound kernels grows with the terms each output sums:
    # read it at group 4 (the main shape's) past the main sequence
    for seq, seed in ((2 * SEQ, 17), (4 * SEQ, 18)):
        check_kernels(fa, 1, 4, 1, seq, 128, torch.bfloat16, True, seed,
                      1e-3)
        torch.cuda.empty_cache()

    log(f"kernel times (bf16, B=1 H=32/8 S={SEQ} D=128, causal; {card}):")
    times, sdpa = kernel_times(fa, 1, 32, 8, SEQ, 128)
    report["kernel_times"], report["sdpa"] = times, sdpa
    torch.cuda.empty_cache()
    log(f"kernel times at the MoE cell's heads (bf16, B=1 H=32/32 "
        f"S={SEQ} D=128, causal; {card}):")
    report["kernel_times_moe_heads"], report["sdpa_moe_heads"] = \
        kernel_times(fa, 1, 32, 32, SEQ, 128)
    torch.cuda.empty_cache()

    config = train_and_serve(llama, fa, remat, card, report)

    log("full-width cross-check (use_flash True vs False):")
    report["cross_check"] = cross_check(
        llama, config, (("flash", {"use_flash": True}),
                        ("reference", {"use_flash": False})), (fa,),
        None, GRAD_GAP_LIMIT)
    torch.cuda.empty_cache()
    log(f"FSDP wire variants at full width (fsdp_precision fp8, "
        f"fp8_qdq, bf16; {card}):")
    report["wire_variants"] = wire_variants(llama, config, fa, remat, card)
    log(f"full-width loss check against an exact attention ({card}):")
    report["loss_check"] = loss_check(llama, config, fa, loss_controls(fa))
    torch.cuda.empty_cache()

    moe_config = llama.llama2_7b(
        num_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K, moe_dispatch="grouped",
        num_layers=MOE_LAYERS, max_seq_len=SEQ)
    d, f = moe_config.hidden_size, moe_config.intermediate_size
    log(f"grouped-matmul kernels vs plain (llama2_7b+moe8 widths: {SEQ} "
        f"tokens routed top-{MOE_TOP_K} over {MOE_EXPERTS} experts, "
        f"D={d}, F={f}, block_t={BLOCK_T}):")
    x, w, dy, lay = grouped_inputs(moe, SEQ, d, f, MOE_EXPERTS, 0)
    tiles, real = group_sizes(lay, SEQ, MOE_EXPERTS)
    log(f"  main: {lay.rows} rows ({SEQ * MOE_TOP_K} real); tiles per "
        f"expert {tiles}, real rows per expert {real}")
    g_errs, g_right = check_grouped(gm, x, w, dy, lay, "main")
    log("the same check against planted faults, same inputs:")
    report["grouped_planted_faults"] = check_grouped_faults(x, w, dy, lay,
                                                            g_right)
    del g_right
    torch.cuda.empty_cache()
    log(f"grouped-matmul kernel times (bf16, {lay.rows} rows of which "
        f"{SEQ * MOE_TOP_K} real, D={d}, F={f}, E={MOE_EXPERTS}; {card}):")
    log("  up projection (x [rows, D] @ w [E, D, F]):")
    g_times = grouped_times(gm, x, w, dy, lay)
    del w
    torch.cuda.empty_cache()
    # the down projection: h [rows, F] @ w [E, F, D], so y reads w
    # K-major in K = F, and dx and dw swap the roles of the two widths
    w_down = (torch.randn((MOE_EXPERTS, f, d), device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(5)) * f ** -0.5).to(torch.bfloat16)
    log("  down projection (h [rows, F] @ w [E, F, D]):")
    g_times_down = grouped_times(gm, dy, w_down, x, lay)
    report["grouped_kernel_times"] = {"up": g_times, "down": g_times_down}
    report["grouped_main_groups"] = {"tiles": tiles, "real_rows": real,
                                     "rows": lay.rows}
    del x, w_down, dy, lay
    torch.cuda.empty_cache()
    # skewed: expert 0 wins most first choices and expert 3 is never
    # chosen, so it owns only its sentinel tile (the last expert also
    # owns the trailing pad tiles)
    skew = [3.0] + [0.0] * (MOE_EXPERTS - 1)
    skew[3] = -30.0
    x, w, dy, lay = grouped_inputs(moe, SEQ, d, f, MOE_EXPERTS, 1, bias=skew)
    tiles, real = group_sizes(lay, SEQ, MOE_EXPERTS)
    log(f"  skewed: tiles per expert {tiles}, real rows per expert {real}")
    if real[3] != 0 or tiles[3] != 1 or max(real) != real[0]:
        fail(f"the skewed routing is not skewed: {tiles}, {real}")
    check_grouped(gm, x, w, dy, lay, "skewed")
    del x, w, dy, lay
    x, w, dy, lay = grouped_inputs(moe, 300, 96, 200, 4, 2,
                                   dtype=torch.float32)
    check_grouped(gm, x, w, dy, lay, "ragged f32 (300 tokens, D=96, F=200, "
                  "E=4)")
    del x, w, dy, lay
    check_no_host_sync(moe, d, f, MOE_EXPERTS)
    torch.cuda.empty_cache()

    moe_label = (f"llama2_7b(num_experts={MOE_EXPERTS}, moe_top_k="
                 f"{MOE_TOP_K}, moe_dispatch='grouped', num_layers="
                 f"{MOE_LAYERS}, max_seq_len={SEQ})")
    log(f"MoE main path: {moe_label}, batch 1, seq {SEQ}, {STEPS} steps:")
    recompute = 1 if remat.remat_enabled(moe_config.remat_policy) else 0
    # per layer and step: B4 runs the up and down products forward, again
    # in the backward's recompute, and once more each for dx; B5 once each
    moe_expected = {
        "flash_fwd": STEPS * MOE_LAYERS * (1 + recompute),
        "flash_bwd_dkv": STEPS * MOE_LAYERS,
        "flash_bwd_dq": STEPS * MOE_LAYERS, **NO_SEG, **NO_PFX,
        "grouped_matmul_fwd": STEPS * MOE_LAYERS * (2 * (1 + recompute) + 2),
        "grouped_matmul_dw": STEPS * MOE_LAYERS * 2,
        "grouped_matmul_fwd_quant": 0,  # the expert-parallel fp8 wire's
    }
    # the reference's 6N counts every expert; a token runs MOE_TOP_K
    idle = MOE_LAYERS * (MOE_EXPERTS - MOE_TOP_K) * 2 * d * f
    active_fpt = llama.flops_per_token(moe_config) - 6.0 * idle
    report["train_moe"] = train_main_path(
        llama, moe_config, moe_label, "moe", (fa, gm), moe_expected, card,
        active_fpt)
    torch.cuda.empty_cache()

    log("full-width cross-check (moe_dispatch grouped vs gather, "
        "moe_capacity_factor=4.0: capacity = T, nothing drops):")
    report["cross_check_moe"] = cross_check(
        llama, dataclasses.replace(moe_config, moe_capacity_factor=4.0),
        (("grouped", {"moe_dispatch": "grouped"}),
         ("gather", {"moe_dispatch": "gather"})), (gm,),
        MOE_LOSS_GAP_LIMIT, MOE_GRAD_GAP_LIMIT)

    torch.cuda.empty_cache()

    el = MOE_EXPERTS // EP_RANKS
    log(f"B6 vs plain (what rank 0 of {EP_RANKS} receives: {EP_RANKS} x "
        f"{EP_TOKENS} tokens routed top-{MOE_TOP_K} over {MOE_EXPERTS} "
        f"experts, its {el} local experts' rows quantized to e4m3 with f32 "
        f"scales per 32 channels, D={d}, F={f}):")
    v, s, w, rl, real = ep_received_rows(moe, quantize, d, f, 0)
    tiles = torch.bincount(rl.tile_expert.long(), minlength=el).tolist()
    log(f"  main: {rl.rows} rows ({sum(real)} real, live_rows "
        f"{rl.live_rows.item()}); tiles per local expert {tiles}, real rows "
        f"per local expert {real}")
    q_err, q_right = check_quant(gm, quantize, v, s, w, rl, "main")
    log("the same check against planted faults, same inputs:")
    report["quant_planted_faults"] = check_quant_faults(v, s, w, rl,
                                                        q_right)
    del q_right
    torch.cuda.empty_cache()
    stress_runs = {
        "B6": lambda v, s, xd, w, te, lr: gm.grouped_matmul_fwd_quant(
            v, s, w, te, BLOCK_T, lr),
        "B4 f32": lambda v, s, xd, w, te, lr: gm.grouped_matmul_fwd(
            xd, w, te, BLOCK_T, live_rows=lr)}
    report["stress"] = {"main": stress_layout(stress_runs, "main", v, s, w,
                                              rl, STRESS_CALLS)}
    torch.cuda.empty_cache()
    log(f"B6 and the f32 forms of B4 and B5 on that layout ({rl.rows} rows "
        f"of which {sum(real)} real, live_rows {rl.live_rows.item()}, D={d}, "
        f"F={f}, {el} local experts; {card}):")
    q_times = quant_times(gm, quantize, v, s, w, rl)
    report["quant_kernel_times"] = q_times
    f32_forms = ep_f32_forms(gm, quantize, v, s, w, rl)
    report["f32_forms"] = f32_forms
    dw_forms = ep_dw_forms(gm, quantize, v, s, rl, f)
    report["dw_f32_forms"] = dw_forms
    report["quant_main_groups"] = {"tiles": tiles, "real_rows": real,
                                   "rows": rl.rows}
    del v, s, w, rl
    torch.cuda.empty_cache()
    # skewed: local expert 1 wins most first choices and local expert 0
    # is never chosen, so it owns only its sentinel tile (the last local
    # expert also owns the trailing pad tiles)
    skew = [-30.0, 3.0] + [0.0] * (MOE_EXPERTS - 2)
    v, s, w, rl, real = ep_received_rows(moe, quantize, d, f, 1, bias=skew)
    tiles = torch.bincount(rl.tile_expert.long(), minlength=el).tolist()
    log(f"  skewed: tiles per local expert {tiles}, real rows per local "
        f"expert {real}")
    if real[0] != 0 or tiles[0] != 1:
        fail(f"the skewed routing is not skewed: {tiles}, {real}")
    check_quant(gm, quantize, v, s, w, rl, "skewed")
    report["stress"]["skewed"] = stress_layout(stress_runs, "skewed", v, s,
                                               w, rl, STRESS_CALLS)
    del v, s, w, rl
    v, s, w, rl, _ = ep_received_rows(moe, quantize, 200, 96, 2, tokens=75)
    check_quant(gm, quantize, v, s, w, rl, "ragged (75 tokens per source, "
                "D=200: 25-channel scale blocks, F=96)")
    report["stress"]["ragged"] = stress_layout(stress_runs, "ragged", v, s,
                                               w, rl, STRESS_CALLS)
    del v, s, w, rl
    torch.cuda.empty_cache()

    report.update(ep_phases(run_local, llama, moe_config, card))
    torch.cuda.empty_cache()

    packed, seg_errs, seg_times = packed_phases(llama, fa, remat, config,
                                                card)
    report.update(packed)
    torch.cuda.empty_cache()

    glm_report, pfx_errs, pfx_times = glm_phases(glm, fa, remat, card)
    report.update(glm_report)
    torch.cuda.empty_cache()

    log(f"phase 15, checkpoint and restore (torch.distributed.checkpoint; "
        f"{card}):")
    report["checkpoint"] = checkpoint_phase(llama, config, moe_config, card)
    free_memory()

    log(f"phase 16, in-process recovery (live_reshard, retune; {card}):")
    report["recovery"] = recovery_phase(run_local, llama, config,
                                        moe_config, card)
    free_memory()

    log(f"phase 17, attribution (counted FLOPs, live MFU, the trace; "
        f"{card}):")
    report["attribution"] = attribution_phase(llama, fa, remat, config, card)
    free_memory()

    log(f"phase 18, FSDP ((data x fsdp) meshes, all-gather and "
        f"reduce-scatter) and the ring over (1, 1, 2); {card}):")
    report["fsdp"] = fsdp_phase(run_local, llama, report["ep_train"], card)
    free_memory()

    kernels = []
    for name in FLASH_KERNELS:
        meta, t = fa.KERNELS[name], times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": report["train"]["launches"][name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "verdict": "ok",
        })
        if name == "flash_fwd":
            # phase 19's prefill_sequence (one launch a layer)
            kernels[-1]["serving_launches"] = (
                report["serving"]["prefill_sequence"]["b1_launches"])
        kernels[-1]["design"] = {"flash_fwd": B1_DESIGN,
                                 "flash_bwd_dkv": B2_DESIGN,
                                 "flash_bwd_dq": B3_DESIGN}[name]
    for name, meta in gm.KERNELS.items():
        # B4 and B5 are timed at the up projection; the up projection's
        # dx and the down projection's calls are reported beside it
        t = (q_times if name == "grouped_matmul_fwd_quant" else
             g_times["y" if name == "grouped_matmul_fwd" else "dw"])
        # B6 runs on the expert-parallel main path: rank 0's launches
        # there (every rank's equal the expected count)
        launches = (report["ep_train"]["ranks"][0]["launches"][name]
                    if name == "grouped_matmul_fwd_quant"
                    else report["train_moe"]["launches"][name])
        entry = {
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": launches,
            "max_abs_err": (q_err if name == "grouped_matmul_fwd_quant"
                            else g_errs[name]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "verdict": "ok",
        }
        if name == "grouped_matmul_fwd":
            # the up projection's dx and the down projection's y and dx
            for key, tm in (("dx", g_times["dx"]),
                            ("down_y", g_times_down["y"]),
                            ("down_dx", g_times_down["dx"])):
                entry.update({f"{key}_ms": tm["ms"],
                              f"{key}_plain_ms": tm["plain_ms"],
                              f"{key}_bound_ms": tm["bound_ms"],
                              f"{key}_library_ms": tm["library_ms"]})
            entry["design"] = f"{B4_DESIGN}; {F32_DESIGN}"
        if name == "grouped_matmul_dw":
            tm = g_times_down["dw"]
            entry.update({"down_ms": tm["ms"],
                          "down_plain_ms": tm["plain_ms"],
                          "down_bound_ms": tm["bound_ms"],
                          "down_library_ms": tm["library_ms"],
                          "design": f"{B5_DESIGN}; {B5_F32_DESIGN}"})
        if name in ("grouped_matmul_fwd", "grouped_matmul_dw"):
            # the f32 forms at the expert-parallel rank (launched on that
            # path: its launches are counted under this name there)
            forms = f32_forms if name == "grouped_matmul_fwd" else dw_forms
            entry["f32_ep"] = {
                form: {key: tm[key] for key in (
                    "ms", "device_ms", "all_rows_ms", "all_rows_device_ms",
                    "plain_ms", "loop_ms", "loop_live_ms", "bounds",
                    "share", "all_rows_share", "f64", "live_rows", "rows",
                    "clocks")}
                for form, tm in forms.items()}
            entry["f32_ep_launches"] = (
                report["ep_train"]["ranks"][0]["launches"][name])
        if name == "grouped_matmul_fwd_quant":
            entry["design"] = (f"B4's f32 loop, its A tile dequantized by "
                               f"the consumers one stage ahead; "
                               f"{F32_DESIGN}")
            entry.update({key: t[key] for key in (
                "all_rows_ms", "all_rows_device_ms", "loop_ms",
                "loop_live_ms", "bounds", "share",
                "all_rows_share", "f64", "live_rows", "rows", "clocks")})
        kernels.append(entry)
    for name in FLASH_KERNELS:
        seg, t = f"{name}_seg", seg_times[name]
        kernels.append({
            "name": seg, "route": "cuda", "source": fa.KERNELS[seg]["source"],
            "replaces": fa.KERNELS[seg]["replaces"],
            "launches": report["train_packed"]["launches"][seg],
            "max_abs_err": seg_errs[seg], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "verdict": "ok", "bound_causal_ms": t["bound_causal_ms"],
            "unsegmented_ms": t["unsegmented_ms"],
            "given_table_ms": t["given_table"]["ms"],
            "given_table_device_ms": t["given_table"]["device_ms"],
            "varlen_ms": t["varlen_ms"], "design": SEG_DESIGN[seg],
        })
    for name in FLASH_KERNELS:
        pfx, t = f"{name}_pfx", pfx_times[name]
        kernels.append({
            "name": pfx, "route": "cuda", "source": fa.KERNELS[pfx]["source"],
            "replaces": fa.KERNELS[pfx]["replaces"],
            "launches": report["train_glm"]["launches"][pfx],
            "max_abs_err": pfx_errs[pfx], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "verdict": "ok", "unprefixed_ms": t["unprefixed_ms"],
            "flex_ms": t["flex_ms"], "flex_device_ms": t["flex_device_ms"],
            "design": PFX_DESIGN[pfx],
        })
    report["kernels"] = kernels
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as out:
            json.dump(report, out, indent=1, default=str)
    report["wall_s"] = time.monotonic() - START
    log(f"whole script: {report['wall_s']:.1f} s (the kernels' build "
        f"included); card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
