#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]   # from the root of a checkout

Phases, each of which fails the run (exit code 1) when it goes wrong:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every kernel from dlrover_tpu_torch/csrc with nvcc, one
     process per source, all at once;
  3. hold each flash kernel (B1 forward, B2 dK/dV, B3 dQ) against its
     plain PyTorch version on the card: at the main path's shape (bf16,
     causal GQA 32/8, S=4096, D=128) and on ragged f32 and bf16 GQA
     cases; and show that the same rule rejects outputs with planted
     faults;
  4. time each flash kernel, its plain version and PyTorch's
     scaled_dot_product_attention (a yardstick the port never calls),
     beside the least time the card could take;
  5. train Llama-3-8B at full width (4 layers, batch 1, seq 4096) for a
     few steps through TrainExecutor + ElasticTrainer with the flash
     kernels and the default dispatch window, counting their launches;
     then profile a few more steps;
  6. one forward and backward of the same model with use_flash=True
     against the reference attention (use_flash=False): the loss and
     every gradient;
  7. the grouped-matmul kernels (B4 forward and dX, B5 dW) against their
     plain versions at the MoE path's shape (llama2_7b+moe8: 4096 tokens
     routed top-2 over 8 experts, D=4096, F=11008), on a skewed routing
     and on a ragged f32 case; the planted faults an expert boundary
     invites; one MoE layer's forward and backward with host syncs
     forbidden; the kernels' times beside their bound, their plain
     versions and torch._grouped_mm (a yardstick the port never calls);
  8. train llama2_7b with 8 experts (top-2, dropless grouped dispatch)
     at full width (2 layers, batch 1, seq 4096) for a few steps the
     same way, counting the launches of all five kernels; profile;
  9. one forward and backward of that model, grouped dispatch against
     the capacity "gather" dispatch at a capacity nothing overflows.

The line before the last is a JSON object listing each kernel; the last
is {"ok": true, "device": {...}}. ``--json PATH`` also writes every
number the run measured to PATH.
Needs one GPU; exits non-zero without one, or without the repository.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
STEPS = 10
LAYERS = 4
SEQ = 4096
MOE_LAYERS = 2  # llama2_7b+moe8 at 2 layers: 1.84 B params, ~30 GB of state
MOE_EXPERTS, MOE_TOP_K, BLOCK_T = 8, 2, 128


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


def time_ms(fn, iters=10, warmup=2):
    """Median milliseconds of ``fn`` over ``iters`` calls, each between
    two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(b, h, hkv, s, d, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    return rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
        rnd(b, h, s, d)


def check_kernels(fa, b, h, hkv, s, d, dtype, causal, seed, tol):
    """Run each kernel and its plain version on the same inputs; return
    ({kernel: max abs error}, the inputs and the plain results). A bf16
    output is held row by row (``flash_check.rows_close``: each row's
    error within 1% of its norm, plus 0.1% of the tensor's RMS row
    norm); an f32 output (every output of an f32 case, and lse) to
    ``tol`` absolute."""
    import torch

    from dlrover_tpu_torch.ops import flash_check

    q, k, v, do = attention_inputs(b, h, hkv, s, d, dtype, seed)
    scale = 1.0 / math.sqrt(d)
    out_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = (do.float() * out_ref.float()).sum(-1).contiguous()
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta,
                                            causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal, scale)
    dq_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal,
                                   scale)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal, scale)
    torch.cuda.synchronize()
    errs = {}
    label = f"{dtype} B={b} H={h}/{hkv} S={s} D={d} causal={causal}"
    for kernel, name, got, ref in (
        ("flash_fwd", "out", out, out_ref),
        ("flash_fwd", "lse", lse, lse_ref),
        ("flash_bwd_dkv", "dk", dk, dk_ref),
        ("flash_bwd_dkv", "dv", dv, dv_ref),
        ("flash_bwd_dq", "dq", dq, dq_ref),
    ):
        if got.dtype == torch.bfloat16:
            e = flash_check.row_errors(got, ref)
            err, ok = e["max_abs_err"], flash_check.rows_close(got, ref)
            detail = (f"worst row {e['worst_row']:.3f} of its limit, "
                      f"norm ratio {e['norm_ratio']:.3e}")
        else:
            err = (got.float() - ref.float()).abs().max().item()
            ok = math.isfinite(err) and err <= tol
            detail = f"limit {tol:.0e}"
        log(f"  {label} {name}: max_abs_err={err:.3e} ({detail}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{kernel} disagrees with its plain version on {name} "
                 f"({label})")
        errs[kernel] = max(errs.get(kernel, 0.0), err)
    right = {"out": out_ref, "dk": dk_ref, "dv": dv_ref, "dq": dq_ref}
    return errs, (q, k, v, do, lse_ref, delta, scale), right


def check_planted_faults(inputs, right):
    """The rule that passed the kernels must reject what a kernel with
    a planted fault would return (``flash_check.planted_faults``), on
    the same inputs. Also says whether the looser rule it replaced (max
    error within 2e-2 of the largest value) would have caught each."""
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
    return results


def kernel_times(fa, b, h, hkv, s, d):
    """Per kernel: its time, its plain version's, the library's and the
    least time the card could take, at the main path's shape."""
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
    del lib_out
    results = {}
    for name, (flops, nbytes) in work.items():
        kernel_ms = time_ms(lambda: calls[name](fa.WRAPPERS[name]))
        plain_ms = time_ms(lambda: calls[name](fa.PLAIN[name]), iters=5,
                           warmup=1)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        results[name] = {
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd,
            "gflop": flops / 1e9,
            "tflops_achieved": flops / kernel_ms / 1e9,
        }
        r = results[name]
        log(f"  {name}: {kernel_ms:.3f} ms ({r['tflops_achieved']:.1f} "
            f"TFLOP/s), plain {plain_ms:.3f} ms, library "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}, {flops / 1e9:.1f} GFLOP)")
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
    row rule (``flash_check.rows_close``); f32 inputs: within
    ``f32_tol`` absolute plus ``f32_tol`` relative, element by element."""
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
            err, ok = es["max_abs_err"], flash_check.rows_close(g, r)
            detail = (f"worst row {es['worst_row']:.3f} of its limit, "
                      f"norm ratio {es['norm_ratio']:.3e}")
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
    """The rule that passed B4 and B5 must reject what they would return
    with a fault at an expert boundary (``grouped_check``)."""
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
    return results


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
    """B4 (y, dx) and B5 at the main path's shape: kernel, plain and
    library times beside the least time the card could take. The library
    yardstick is torch._grouped_mm over the groups' row offsets, where
    this torch has it; the port never calls it."""
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
        plain_ms = time_ms(lambda: calls[name](plain[name]), iters=5,
                           warmup=1)
        ref = calls[name](plain[name])
        lib_ms, lib_call = None, "no single call"
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
            "loop_ms": loop_ms, "gflop": fl / 1e9, "bytes": nbytes,
            "tflops_achieved": fl / kernel_ms / 1e9,
        }
        r = results[name]
        log(f"  {name} ({kernel}): {kernel_ms:.3f} ms "
            f"({r['tflops_achieved']:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
            f"library {lib_call}"
            + (f" {lib_ms:.3f} ms" if lib_ms is not None else
               f" (per-expert matmul loop {loop_ms:.3f} ms)")
            + f", bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
            f"{fl / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB)")
    return results


def train_main_path(llama, config, label, rule_set, kernels, expected,
                    card, active_fpt=None):
    """Drive TrainExecutor + ElasticTrainer on ``config`` for STEPS
    steps. ``kernels``: the wrapper modules whose launch counters the
    run resets just before and reads just after; their counts must equal
    ``expected``. ``active_fpt``: the FLOPs per token the tokens really
    cost, where the reference's formula counts more (MoE)."""
    import torch

    from dlrover_tpu_torch.common.config import get_context
    from dlrover_tpu_torch.examples.train_llama import (
        adamw,
        synthetic_batches,
    )
    from dlrover_tpu_torch.parallel.mesh import single_device_plan
    from dlrover_tpu_torch.parallel.strategy import Strategy
    from dlrover_tpu_torch.trainer.conf import build_configuration
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
    from dlrover_tpu_torch.trainer.executor import TrainExecutor, TrainHook

    if not config.use_flash:
        fail("the main path must run with use_flash=True")

    class Record(TrainHook):
        """A CUDA event before each step's dispatch and one at the end:
        an event fires when the device has finished every step before
        it, so two events bound one step on the device's clock however
        far the dispatch window lets the host run ahead. The metrics
        reach the host later, as the window hands them over."""

        def __init__(self):
            self.events, self.metrics = [], {}

        def _mark(self):
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()

        def before_step(self, step):
            self._mark()

        def after_step(self, step, metrics):
            self.metrics[step] = metrics

        def end(self, executor):
            self._mark()

    record = Record()
    batches = synthetic_batches(config.vocab_size, 1, SEQ)
    trainer = ElasticTrainer(
        llama.make_init_fn(config), llama.make_loss_fn(config), adamw(),
        next(batches()),
        strategy=Strategy(mesh=single_device_plan(), rule_set=rule_set),
        device="cuda",
    )
    window = get_context().train_window  # the default, as users run it
    executor = TrainExecutor(
        trainer, train_iter_fn=batches, hooks=[record],
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
    profile = profile_steps(trainer, executor.state, next(batches()))
    summary = {
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
    }
    del executor, trainer
    return summary


KERNEL_GROUPS = (  # (group, substrings of a CUDA kernel's name)
    ("flash attention (B1-B3)", ("flash_fwd", "flash_bwd")),
    ("grouped matmul (B4-B5)", ("grouped_fwd", "grouped_dw")),
    ("matmul", ("gemm", "xmma", "cutlass", "matmul", "sm90_", "nvjet")),
    ("optimizer", ("multi_tensor", "adam")),
    ("softmax / loss", ("softmax", "nll", "log_softmax", "logsumexp")),
)


def profile_steps(trainer, state, batch, n=3):
    """``n`` more training steps dispatched back to back (as the
    dispatch window lets them run), once under torch.profiler and once
    without: device time by kernel group, and the device's idle share
    of the profiled steps' own span (CUDA events around all ``n``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    groups, top, host = {}, [], []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            host.append((evt.self_cpu_time_total / 1e3 / n, evt.count / n,
                         evt.key))
            continue
        # kernels only: a user annotation (e.g. the optimizer's
        # record_function range) spans kernels already counted
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or "#" in evt.key):
            continue
        us = getattr(evt, "device_time_total", 0) or 0
        name = evt.key
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name.lower() for k in keys)),
                     "other elementwise / copies")
        groups[group] = groups.get(group, 0.0) + us / 1e3 / n
        top.append((us / 1e3 / n, evt.count / n, name))
    busy = sum(groups.values())
    step_ms, plain_step_ms = span_ms / n, plain_ms / n
    if busy == 0.0:
        log("  profile: the profiler recorded no device time "
            "(not measured)")
        return {"device_ms": None, "step_ms": step_ms,
                "unprofiled_step_ms": plain_step_ms}
    idle = 1 - busy / step_ms
    log(f"  profile of {n} more steps: device busy {busy:.1f} ms per step "
        f"of {step_ms:.1f} ms under the profiler (idle share {idle:.4f}); "
        f"the same {n} steps without it: {plain_step_ms:.1f} ms per step "
        f"(idle share against it {1 - busy / plain_step_ms:.4f})")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {group}: {ms:.1f} ms ({ms / busy:.3f})")
    top.sort(reverse=True)
    for ms, count, name in top[:12]:
        log(f"    top kernel {ms:.2f} ms x{count:g}: {name[:90]}")
    gaps = device_gaps(prof, n)
    # the host's side: self time per step of each op and runtime call
    # (under the profiler, which adds its own cost to each)
    host.sort(reverse=True)
    log(f"    host self time per step, all ops: "
        f"{sum(ms for ms, _, _ in host):.1f} ms")
    for ms, count, name in host[:12]:
        log(f"    top host op {ms:.2f} ms x{count:g}: {name[:90]}")
    return {"device_ms": busy, "step_ms": step_ms,
            "unprofiled_step_ms": plain_step_ms, "idle_share": idle,
            "groups_ms": groups,
            "top": [(ms, count, name[:200]) for ms, count, name in top[:15]],
            "host_top": [(ms, count, name[:200])
                         for ms, count, name in host[:15]],
            "gaps": gaps}


GAP_CLASSES = ((0.02, "under 20 us"), (1.0, "20 us to 1 ms"),
               (float("inf"), "over 1 ms"))


def device_gaps(prof, n):
    """Where the device waits between its own operations in the profiled
    steps: the gaps between one kernel's end and the next one's start,
    summed per step by size, and the largest with their neighbours."""
    import torch

    spans = sorted(
        (e.time_range.start / 1e3, e.time_range.end / 1e3, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False) and "#" not in e.name)
    if not spans:
        return {}
    by_class = {label: [0, 0.0] for _, label in GAP_CLASSES}
    largest = []
    end, prev = spans[0][1], spans[0][2]
    for start, stop, name in spans[1:]:
        gap = start - end
        if gap > 0:
            label = next(lb for limit, lb in GAP_CLASSES if gap < limit)
            by_class[label][0] += 1
            by_class[label][1] += gap
            largest.append((gap, prev, name))
        if stop > end:
            end, prev = stop, name
    log(f"    device span of the profiled steps: "
        f"{(end - spans[0][0]) / n:.1f} ms per step; gaps per step:")
    for label, (count, ms) in by_class.items():
        log(f"      {label}: {count / n:g} gaps, {ms / n:.2f} ms")
    largest.sort(reverse=True)
    for gap, before, after in largest[:6]:
        log(f"      gap {gap:.2f} ms after {before[:50]} before {after[:50]}")
    return {"span_ms_per_step": (end - spans[0][0]) / n,
            "per_step": {lb: {"count": c / n, "ms": ms / n}
                         for lb, (c, ms) in by_class.items()},
            "largest": [(g, b[:120], a[:120]) for g, b, a in largest[:10]]}


LOSS_GAP_LIMIT = 1e-4  # |flash loss - reference loss|
GRAD_GAP_LIMIT = 5e-2  # ||g_flash - g_ref|| / ||g_ref|| over every leaf
# grouped vs gather dispatch at a capacity nothing overflows. Observed
# gap: exactly 0 (B4 and cuBLAS sum K in the same k16 order on the tensor
# cores). The limits allow another summation order (a bf16 rounding here
# and there) but not a wrong tile or route, which moves gradients by
# about 1e-1
MOE_LOSS_GAP_LIMIT = 1e-4
MOE_GRAD_GAP_LIMIT = 1e-3


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _named_leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def cross_check(llama, config, variants, kernels, loss_limit, grad_limit):
    """One forward+backward at full width of ``config`` changed as each
    of ``variants`` says ((name, overrides) for the path under test,
    then for its reference), same weights and batch: the loss and every
    gradient. The path under test must launch ``kernels`` (wrapper
    modules), and the reference none of them."""
    import dataclasses

    import numpy as np
    import torch

    (test, test_kw), (ref, ref_kw) = variants
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = llama.init(gen, config)
    named = list(_named_leaves(params))
    for _, t in named:
        t.requires_grad_()
    ids = np.random.RandomState(1).randint(0, config.vocab_size,
                                           size=(1, SEQ + 1))
    batch = {"input_ids": torch.as_tensor(ids[:, :-1], device="cuda"),
             "labels": torch.as_tensor(ids[:, 1:], device="cuda")}
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
        f"(limit {loss_limit:.0e}); gradient gap ||g_{test} - g_{ref}|| "
        f"/ ||g_{ref}|| {gap:.3e} (limit {grad_limit:.0e}), worst leaf "
        f"{worst} {leaf_gap[worst]:.3e}")
    for name in sorted(leaf_gap):
        log(f"    gradient gap {name}: {leaf_gap[name]:.3e}")
    if not (abs(lf - lr) <= loss_limit and gap <= grad_limit):
        fail(f"{test} and {ref} disagree at full width")
    return {"test": test, "ref": ref, "launches": launched, "test_loss": lf,
            "test_grad_norm": nf, "ref_loss": lr, "ref_grad_norm": nr,
            "loss_gap": abs(lf - lr), "grad_gap": gap, "leaf_gap": leaf_gap}


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", default="",
                        help="also write the run's measurements here")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, ROOT)
    try:
        from dlrover_tpu_torch.models import llama
        from dlrover_tpu_torch.ops import flash_attention as fa
        from dlrover_tpu_torch.ops import grouped_matmul as gm
        from dlrover_tpu_torch.ops import kernel_build, moe, remat
    except ImportError as e:
        fail(f"the dlrover_tpu_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    report["build_s"] = build_s

    log("kernel vs plain:")
    errs, inputs, right = check_kernels(fa, 1, 32, 8, SEQ, 128,
                                        torch.bfloat16, True, 0, 1e-3)
    log("the same check against planted faults, same inputs:")
    report["planted_faults"] = check_planted_faults(inputs, right)
    del inputs, right
    for causal in (True, False):
        check_kernels(fa, 2, 4, 2, 1000, 64, torch.float32, causal, 1, 1e-4)
    check_kernels(fa, 1, 4, 1, 1000, 128, torch.bfloat16, True, 2, 1e-3)
    torch.cuda.empty_cache()

    log(f"kernel times (bf16, B=1 H=32/8 S={SEQ} D=128, causal; {card}):")
    times, sdpa = kernel_times(fa, 1, 32, 8, SEQ, 128)
    report["kernel_times"], report["sdpa"] = times, sdpa
    torch.cuda.empty_cache()

    log(f"main path: llama3_8b x{LAYERS} layers, batch 1, seq {SEQ}, "
        f"{STEPS} steps:")
    config = llama.llama3_8b(num_layers=LAYERS, max_seq_len=SEQ)
    recompute = 1 if remat.remat_enabled(config.remat_policy) else 0
    flash_expected = {"flash_fwd": STEPS * LAYERS * (1 + recompute),
                      "flash_bwd_dkv": STEPS * LAYERS,
                      "flash_bwd_dq": STEPS * LAYERS}
    report["train"] = train_main_path(
        llama, config, f"llama3_8b(num_layers={LAYERS}, max_seq_len={SEQ})",
        "llama", (fa,), flash_expected, card)
    torch.cuda.empty_cache()

    log("full-width cross-check (use_flash True vs False):")
    report["cross_check"] = cross_check(
        llama, config, (("flash", {"use_flash": True}),
                        ("reference", {"use_flash": False})), (fa,),
        LOSS_GAP_LIMIT, GRAD_GAP_LIMIT)
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
    g_times = grouped_times(gm, x, w, dy, lay)
    report["grouped_kernel_times"] = g_times
    report["grouped_main_groups"] = {"tiles": tiles, "real_rows": real,
                                     "rows": lay.rows}
    del x, w, dy, lay
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
        "flash_bwd_dq": STEPS * MOE_LAYERS,
        "grouped_matmul_fwd": STEPS * MOE_LAYERS * (2 * (1 + recompute) + 2),
        "grouped_matmul_dw": STEPS * MOE_LAYERS * 2,
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

    kernels = []
    for name, meta in fa.KERNELS.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": report["train"]["launches"][name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "verdict": "ok",
        })
    for name, meta in gm.KERNELS.items():
        # B4 is timed on y (the up-projection); its dx call does the same
        # work and is reported beside it
        t = g_times["y" if name == "grouped_matmul_fwd" else "dw"]
        entry = {
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": report["train_moe"]["launches"][name],
            "max_abs_err": g_errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "verdict": "ok",
        }
        if name == "grouped_matmul_fwd":
            dx = g_times["dx"]
            entry.update({"dx_ms": dx["ms"], "dx_plain_ms": dx["plain_ms"],
                          "dx_library_ms": dx["library_ms"]})
        kernels.append(entry)
    report["kernels"] = kernels
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as out:
            json.dump(report, out, indent=1, default=str)
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
