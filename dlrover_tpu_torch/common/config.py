"""Global tunables (port of ``dlrover_tpu/common/config.py``).

Only the ``Context`` knobs this slice reads are kept; each keeps its
environment override ``DLROVER_TPU_<UPPER_NAME>``. The log level is read
by ``common.log`` from ``DLROVER_TPU_LOG_LEVEL``.
"""

from __future__ import annotations

import logging
import os
import threading


class Context:
    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        # guardrail: steps between non-finite loss/grad checks (0 = off)
        self.check_finite_every_steps = 10
        # train-step calls in flight before the oldest call's metrics
        # are read on the host (0 = read right after each call)
        self.train_window = 4
        # optimizer steps per train-step call (K > 1: the fused
        # multi-step call, ``ElasticTrainer.step_multi``)
        self.steps_per_call = 1
        # survivable membership changes are absorbed in the process
        # (drain, snapshot, rebuild, restore); off = every change takes
        # the process-restart path
        self.live_recovery = True
        # on a non-finite step: "halt" | "ignore" | "rollback" (restore
        # the newest checkpoint and go on)
        self.on_nonfinite = "halt"
        # checkpoint: save in the background after a host copy of the
        # state; mirror committed steps into host DRAM (/dev/shm)
        self.ckpt_async = True
        self.ckpt_host_staging = True
        # master switch for the metrics registry, events and spans
        self.telemetry_enabled = True
        # JSONL event sink ("" = in-memory ring only)
        self.telemetry_events_file = ""
        # grouped_ep MoE: static chunks of the row exchange (1 = one
        # all_to_all; C > 1 = the ring, C chunks); read by ops.moe when
        # a config leaves it at 0
        self.dispatch_chunks = 1
        # grouped_ep MoE wire: "bf16" (the compute dtype), "fp8"
        # (block-scaled e4m3 + f32 scales) or "fp8_qdq" (the bitwise
        # reference: quantize -> dequantize, full-precision wire); read
        # by ops.moe when a config leaves it empty
        self.moe_precision = "bf16"
        # the dense FSDP wire: what the parameter all-gathers ship,
        # "bf16" (the parameter dtype), "fp8" (each wired leaf's block
        # quantized on its rank, e4m3 values + f32 scales gathered,
        # decoded at consumption; gradients straight through) or
        # "fp8_qdq" (the bitwise reference: quantize -> dequantize, the
        # wire at full precision); read by models.llama when a config
        # leaves it empty, so ElasticTrainer.retune swaps it
        self.fsdp_precision = "bf16"
        # the gradient wire: "bf16" (exact) or "fp8" (each gradient
        # block quantized with an error-feedback residual carried in
        # TrainState); "fp8_nofb" drops the error (a control, never
        # train with it). A build-time knob: the residual is state
        self.grad_precision = "bf16"
        # the FSDP layer prefetch: each layer's parameters gathered while
        # the previous layer computes, and again in the backward, its
        # gradient reduced as soon as it is complete (at most two layers
        # gathered at once); off, the step gathers the whole tree once.
        # Read by models.llama when a config leaves it None, at each call
        self.fsdp_prefetch = False
        # performance attribution (telemetry.attribution): a cost record
        # per built step (counted FLOPs and bytes, peak memory) fused
        # with measured step times into live MFU gauges. Requires
        # telemetry_enabled; off = no capture, gauges absent
        self.attribution_enabled = True
        # peak FLOPs/s per device for the MFU denominator (0 = the
        # DeviceSpec of the card's name; the CPU gets the H100 SXM's as
        # a placeholder: set this for meaningful CPU numbers)
        self.device_peak_flops = 0.0
        # per-device memory budget in bytes (0 = the DeviceSpec's
        # capacity: on the card, what torch.cuda reports)
        self.device_hbm_budget_bytes = 0.0
        # -- serving (serving.engine) --------------------------------
        # slot-batch width of the continuous-batching decode loop
        self.serve_slots = 8
        # prompt tokens prefilled per chunk, interleaved into the decode
        # stream (fitted to a divisor of the pool depth)
        self.serve_prefill_chunk = 32
        # KV-page storage: "f32" | "bf16" | "int8" (values + f32
        # per-block scales)
        self.serve_kv_precision = "f32"
        # decode calls in flight before the oldest one's tokens are read
        # on the host (0 = read right after each call)
        self.serve_window = 2
        # shared prefix pool, in pages (0 = off): KV pages beside the
        # slot pool, indexed on the host, copied into a slot on a hit
        self.serve_prefix_pool_pages = 0
        # speculative decode's master switch, and the draft tokens
        # verified a slot a step (K; 0 = off)
        self.serve_spec_enabled = True
        self.serve_spec_draft_len = 0
        # seconds between the serving worker's polls of the master for a
        # serve plan (0 = never poll)
        self.plan_poll_secs = 30.0
        # node runtime reports: every this many decode steps, and no
        # more often than every seconds_interval_to_report seconds
        self.runtime_report_steps = 32
        self.seconds_interval_to_report = 15
        self._apply_env_overrides()

    def _apply_env_overrides(self):
        for name, val in vars(self).items():
            if name.startswith("_"):
                continue
            env = os.environ.get("DLROVER_TPU_" + name.upper())
            if env is None:
                continue
            try:
                if isinstance(val, bool):
                    setattr(self, name, env.lower() in ("1", "true", "yes"))
                elif isinstance(val, int):
                    setattr(self, name, int(env))
                elif isinstance(val, float):
                    setattr(self, name, float(env))
                else:
                    setattr(self, name, env)
            except ValueError:
                logging.getLogger("dlrover_tpu_torch").warning(
                    "ignoring malformed env override DLROVER_TPU_%s=%r",
                    name.upper(), env,
                )

    @classmethod
    def singleton_instance(cls) -> "Context":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance


def get_context() -> Context:
    return Context.singleton_instance()
