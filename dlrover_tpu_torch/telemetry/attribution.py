"""Performance attribution: FLOPs, bytes and device memory per built
step, and device time by kind from a profiler trace (port of
``dlrover_tpu/telemetry/attribution.py``).

The reference reads FLOPs and bytes accessed from XLA's cost model of
the compiled step. Here ``capture_attribution`` COUNTS one step instead:
the step of the same ``AccelerateResult`` runs on the meta device
(``utils.meta_init.on_meta``: shapes only, nothing allocated, nothing
launched, the live state untouched) under ``utils.prof.CostCounter``,
which adds the aten ops' FLOPs and bytes and what the hand-written
kernels and the exchanges report from their shapes. Peak device memory
is ``torch.cuda.max_memory_allocated`` (0 on the CPU). At runtime the
executor fuses the record with measured step times into the gauges:

  live MFU             counted FLOPs/step over (measured step s x device
                       peak): ``utils.prof.derived_mfu``, one formula
  arithmetic intensity FLOPs / bytes (memory-bound when low)
  exposed-comm frac    clamped (1 - ideal compute s / measured step s):
                       an upper bound on un-overlapped communication
  HBM headroom         free device memory (``torch.cuda.mem_get_info``)

The second source is a ``torch.profiler`` trace in Chrome trace-event
format (``export_chrome_trace``), parsed into device-time buckets
(collective / compute / infeed / other / idle), by kernel group and by
kernel, and into the device's idle gaps. A trace that holds device
events (``cat`` "kernel", "gpu_memcpy", "gpu_memset") is read from
those only; a trace without them by the reference's rule unchanged.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.telemetry.events import emit_event
from dlrover_tpu_torch.telemetry.names import EventKind
from dlrover_tpu_torch.utils.prof import (
    CostCounter,
    compiled_peak_bytes,
    derived_mfu,
)

logger = get_logger("telemetry.attribution")

_MB = 1024 * 1024


def attribution_enabled() -> bool:
    """The capture gate: the attribution knob AND the telemetry master
    switch."""
    ctx = get_context()
    return bool(ctx.attribution_enabled) and bool(ctx.telemetry_enabled)


def resolve_device_spec(device=None):
    """The ``parallel.planner.DeviceSpec`` of ``device`` (default: the
    current card): found by ``torch.cuda.get_device_name``, its memory
    what the card reports; the CPU gets the H100 SXM's datasheet as a
    placeholder, as the reference falls back to v5e. Set
    ``Context.device_peak_flops`` for meaningful CPU numbers."""
    from dlrover_tpu_torch.parallel.planner import device_spec

    return device_spec(device)


def resolve_peak_flops(device_spec=None) -> float:
    """Per-device peak FLOPs/s for the MFU denominator:
    ``Context.device_peak_flops`` when set, else the device spec's."""
    ctx_peak = float(get_context().device_peak_flops)
    if ctx_peak > 0:
        return ctx_peak
    spec = device_spec or resolve_device_spec()
    return float(spec.flops_per_s)


def resolve_hbm_budget(device_spec=None) -> float:
    """Per-device memory budget in bytes:
    ``Context.device_hbm_budget_bytes`` when set, else the spec's."""
    ctx_budget = float(get_context().device_hbm_budget_bytes)
    if ctx_budget > 0:
        return ctx_budget
    spec = device_spec or resolve_device_spec()
    return float(spec.hbm_bytes)


@dataclass
class AttributionRecord:
    """One built step's cost facts (per DEVICE, per optimizer STEP: a
    multi-step call is normalized by ``steps_per_call``). The
    reference's fields and ``to_dict`` keys."""

    flops_per_step: float = 0.0  # counted FLOPs
    bytes_accessed_per_step: float = 0.0  # counted device-memory traffic
    peak_hbm_bytes: int = 0  # torch.cuda.max_memory_allocated
    # bytes on the wire per exchange kind, per step
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    # per-kind predicted exchange seconds (bytes over the link rate)
    predicted_comm_s: Dict[str, float] = field(default_factory=dict)
    predicted_comm_total_s: float = 0.0
    # ideal compute seconds: flops_per_step / peak
    predicted_compute_s: float = 0.0
    peak_flops_per_s: float = 0.0
    hbm_budget_bytes: float = 0.0
    n_devices: int = 1
    steps_per_call: int = 1
    source: str = "counted"  # comm-bytes provenance
    capture_seconds: float = 0.0

    @property
    def arithmetic_intensity(self) -> float:
        if self.bytes_accessed_per_step <= 0:
            return 0.0
        return self.flops_per_step / self.bytes_accessed_per_step

    def mfu(self, step_time_s: float) -> float:
        """Live MFU for one measured step time (shared formula)."""
        return derived_mfu(self.flops_per_step, step_time_s,
                           self.peak_flops_per_s)

    def exposed_comm_fraction(self, step_time_s: float,
                              exchange_s: Optional[float] = None) -> float:
        """Clamped (measured - ideal compute) / measured: the share of
        the step NOT explained by compute at peak, an upper bound on
        un-overlapped communication. ``exchange_s``: the host seconds
        the step's exchanges took (``ops.ring.STATS``: the all-gathers
        and reduce-scatters of FSDP, the all-reduces), given where an
        exchange holds the host until it is done (gloo; the trainer
        executor's gauge): those seconds are exposed, and the fraction
        is their share of the step, within the bound."""
        if step_time_s <= 0:
            return 0.0
        frac = min(max(1.0 - self.predicted_compute_s / step_time_s, 0.0),
                   1.0)
        if exchange_s is None:
            return frac
        return min(max(exchange_s / step_time_s, 0.0), frac)

    def hbm_headroom_bytes(self) -> Optional[float]:
        """Budget minus peak; None when no budget is known."""
        if self.hbm_budget_bytes <= 0:
            return None
        return self.hbm_budget_bytes - self.peak_hbm_bytes

    def to_dict(self) -> Dict[str, Any]:
        return {
            "flops_per_step": self.flops_per_step,
            "bytes_accessed_per_step": self.bytes_accessed_per_step,
            "arithmetic_intensity": round(self.arithmetic_intensity, 4),
            "peak_hbm_mb": round(self.peak_hbm_bytes / _MB, 3),
            "collective_bytes": dict(self.collective_bytes),
            "predicted_comm_s": {
                k: round(v, 6) for k, v in self.predicted_comm_s.items()
            },
            "predicted_comm_total_s": round(
                self.predicted_comm_total_s, 6),
            "predicted_compute_s": round(self.predicted_compute_s, 9),
            "peak_flops_per_s": self.peak_flops_per_s,
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "n_devices": self.n_devices,
            "steps_per_call": self.steps_per_call,
            "source": self.source,
            "capture_seconds": round(self.capture_seconds, 3),
        }


def pair_hints(batch: Dict[str, Any]) -> Dict[tuple, float]:
    """The visible (q, k) pairs a row of the flash kernels' data-dependent
    modes, read from a host batch: ``segment_ids`` [B, S] (packed
    documents, causal) and ``prefix_len`` [B] (prefix-LM over rows of
    the batch's ``input_ids`` width), keyed as
    ``CostCounter.pair_hints``."""
    from dlrover_tpu_torch.ops.flash_attention import visible_pairs

    def rows(b, s):  # q and k as visible_pairs reads them: shapes only
        return torch.empty((b, 1, s, 1)), torch.empty((b, 1, s, 1))

    hints = {}
    if "segment_ids" in batch:
        ids = torch.as_tensor(batch["segment_ids"]).to(torch.int32)
        b, s = ids.shape
        hints[("_seg", s, s)] = visible_pairs(*rows(b, s), True, ids,
                                              ids) / b
    if "prefix_len" in batch and "input_ids" in batch:
        prefix = torch.as_tensor(batch["prefix_len"]).to(torch.int32)
        b, s = torch.as_tensor(batch["input_ids"]).shape[:2]
        hints[("_pfx", s, s)] = visible_pairs(*rows(b, s), True,
                                              prefix_len=prefix) / b
    return hints


def count_step(result, steps_per_call: int = 1,
               example_batch: Any = None) -> CostCounter:
    """Count one call of ``result``'s step on the meta device: the state
    through ``utils.meta_init.abstract_init`` (``result.init_fn``), one
    uncounted step first (it makes the optimizer's slots), then the
    counted call, ``train_step_multi`` over K stacked copies of the
    example batch when ``steps_per_call`` K > 1. Nothing is allocated
    or launched and the live state is not touched. Returns the counter
    (totals for the whole call: divide by K for a step)."""
    from dlrover_tpu_torch.utils.meta_init import abstract_init, on_meta

    if example_batch is None:
        raise ValueError("count_step needs the example batch to rebuild "
                         "the step's inputs")
    k = max(1, int(steps_per_call))
    if result.train_step_multi is None:
        k = 1
    host = {name: torch.as_tensor(v) for name, v in example_batch.items()}
    counter = CostCounter()
    counter.pair_hints.update(pair_hints(host))
    gen = torch.Generator().manual_seed(0)
    state = abstract_init(result.init_fn, 0)
    with on_meta(all_factories=False):
        batch = result.shard_batch({n: t.to("meta") for n, t in host.items()})
        state, _ = result.train_step(state, batch, gen)
        if k > 1:
            stacked = result.shard_batch(
                {n: t.to("meta").expand(k, *t.shape)
                 for n, t in host.items()}, stacked=True)
            with counter:
                result.train_step_multi(state, stacked, gen)
        else:
            with counter:
                result.train_step(state, batch, gen)
    return counter


def capture_attribution(
    result,
    steps_per_call: int = 1,
    example_batch: Any = None,
    model_spec=None,
    device_spec=None,
    mesh_plan=None,
    emit: bool = True,
) -> AttributionRecord:
    """The attribution record of an ``AccelerateResult``'s step:
    ``count_step`` on the meta device, per step; exchange seconds are
    the counted wire bytes over the card's link rate
    (``source="counted"``). ``model_spec`` / ``mesh_plan``: the
    planner's collective model comes with ROADMAP A15 (a ``model_spec``
    raises)."""
    if model_spec is not None:
        raise NotImplementedError(
            "capture_attribution(model_spec=...): the planner's collective "
            "model is not ported (ROADMAP A15)")
    del mesh_plan
    spec = device_spec or resolve_device_spec(result.device)
    peak_flops = resolve_peak_flops(spec)
    budget = resolve_hbm_budget(spec)
    t0 = time.monotonic()
    k = (max(1, int(steps_per_call))
         if result.train_step_multi is not None else 1)
    counter = count_step(result, k, example_batch)
    flops = counter.flops / k
    coll = {name: v / k for name, v in counter.collective_bytes.items()}
    comm_s = {name: b / spec.ici_bw for name, b in coll.items() if b > 0}
    record = AttributionRecord(
        flops_per_step=flops,
        bytes_accessed_per_step=counter.bytes / k,
        peak_hbm_bytes=compiled_peak_bytes(result.device),
        collective_bytes=coll,
        predicted_comm_s=comm_s,
        predicted_comm_total_s=sum(comm_s.values()),
        predicted_compute_s=flops / peak_flops if peak_flops > 0 else 0.0,
        peak_flops_per_s=peak_flops,
        hbm_budget_bytes=budget,
        n_devices=int(result.world),
        steps_per_call=k,
        capture_seconds=time.monotonic() - t0,
    )
    if emit:
        emit_event(
            EventKind.ATTRIBUTION_CAPTURED,
            flops_per_step=record.flops_per_step,
            bytes_accessed_per_step=record.bytes_accessed_per_step,
            arithmetic_intensity=round(record.arithmetic_intensity, 4),
            peak_hbm_mb=round(record.peak_hbm_bytes / _MB, 3),
            predicted_comm_total_s=round(record.predicted_comm_total_s, 6),
            predicted_compute_s=round(record.predicted_compute_s, 9),
            peak_flops_per_s=record.peak_flops_per_s,
            n_devices=record.n_devices,
            steps_per_call=record.steps_per_call,
            source=record.source,
            capture_seconds=round(record.capture_seconds, 3),
        )
    logger.info(
        "attribution captured: %.4g flops/step, %.4g bytes, peak memory "
        "%.1f MB, comm %s (%.2fs)", record.flops_per_step,
        record.bytes_accessed_per_step, record.peak_hbm_bytes / _MB,
        {n: f"{b / 1e6:.2f}MB" for n, b in coll.items()},
        record.capture_seconds)
    return record


# -- measured time: a profiler trace -> device-time buckets -------------------

# op-name patterns per category; first match wins. Collectives before
# compute: a fused op named "fusion.all-reduce..." is traffic. The
# reference's patterns, with the CUDA kernels' names added
_CATEGORY_PATTERNS: Tuple[Tuple[str, re.Pattern], ...] = (
    ("collective", re.compile(
        r"all-reduce|all-gather|reduce-scatter|all-to-all|"
        r"collective-permute|collective_permute|send\b|recv\b|"
        r"cross_replica|nccl", re.IGNORECASE)),
    ("infeed", re.compile(r"infeed|outfeed|host-to-device|"
                          r"device-to-host|transfer|memcpy htod|"
                          r"memcpy dtoh", re.IGNORECASE)),
    ("compute", re.compile(
        r"fusion|dot|conv|matmul|gemm|scatter|gather|reduce|"
        r"select|iota|broadcast|transpose|copy|sort|rng|custom-call|"
        r"cutlass|nvjet|sm90_|flash_|grouped_|multi_tensor",
        re.IGNORECASE)),
)

# the trace categories of device work in a torch.profiler (Kineto) trace
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})

# (group, substrings of a CUDA kernel's name): where a step's device
# time goes, first match wins; the rest is "other elementwise / copies"
KERNEL_GROUPS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("flash attention (B1-B3)", ("flash_fwd", "flash_bwd")),
    ("grouped matmul (B4-B6)", ("grouped_fwd", "grouped_dw")),
    ("copies between host and device", ("memcpy",)),
    ("matmul", ("gemm", "xmma", "cutlass", "matmul", "sm90_", "nvjet")),
    ("optimizer", ("multi_tensor", "adam")),
    ("softmax / loss", ("softmax", "nll", "log_softmax", "logsumexp")),
)
OTHER_GROUP = "other elementwise / copies"

GAP_CLASSES = ((0.02, "under 20 us"), (1.0, "20 us to 1 ms"),
               (float("inf"), "over 1 ms"))


def categorize_op(name: str) -> str:
    """Trace-event op name -> device-time category
    (collective / infeed / compute / other)."""
    for category, pat in _CATEGORY_PATTERNS:
        if pat.search(name or ""):
            return category
    return "other"


def kernel_group(name: str) -> str:
    """A CUDA kernel's group in ``KERNEL_GROUPS``."""
    low = name.lower()
    return next((g for g, keys in KERNEL_GROUPS
                 if any(key in low for key in keys)), OTHER_GROUP)


def load_trace(path: str) -> List[Dict]:
    """Read a Chrome trace-event file (``.json`` or ``.json.gz``, a bare
    event list or the ``{"traceEvents": [...]}`` envelope): what
    ``torch.profiler``'s ``export_chrome_trace`` writes."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    if isinstance(data, dict):
        data = data.get("traceEvents", [])
    return [e for e in data if isinstance(e, dict)]


def find_trace_files(profile_dir: str) -> List[str]:
    """Every ``*.trace.json[.gz]`` under a profiler dump directory
    (``tensorboard_trace_handler`` writes ``*.pt.trace.json``)."""
    out: List[str] = []
    for root, _dirs, files in os.walk(profile_dir):
        for name in files:
            if name.endswith((".trace.json", ".trace.json.gz")):
                out.append(os.path.join(root, name))
    return sorted(out)


def _complete(records: List[Dict]) -> List[Tuple[float, float, Dict]]:
    """(start us, duration us, event) of the complete ('ph' == 'X')
    events with a positive duration."""
    out = []
    for e in records:
        if e.get("ph") != "X":
            continue
        try:
            start = float(e.get("ts", 0.0))
            dur = float(e.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        if dur > 0:
            out.append((start, dur, e))
    return out


def device_events(records: List[Dict]) -> List[Tuple[float, float, Dict]]:
    """The complete events a bucket sum reads: the device's own
    (``DEVICE_CATS``) where the trace holds any, else every one (the
    reference's rule: its traces hold device lanes only by name)."""
    events = _complete(records)
    device = [ev for ev in events if ev[2].get("cat") in DEVICE_CATS]
    return device or events


def parse_trace_events(records: List[Dict]) -> Dict[str, Any]:
    """Partition a trace's complete events into per-category seconds,
    lane-aware as the reference:

      * category seconds (``collective_s`` ...) sum over every lane;
      * ``busy_s`` is the busiest single (pid, tid) lane's busy time;
      * ``idle_s`` is the wall envelope minus that busiest lane;
      * ``measured_comm_frac`` is collective over the categorized time
        (collective + compute + infeed).

    A ``torch.profiler`` trace's host lanes (``cpu_op``,
    ``python_function``, ``cuda_runtime``) nest and would overcount, and
    a host thread would be the busiest lane: where the trace holds device
    events, only those are read (``device_events``)."""
    per_cat: Dict[str, float] = {}
    per_track: Dict[Tuple, float] = {}
    t_min = float("inf")
    t_max = float("-inf")
    events = device_events(records)
    for start, dur, e in events:
        cat = categorize_op(str(e.get("name", "")))
        per_cat[cat] = per_cat.get(cat, 0.0) + dur
        track = (e.get("pid"), e.get("tid"))
        per_track[track] = per_track.get(track, 0.0) + dur
        t_min = min(t_min, start)
        t_max = max(t_max, start + dur)
    # trace timestamps are microseconds
    wall = max(0.0, (t_max - t_min)) / 1e6 if events else 0.0
    seconds = {cat: v / 1e6 for cat, v in per_cat.items()}
    busy_s = max(per_track.values()) / 1e6 if per_track else 0.0
    collective_s = seconds.get("collective", 0.0)
    categorized_s = (collective_s + seconds.get("compute", 0.0)
                     + seconds.get("infeed", 0.0))
    return {
        "events": len(events),
        "wall_s": round(wall, 6),
        "busy_s": round(busy_s, 6),
        "idle_s": round(max(0.0, wall - busy_s), 6),
        "collective_s": round(collective_s, 6),
        "compute_s": round(seconds.get("compute", 0.0), 6),
        "infeed_s": round(seconds.get("infeed", 0.0), 6),
        "other_s": round(seconds.get("other", 0.0), 6),
        "measured_comm_frac": round(
            collective_s / categorized_s, 4
        ) if categorized_s > 0 else 0.0,
    }


def parse_trace_path(path: str) -> Dict[str, Any]:
    """``parse_trace_events`` over one file or every trace under a
    profiler dump directory (events merge into one bucket set)."""
    if os.path.isdir(path):
        files = find_trace_files(path)
        if not files:
            raise FileNotFoundError(
                f"no *.trace.json[.gz] under {path}")
        records: List[Dict] = []
        for f in files:
            records.extend(load_trace(f))
        report = parse_trace_events(records)
        report["source_files"] = len(files)
        return report
    return parse_trace_events(load_trace(path))


def kernel_breakdown(records: List[Dict], steps: int = 1,
                     top: int = 12) -> Dict[str, Any]:
    """Device ms per step by ``KERNEL_GROUPS`` group and by kernel name
    (with launches per step), from the same events as
    ``parse_trace_events``."""
    groups: Dict[str, float] = {}
    by_name: Dict[str, List[float]] = {}
    for _start, dur, e in device_events(records):
        name = str(e.get("name", ""))
        ms = dur / 1e3 / steps
        group = kernel_group(name)
        groups[group] = groups.get(group, 0.0) + ms
        entry = by_name.setdefault(name, [0.0, 0.0])
        entry[0] += ms
        entry[1] += 1.0 / steps
    ranked = sorted(((ms, count, name) for name, (ms, count)
                     in by_name.items()), reverse=True)
    return {"busy_ms": sum(groups.values()), "groups_ms": groups,
            "by_name": by_name, "top": ranked[:top]}


def device_gaps(records: List[Dict], steps: int = 1) -> Dict[str, Any]:
    """Where the device waits between its own operations: the gaps
    between one device event's end and the next one's start, per step
    by size (``GAP_CLASSES``), and the largest with their neighbours."""
    spans = sorted((start / 1e3, (start + dur) / 1e3,
                    str(e.get("name", "")))
                   for start, dur, e in device_events(records))
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
    largest.sort(reverse=True)
    return {"span_ms_per_step": (end - spans[0][0]) / steps,
            "per_step": {lb: {"count": c / steps, "ms": ms / steps}
                         for lb, (c, ms) in by_class.items()},
            "largest": [(g, b[:120], a[:120]) for g, b, a in largest[:10]]}
