"""FLOPs / bytes / memory / latency profiling (port of
``dlrover_tpu/utils/prof.py``).

The reference reads FLOPs and bytes from XLA's cost model of the
compiled step. Eager PyTorch has no compiled program, so the port
counts: ``CostCounter`` is a ``TorchDispatchMode`` that sees every aten
op a function runs and adds

  FLOPs   by ``torch.utils.flop_counter``'s formulas (matmuls,
          convolutions, attention; elementwise ops count none);
  bytes   each op's tensor inputs and outputs (views and allocations
          move none): in unfused eager PyTorch each op really reads and
          writes device memory, so this is the counterpart of XLA's
          "bytes accessed";

and what the hand-written kernels and the exchanges report from their
shapes (``report_kernel``, ``report_exchange``): a wrapper pauses the
count around its plain version or its launch (``uncounted``) and
reports its formula, so a step counts the same work on the CPU, on the
card and on the meta device. Run a function on meta tensors
(``utils.meta_init``) to count it without running it.

``derived_mfu`` is THE MFU formula, shared with the live gauges
(``telemetry.attribution``).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("utils.prof")


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a module (its parameters), a nested dict / list of
    tensors, or one tensor."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def count_params(tree: Any) -> int:
    return sum(t.numel() for t in _leaves(tree))


def param_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def derived_mfu(flops_per_step: float, step_time_s: float,
                peak_flops_per_s: float) -> float:
    """THE model-FLOPs-utilization formula: (FLOPs per step / step
    seconds) over hardware peak. ``ProfileResult.mfu``, the live
    attribution gauges and ``chip_smoke.py`` price MFU through this one
    function. FLOPs and peak must share a basis (both per device)."""
    if peak_flops_per_s <= 0 or step_time_s <= 0:
        return 0.0
    return flops_per_step / (step_time_s * peak_flops_per_s)


# -- counting -----------------------------------------------------------------

# ops that allocate or relabel memory without moving bytes (views are
# found by their schema)
_NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "lift_fresh", "alias", "resize_",
    "set_", "_local_scalar_dense",
})


def _nbytes(values) -> int:
    flat, _ = tree_flatten(values)
    return sum(t.numel() * t.element_size() for t in flat
               if isinstance(t, torch.Tensor))


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of what runs inside it. ``flops`` and
    ``bytes`` are the totals; ``by_op`` (aten op -> [flops, bytes,
    calls]), ``kernels`` (a hand-written kernel -> {"flops", "bytes",
    "calls"}) and ``collective_bytes`` (exchange kind -> bytes on the
    wire) break them down. An exchange's own send and receive buffers
    are in ``bytes`` too."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, List[float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collective_bytes: Dict[str, float] = {}
        # (mode, s_q, s_k) -> visible (q, k) pairs a row, read from a
        # host batch: what the flash wrappers count on the meta device,
        # where the ids hold no values (ops.flash_attention.visible_pairs)
        self.pair_hints: Dict[tuple, float] = {}
        self._paused = 0

    @property
    def matmul_flops(self) -> float:
        """FLOPs of the aten ops with a formula (the kernels' apart)."""
        return sum(v[0] for v in self.by_op.values())

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        flops = 0.0
        formula = self._formulas.get(packet)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        nbytes = 0
        if name not in _NO_TRAFFIC and not func.is_view:
            nbytes = _nbytes((args, kwargs)) + _nbytes(out)
        if flops or nbytes:
            entry = self.by_op.setdefault(str(packet), [0.0, 0.0, 0])
            entry[0] += flops
            entry[1] += nbytes
            entry[2] += 1
            self.flops += flops
            self.bytes += nbytes
        return out

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        entry = self.kernels.setdefault(
            name, {"flops": 0.0, "bytes": 0.0, "calls": 0})
        entry["flops"] += flops
        entry["bytes"] += nbytes
        entry["calls"] += 1
        self.flops += flops
        self.bytes += nbytes

    def add_exchange(self, kind: str, nbytes: float) -> None:
        self.collective_bytes[kind] = (self.collective_bytes.get(kind, 0.0)
                                       + nbytes)
        # the send buffer read, the receive buffer written
        self.bytes += 2 * nbytes

    def summary(self) -> Dict[str, Any]:
        return {
            "flops": self.flops, "bytes": self.bytes,
            "matmul_flops": self.matmul_flops,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "collective_bytes": dict(self.collective_bytes),
        }


# the counters entered, innermost last (a process-wide list: autograd
# runs a backward on threads of its own, where the wrappers report too)
_ACTIVE: List[CostCounter] = []
_lock = threading.Lock()


def active_counter() -> Optional[CostCounter]:
    return _ACTIVE[-1] if _ACTIVE else None


def report_kernel(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's FLOPs and bytes for one call, from its
    shapes, to the active count (none: nothing happens)."""
    counter = active_counter()
    if counter is not None:
        with _lock:
            counter.add_kernel(name, flops, nbytes)


def report_exchange(kind: str, nbytes: float) -> None:
    """Bytes one exchange puts on the wire, by the reference's HLO kind
    ("all-reduce", "all-to-all", "collective-permute")."""
    counter = active_counter()
    if counter is not None:
        with _lock:
            counter.add_exchange(kind, nbytes)


@contextmanager
def uncounted() -> Iterator[None]:
    """Pause the active count (a wrapper's plain version or launch runs
    inside; the wrapper reports its formula instead)."""
    counter = active_counter()
    if counter is None:
        yield
        return
    with _lock:
        counter._paused += 1
    try:
        yield
    finally:
        with _lock:
            counter._paused -= 1


def _device_of(values) -> Optional[torch.device]:
    flat, _ = tree_flatten(values)
    for t in flat:
        if isinstance(t, torch.Tensor):
            return t.device
    return None


def compiled_peak_bytes(device=None) -> int:
    """Peak device memory: ``torch.cuda.max_memory_allocated`` since the
    last ``torch.cuda.reset_peak_memory_stats`` (the counterpart of the
    reference's compiled residency; read it after one measured step).
    0 off the card, as the reference's is without a memory analysis."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return 0
    return int(torch.cuda.max_memory_allocated(device))


@dataclass
class CostReport:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    peak_memory_bytes: int = 0

    # arithmetic intensity = flops / bytes: low values => memory-bound
    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.bytes_accessed if self.bytes_accessed else 0.0


def analyze_cost(fn: Callable, *args, **kwargs) -> CostReport:
    """Count ``fn(*args, **kwargs)``: it RUNS once under a
    ``CostCounter`` (eager PyTorch has no compile-only path; give it
    meta tensors to count without running). On the card the peak
    memory of that call is read too."""
    device = _device_of((args, kwargs))
    on_card = device is not None and device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with CostCounter() as counter:
        fn(*args, **kwargs)
    peak = 0
    if on_card:
        torch.cuda.synchronize(device)
        peak = compiled_peak_bytes(device)
    return CostReport(flops=counter.flops, bytes_accessed=counter.bytes,
                      peak_memory_bytes=peak)


@dataclass
class ProfileResult:
    steps_per_sec: float
    step_time_ms: float
    flops_per_step: float
    achieved_flops_per_sec: float
    param_count: int
    peak_memory_bytes: int

    def mfu(self, peak_flops_per_sec: float) -> float:
        """Model FLOPs utilization against a hardware peak (the shared
        ``derived_mfu`` formula)."""
        return derived_mfu(self.flops_per_step,
                           1.0 / max(self.steps_per_sec, 1e-12),
                           peak_flops_per_sec)


class DryRunner:
    """Timed execution of a train step (reference: dry_runner).

    Env knobs as the reference's: ``DLROVER_TPU_DRYRUN_WARMUP`` /
    ``DLROVER_TPU_DRYRUN_STEPS``. Warm-up steps, one counted step
    (``analyze_cost``, with its peak memory on the card), then the timed
    steps: on the card between two CUDA events, else on the host clock.
    """

    def __init__(self, warmup: Optional[int] = None,
                 steps: Optional[int] = None):
        self.warmup = warmup if warmup is not None else int(
            os.environ.get("DLROVER_TPU_DRYRUN_WARMUP", "2"))
        self.steps = steps if steps is not None else int(
            os.environ.get("DLROVER_TPU_DRYRUN_STEPS", "5"))

    def profile(self, train_step: Callable, state: Any, batch: Any,
                rng: Any = None) -> ProfileResult:
        """``train_step``: (state, batch, rng) -> (state, metrics), e.g.
        ``AccelerateResult.train_step`` with a sharded batch; the state
        is stepped in place."""
        for _ in range(max(self.warmup, 1)):
            state, _ = train_step(state, batch, rng)
        cost = analyze_cost(train_step, state, batch, rng)
        device = _device_of(getattr(state, "params", state))
        n = max(self.steps, 1)
        if device is not None and device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                state, _ = train_step(state, batch, rng)
            end.record()
            end.synchronize()
            elapsed = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                state, _ = train_step(state, batch, rng)
            elapsed = time.perf_counter() - t0
        sps = n / elapsed
        params = getattr(state, "params", state)
        result = ProfileResult(
            steps_per_sec=sps, step_time_ms=1000.0 * elapsed / n,
            flops_per_step=cost.flops,
            achieved_flops_per_sec=cost.flops * sps,
            param_count=count_params(params),
            peak_memory_bytes=cost.peak_memory_bytes,
        )
        logger.info("dryrun: %.2f steps/s (%.1f ms/step), %.3g flops/step, "
                    "%d params", result.steps_per_sec, result.step_time_ms,
                    result.flops_per_step, result.param_count)
        return result


class AProfiler:
    """Model-level profile summary (reference: AProfiler): parameters by
    module path at a depth, and the counted cost of a loss."""

    def __init__(self, params: Any):
        self._params = params

    def _named(self):
        if isinstance(self._params, torch.nn.Module):
            return [(name.split("."), p)
                    for name, p in self._params.named_parameters()]

        def walk(node, path):
            if isinstance(node, dict):
                return [leaf for k in sorted(node)
                        for leaf in walk(node[k], path + [str(k)])]
            return [(path, node)]

        return walk(self._params, [])

    def params_by_subtree(self, depth: int = 1) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for path, leaf in self._named():
            key = "/".join(path[:depth])
            out[key] = out.get(key, 0) + leaf.numel()
        return out

    def summary(self, loss_fn: Optional[Callable] = None, batch: Any = None,
                rng: Any = None) -> Dict[str, Any]:
        info: Dict[str, Any] = {
            "param_count": count_params(self._params),
            "param_bytes": param_bytes(self._params),
            "subtrees": self.params_by_subtree(),
        }
        if loss_fn is not None and batch is not None:
            cost = analyze_cost(loss_fn, self._params, batch, rng)
            info["forward_flops"] = cost.flops
            info["bytes_accessed"] = cost.bytes_accessed
            info["arithmetic_intensity"] = cost.arithmetic_intensity
        return info
