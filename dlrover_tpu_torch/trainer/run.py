"""Local launch of several training processes on one host (port of the
standalone, no-master path of ``dlrover_tpu/trainer/run.py``, trimmed to
what this slice runs).

Each worker gets the ``NodeEnv`` contract (``DLROVER_TPU_PROCESS_ID``,
``DLROVER_TPU_NUM_PROCESSES``, ``DLROVER_TPU_COORDINATOR_ADDR`` at a free
port of ``localhost``, ``LOCAL_RANK``) and joins the process group
through ``trainer.bootstrap.init_worker``. Every worker inherits the
launcher's environment, the Context's ``DLROVER_TPU_*`` overrides
included.

    python -m dlrover_tpu_torch.trainer.run --nproc 4 -- \\
        -m dlrover_tpu_torch.examples.train_llama --moe_experts 8 ...

``--steps_per_call`` and ``--train_window`` reach the workers as
``DLROVER_TPU_STEPS_PER_CALL`` and ``DLROVER_TPU_TRAIN_WINDOW``.

``run_local(fn, nprocs, args)`` does the same for a function inside one
program: each worker is a spawned process that runs ``fn(*args)`` with
the contract set, and the caller gets every rank's return value (which
must pickle), in rank order, or an error carrying every failed rank's
traceback. ``fn`` must be importable (defined at a module's top level).
Gloo binds to the loopback interface (``GLOO_SOCKET_IFNAME=lo``) unless
the caller chose one: every rank is on this host.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import queue
import socket
import subprocess
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from dlrover_tpu_torch.common.constants import NodeEnv


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(rank: int, nprocs: int, addr: str) -> Dict[str, str]:
    """The environment contract of worker ``rank`` of ``nprocs``."""
    env = {
        NodeEnv.PROCESS_ID: str(rank),
        NodeEnv.NUM_PROCESSES: str(nprocs),
        NodeEnv.COORDINATOR_ADDR: addr,
        NodeEnv.NODE_RANK: "0",
        NodeEnv.NODE_NUM: "1",
        "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(nprocs),
    }
    if "GLOO_SOCKET_IFNAME" not in os.environ:
        env["GLOO_SOCKET_IFNAME"] = "lo"
    return env


def _entry(fn, rank, env, args, results):
    os.environ.update(env)
    try:
        out = fn(*args)
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    results.put((rank, True, out))


def run_local(fn: Callable, nprocs: int, args: Sequence[Any] = (),
              timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``nprocs`` spawned workers; returns their
    results in rank order. Raises when a worker fails, dies or outlives
    ``timeout`` seconds; every worker is stopped before it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    addr = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_entry, daemon=True, args=(
        fn, rank, worker_env(rank, nprocs, addr), tuple(args), results))
        for rank in range(nprocs)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(got) + len(errors) < nprocs:
            try:
                rank, ok, out = results.get(timeout=1.0)
                (got if ok else errors)[rank] = out
                continue
            except queue.Empty:
                pass
            for rank, p in enumerate(procs):
                if (p.exitcode is not None and rank not in got
                        and rank not in errors):
                    # let a result already in the pipe arrive first
                    try:
                        r, ok, out = results.get(timeout=2.0)
                        (got if ok else errors)[r] = out
                    except queue.Empty:
                        errors[rank] = f"exited with code {p.exitcode}"
            if deadline is not None and time.monotonic() > deadline:
                missing = sorted(set(range(nprocs)) - set(got) - set(errors))
                errors.update({r: f"no result within {timeout} s"
                               for r in missing})
            if errors:
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("worker(s) failed:\n" + "\n".join(
            f"--- rank {r} ---\n{msg}" for r, msg in sorted(errors.items())))
    return [got[r] for r in range(nprocs)]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dlrover_tpu_torch.trainer.run",
        description="start N training processes on this host")
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--train_window", type=int, default=None,
                   help="steps in flight before the oldest call's metrics "
                        "are read (0 = synchronous; workers see it as "
                        "DLROVER_TPU_TRAIN_WINDOW)")
    p.add_argument("--steps_per_call", type=int, default=None,
                   help="optimizer steps fused per call (workers see it "
                        "as DLROVER_TPU_STEPS_PER_CALL)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="[--] script.py args... | -m module args...")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        p.error("no command to run")
    # the Context reads DLROVER_TPU_* at its creation, so every worker's
    # trainer and executor see these knobs
    knobs = {}
    if args.train_window is not None:
        knobs["DLROVER_TPU_TRAIN_WINDOW"] = str(args.train_window)
    if args.steps_per_call is not None:
        knobs["DLROVER_TPU_STEPS_PER_CALL"] = str(args.steps_per_call)
    addr = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, *cmd],
        env={**os.environ, **knobs, **worker_env(rank, args.nproc, addr)})
        for rank in range(args.nproc)]
    try:
        codes = [proc.wait() for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return max(codes, key=abs)


if __name__ == "__main__":
    sys.exit(main())
