"""Build, load and launch the hand-written CUDA kernels of
``dlrover_tpu_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``.
Every entry point ``dlr_<name>_<dtype>`` takes its pointers and sizes,
then the stream, and returns 0 or the CUDA error of the launch, whose
text ``dlr_<name>_error`` gives.
Building happens at first use, from the sources in the checkout, into
``csrc/_build/`` (git-ignored). A library's file name carries a digest
of its sources and flags, so an edited kernel is rebuilt and a stale
one is never loaded. ``build()`` starts one ``nvcc`` per missing source,
all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dkv": "flash_bwd_dkv.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "grouped_matmul_fwd": "grouped_matmul_fwd.cu",
    "grouped_matmul_dw": "grouped_matmul_dw.cu",
    "grouped_matmul_fwd_quant": "grouped_matmul_fwd_quant.cu",
}
HEADERS = ("flash_common.cuh", "grouped_common.cuh", "hopper_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# per library: the times this process loaded it, and the times it ran
# nvcc for it (a rebuilt step loads and builds nothing)
LOADS: Dict[str, int] = {}
BUILDS: Dict[str, int] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    place, or the first on ``PATH``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from dlrover_tpu_torch/csrc at first use"
        )
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name],) + HEADERS:
        digest.update((CSRC / fname).read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named library that is not built yet, one ``nvcc``
    per source, all started together. Returns the seconds each build
    took (0.0 for one found on disk). Raises with the compiler's output
    when any build fails. ``nvcc``'s ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) is kept in ``<library>.log``."""
    names = list(names) if names is not None else list(SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    times = {n: 0.0 for n in names}
    with open(BUILD_DIR / ".lock", "w") as lock_file:
        # one build at a time across processes; the others find the
        # finished libraries when they get the lock
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return times
        nvcc = nvcc_path()
        procs = {}
        t0 = time.monotonic()
        for n in todo:
            BUILDS[n] = BUILDS.get(n, 0) + 1
            out = library_path(n)
            tmp = out.with_suffix(".so.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failures = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            times[n] = time.monotonic() - t0
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"--- {SOURCES[n]} (nvcc exit "
                                f"{proc.returncode}) ---\n{log}")
                continue
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first when missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
            LOADS[name] = LOADS.get(name, 0) + 1
        return lib


def on_meta(*tensors) -> bool:
    """True when every tensor lies on the meta device: a wrapper then
    returns empty outputs of the right shapes, launching nothing and
    running no plain version (``utils.meta_init``, the attribution
    count)."""
    return all(t.device.type == "meta" for t in tensors)


def on_cpu(op: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (the plain path); False
    when every one lies on one CUDA device (the kernel). Anything else
    raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{op} operands on several devices: "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{op} has no kernel for {device}")
    return False


def launch(name: str, suffix: str, argtypes: Sequence, device,
           *args) -> None:
    """Launch ``dlr_<name>_<suffix>`` (C signature ``argtypes``, the
    stream last) on ``device``'s current stream; raises with CUDA's text
    when the launch is refused."""
    lib = library(name)
    fn = getattr(lib, f"dlr_{name}_{suffix}")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        err = getattr(lib, f"dlr_{name}_error")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        code = fn(*args, stream)
    if code != 0:
        msg = getattr(lib, f"dlr_{name}_error")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
