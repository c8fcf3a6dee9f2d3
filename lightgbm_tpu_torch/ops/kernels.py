"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds. Builds happen at first use, into
``build/torch_kernels/`` at the root of the checkout (git-ignored), keyed
by a hash of the source and the flags so an edited kernel is rebuilt.
Nothing here runs at import time: the CPU-only test machine imports every
module but never builds.

The two stable-partition kernels (``compact.cu``, ``partition.cu``) also
share a per-stream scratch buffer and launch epoch (``scan_scratch``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from ..utils import log

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# every kernel source of the package (name -> csrc/<name>.cu)
KERNELS = ("histogram", "compact", "partition", "hist_probes")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    # the headers (csrc/*.cuh) are part of every source's build
    src = b"".join(p.read_bytes() for p in
                   [CSRC_DIR / f"{name}.cu",
                    *sorted(CSRC_DIR.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one kernel; returns (process, tmp path, final
    path) or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    text, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{text}")
    if text.strip():
        log.debug(f"nvcc csrc/{name}.cu:\n{text}")
    os.replace(tmp, out)          # atomic: readers never see a partial .so


def build(names: Sequence[str] = KERNELS) -> List[Path]:
    """Compile the named kernels, one ``nvcc`` per source, all started
    together; returns the library paths."""
    with _LOCK:
        jobs = {n: _start_build(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish_build(n, job)
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[0]
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _LOADED[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


# The stable-partition kernels' scratch (tile counters and look-back status
# words, csrc/stable_partition.cuh), one buffer per stream. Zeroed once when
# allocated: every launch gets the next epoch, so the status words an
# earlier launch left never read as valid, and each launch zeroes the
# counters the next one uses. Calls on one stream run in order.
_SCAN_SCRATCH: Dict[tuple, list] = {}
EPOCH_LIMIT = 1 << 30                  # the epoch has 30 bits


def scan_scratch(stream, nbytes: int) -> Tuple[torch.Tensor, int]:
    """(scratch buffer, epoch) for the next stable-partition launch on
    ``stream``; call ``scan_launched`` after a launch that succeeded."""
    key = (stream.device, stream.cuda_stream)
    ent = _SCAN_SCRATCH.get(key)
    if ent is None or ent[0].numel() < nbytes or ent[1] + 1 >= EPOCH_LIMIT:
        with torch.cuda.stream(stream):
            buf = torch.zeros(max(nbytes, 1), dtype=torch.uint8,
                              device=stream.device)
        ent = _SCAN_SCRATCH[key] = [buf, 0]
    return ent[0], ent[1] + 1


def scan_launched(stream, epoch: int) -> None:
    """Record that the launch with ``epoch`` went out on ``stream``."""
    _SCAN_SCRATCH[(stream.device, stream.cuda_stream)][1] = epoch
