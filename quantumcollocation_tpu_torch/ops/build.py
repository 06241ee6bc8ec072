"""Build and load the hand-written CUDA kernels, and count their launches.

Each source in quantumcollocation_tpu_torch/csrc/ has a plain C interface
and is compiled by nvcc for Hopper (sm_90a) into its own shared library
under build/kernels/ at the repository root, named by a hash of the
source, then loaded with ctypes.  Nothing includes PyTorch's headers, so a
build takes seconds.  Builds happen at first use, or all at once (one nvcc
process per source, started together) through build_all().  To print
ptxas's registers, shared memory and spills of each kernel (-Xptxas -v)
of any source:

    python -m quantumcollocation_tpu_torch.ops.build [path/to/source.cu ...]
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "library", "build_other", "launch_counts",
           "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

SOURCES = {
    "dyn_assembly": "dyn_assembly.cu",
    "kkt_sweeps": "kkt_sweeps.cu",
    "prop_bank": "prop_bank.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# kernel name -> launches since the last reset; each wrapper adds one
# right where it launches its kernel, and nowhere else
launch_counts = {
    "dyn_assembly": 0, "prop_bank": 0, "kkt_fwd_sweep": 0, "kkt_bwd_sweep": 0,
    "kkt_rhs_fwd_sweep": 0, "kkt_fwd_step": 0, "kkt_bwd_step": 0,
}

_libs: dict = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name):
    src = _CSRC / SOURCES[name]
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def _start(name):
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out


def _finish(name, job):
    proc, tmp, out = job
    log = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every kernel source in parallel; returns the wall seconds."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    return time.perf_counter() - t0


def library(name) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    if name not in _libs:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        _libs[name] = ctypes.CDLL(str(_target(name)[1]))
    return _libs[name]


def build_other(source, tag) -> ctypes.CDLL:
    """Another kernel source with the same C interface (another commit's,
    say), compiled with the port's flags into build/kernels/lib<tag>_other.so
    and loaded."""
    out = BUILD_DIR / f"lib{tag}_other.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def check(err: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if err == 9:  # cudaErrorInvalidConfiguration: the launchers' size refusal
        raise RuntimeError(f"{what}: the blocks do not fit the shared memory of a block")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


if __name__ == "__main__":
    # ptxas resource report of each source given (default: the port's own)
    for src in sys.argv[1:] or [str(_CSRC / f) for f in SOURCES.values()]:
        out = BUILD_DIR / "ptxas_report.so"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), src],
                              capture_output=True, text=True)
        print(f"== {src}\n{proc.stdout}{proc.stderr}", flush=True)
        if proc.returncode != 0:
            sys.exit(proc.returncode)
