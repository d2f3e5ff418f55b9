"""Build and load the package's CUDA C++ kernels.

Each source under ``kernels/csrc/`` (``flash_attention.cu``,
``ssd_scan.cu``, ``optim.cu``) is compiled by its own ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers: seconds to build, not minutes).  The build
happens at first use, into ``build/cuda/`` beside ``src/`` (git-ignored),
under a name keyed by the hash of the source, of every header in
``csrc/`` (``hopper.cuh`` is shared) and of the flags, so an edited source
or header is rebuilt and an unchanged one is loaded as it is.  A missing
``nvcc`` or a failed build raises.  ``ptxas -v`` runs with every build and
its report is kept beside the library (:func:`ptxas_report`: each
kernel's registers and spills).

``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

import torch

__all__ = ["load", "call", "on", "plain", "ptxas_report"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    _HERE))), "build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, path), "rb") as f:
            digest.update(path.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path."""
    lib = _library_path(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {done.returncode}):\n{done.stderr}")
    with open(lib + ".ptxas.txt", "w") as f:
        f.write(done.stderr)
    os.replace(tmp, lib)      # atomic: a reader sees a whole library or none
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it first if
    needed."""
    return ctypes.CDLL(_build(name))


def ptxas_report(name: str, match: str = "kernel") -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from the
    ``ptxas -v`` report of ``csrc/<name>.cu``'s build (built first if
    needed), for the kernels whose mangled name holds ``match``; a kernel
    reads as its name and its template arguments, e.g.
    ``fa_fwd_tc_kernel<4>``."""
    _build(name)
    out, props = {}, {}
    with open(_library_path(name) + ".ptxas.txt") as f:
        lines = f.read().splitlines()
    current = None
    for line in lines:
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            current = m.group(1)
            continue
        if current is None or match not in current:
            continue
        short = _short_name(current)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            props.setdefault(short, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            props.setdefault(short, {})["registers"] = int(m.group(1))
    for k in sorted(props):
        out[k] = props[k]
    return out


def _short_name(mangled: str) -> str:
    """``..._17fa_bwd_dkv_kernelIfLi256EE...`` → ``fa_bwd_dkv_kernel<f,256>``:
    the identifier is the one whose length prefix matches it."""
    end = mangled.find("_kernelI")
    if end < 0:
        return mangled
    end += len("_kernel")
    for n in range(len("_kernel") + 1, end):
        if mangled[:end - n].endswith(str(n)):
            name = mangled[end - n:end]
            break
    else:
        return mangled
    m = re.match(r"I((?:Li\d+E|[a-z])+)E", mangled[end:])
    args = [a or b for a, b in re.findall(r"Li(\d+)E|([a-z])",
                                          m.group(1) if m else "")]
    return f"{name}<{','.join(args)}>"


def call(fn, *args) -> None:
    """Call a launcher of a built library and raise on the CUDA error it
    returns: a refused launch never runs, and no synchronise reports it."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")


def on(device):
    """The device guard of a launch: none when ``device`` is the current
    device (entering ``torch.cuda.device`` costs every launch host time)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def plain(name: str, *tensors) -> None:
    """Raise where an operand is a functorch wrapper (a vmap
    ``BatchedTensor``, a grad-tracking wrapper): a launch reads the memory
    behind a data pointer, which for a wrapper is not the logical tensor.
    Under vmap a kernel is reached through its folding rule
    (:mod:`repro_torch.kernels.ops`), which hands the wrapper plain
    tensors."""
    for t in tensors:
        if torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise RuntimeError(f"{name}: an operand is a functorch wrapper; "
                               f"call the kernel through its vmap rule "
                               f"(repro_torch.kernels.ops)")
