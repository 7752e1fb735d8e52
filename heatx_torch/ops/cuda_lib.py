"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``heatx_torch/csrc/`` has a plain C interface and is
compiled with ``nvcc`` into its own shared library, loaded with ``ctypes``.
The build runs at first use, from the sources in the package only, into
``heatx_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of the
sources and the compiler flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# sm_90a (not sm_90) keeps Hopper's wgmma/setmaxnreg available to later
# kernels; -Xptxas -v writes each kernel's registers, shared memory and
# spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict = {}


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a GPU raises (the
    port never carries on on the CPU instead)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch twins on the CPU"
        )
    return device


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location.  Raises when neither exists (no fallback)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


@functools.lru_cache(maxsize=None)
def nvcc_flags() -> tuple:
    """``NVCC_FLAGS`` plus, where this nvcc has it, ``-split-compile 0``: the
    optimizer then works on a source's kernels on all CPUs at once, which
    matters for the adjoint's eight instantiations (the TR-BDF2 kernels come
    out with the same registers and stack either way)."""
    helped = subprocess.run([nvcc_path(), "--help"], capture_output=True, text=True).stdout
    return NVCC_FLAGS + (("-split-compile", "0") if "--split-compile " in helped else ())


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(nvcc_flags()).encode())
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    for path in list(sources) + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_many(specs) -> list:
    """Compile each ``(name, sources)`` of ``specs`` (paths under csrc/) into
    ``lib<name>_<hash>.so`` unless that file exists: one nvcc per source (a
    library's sources are its compilation units), all started together, then
    one link per library; returns their paths.  The compilers' output is kept
    beside each library as ``.log``."""
    outs, jobs, links = [], [], []
    compile_flags = [f for f in nvcc_flags() if f != "-shared"]
    for name, sources in specs:
        sources = [Path(s) for s in sources]
        out = BUILD_DIR / f"lib{name}_{_digest(sources)}.so"
        outs.append(out)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        objs = []
        for src in sources:
            obj = out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o")
            cmd = [nvcc_path(), *compile_flags, "-c", "-o", str(obj), str(src)]
            jobs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        links.append((name, out, objs))
    logs, failed, broken = {}, [], set()
    for name, proc in jobs:
        stdout, stderr = proc.communicate()
        logs[name] = logs.get(name, "") + stdout + stderr
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {name}:\n{stderr[-4000:]}")
            broken.add(name)
    for name, out, objs in links:
        if name not in broken:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run([nvcc_path(), "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            logs[name] += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) linking {name}:\n{proc.stderr[-4000:]}")
            else:
                os.replace(tmp, out)
        out.with_suffix(".log").write_text(logs[name])
        for obj in objs:
            obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str, sources) -> Path:
    """Compile one library (see :func:`build_many`); returns its path."""
    return build_many([(name, sources)])[0]


def load(name: str, sources) -> ctypes.CDLL:
    """Build (if needed) and load a kernel library once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, sources)))
        _LOADED[name] = lib
    return lib


def build_log(name: str, sources) -> str:
    """The compiler output of the current build of ``name`` ('' if none)."""
    sources = [Path(s) for s in sources]
    log = (BUILD_DIR / f"lib{name}_{_digest(sources)}.so").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check_operands(expect: dict, device: torch.device) -> None:
    """Raise unless every ``name: (tensor, shape, dtype)`` of ``expect`` is a
    contiguous CUDA tensor of that shape and dtype on ``device``."""
    for name, (t, shape, dtype) in expect.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
                f"{'contiguous' if t.is_contiguous() else 'strided'} {t.dtype} {tuple(t.shape)}"
            )
