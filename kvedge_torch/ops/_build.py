"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel source under ``ops/csrc`` has a plain C entry point. At
first use it is compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

into ``build/kvedge_torch/`` at the repository root (``build/`` is
git-ignored), named by a hash of the source with the local headers it
includes (``csrc/*.cuh``) so an edited kernel or header never loads a
stale library, and loaded with ``ctypes``. Nothing here links
against PyTorch: the wrappers pass ``tensor.data_ptr()`` and the current
stream's handle as integers. Importing this module compiles nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kvedge_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when reused), "log": nvcc output}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "source at first use and need the CUDA toolkit"
    )


_LOCAL_INCLUDE = re.compile(r'^#include "([^"]+)"[ \t]*$', re.M)


def expand_includes(path: pathlib.Path) -> str:
    """The text nvcc reads for the source at ``path``: each local
    ``#include "x.cuh"`` replaced by that header's text (its ``#pragma
    once`` line dropped), once per header, the header taken from beside
    ``path`` where it is there and from ``csrc/`` otherwise. A copy of it
    builds anywhere."""
    seen = set()

    def expand(text: str) -> str:
        def one(m):
            header = m.group(1)
            if header in seen:
                return ""
            seen.add(header)
            found = path.parent / header
            body = (found if found.exists() else CSRC / header).read_text()
            return expand(body.replace("#pragma once\n", ""))
        return _LOCAL_INCLUDE.sub(one, text)

    return expand(path.read_text())


def source(name: str) -> str:
    """``csrc/<name>.cu`` with its local headers inlined
    (:func:`expand_includes`)."""
    return expand_includes(CSRC / f"{name}.cu")


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(source(name).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless the library for its current
    source already exists; returns the library path."""
    out = library_path(name)
    if out.exists():
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    build_info[name] = {"seconds": seconds,
                        "log": (proc.stdout + proc.stderr).strip()}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def on_cuda(what: str, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA, got {t.device}")
    return True


def launch(name: str, what: str, symbol: str, argtypes, args,
           shape_note: str, device) -> None:
    """Call the C entry point ``symbol`` of ``csrc/<name>.cu`` on
    ``device`` (the card its tensors are on, made the calling thread's
    current device for the call: a runtime launch goes to the current
    device) and raise unless it returned 0 (launched): a negative code
    is a shape the kernel does not take, a positive one
    ``cudaGetLastError()``."""
    import torch

    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{'unsupported shape' if rc < 0 else f'CUDA error {rc}'} "
            f"({shape_note})")
