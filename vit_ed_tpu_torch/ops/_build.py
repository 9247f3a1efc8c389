"""Build and load the port's compiled code.

Two kinds of source, one policy:

- the CUDA kernels: each source under ``vit_ed_tpu_torch/csrc/`` is compiled
  with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
  interface (no PyTorch headers, so a build takes seconds), named by a hash
  of the source, the shared headers (``*.cuh``) and the flags (``build``,
  ``load``);
- the native host code (``vit_ed_tpu_torch/native/pipeline.cc``): compiled
  with ``g++``, named also by the host CPU, because ``-march=native`` makes
  a library built on one host unsafe to load on another and a checkout may
  be copied between machines with its build directory (``load_host``).

Libraries land in ``vit_ed_tpu_torch/build/`` (git-ignored). A compile
writes a temporary file and ``os.replace``s it, so a concurrent process
never loads a half-written library; a cached library that does not load
(an interrupted copy) is rebuilt once. A failed compile raises with the
compiler's output. Nothing is built when a module is imported: the first
call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build of each source printed (nvcc -Xptxas -v: registers,
# shared memory and spills per kernel) and how long it took
build_log: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the port's CUDA kernels are "
        "built from vit_ed_tpu_torch/csrc at first use")


def host_cpu() -> str:
    """The CPU ``-march=native`` compiles for: /proc/cpuinfo's model name
    and feature flags, where the host has them."""
    try:
        with open("/proc/cpuinfo") as f:
            first = f.read().split("\n\n")[0]
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    fields = dict((k.strip(), v.strip()) for k, v in
                  (line.split(":", 1) for line in first.splitlines() if ":" in line))
    return " | ".join(fields.get(k, "") for k in ("model name", "flags"))


def _named(stem: str, flags: Sequence[str], files: Iterable[str]) -> str:
    """The library path of ``stem``: a hash of the flags and the files."""
    digest = hashlib.sha256("\0".join(flags).encode())
    for path in files:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:12]}.so")


def _compile(cmd: Callable[[str], List[str]], out: str, name: str) -> str:
    """Run ``cmd(tmp)``, which writes the library to ``tmp``, and move it to
    ``out``; returns the compiler's output, raises with it on failure."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    argv = cmd(tmp)
    res = subprocess.run(argv, capture_output=True, text=True)
    text = res.stdout + res.stderr
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{os.path.basename(argv[0])} failed on {name}:\n{text}")
    os.replace(tmp, out)
    return text


def _open(out: str, compile_: Callable[[], object]) -> ctypes.CDLL:
    """The loaded library at ``out``, compiled first unless it is built."""
    if not os.path.exists(out):
        compile_()
    try:
        return ctypes.CDLL(out)
    except OSError:
        # a corrupt cached library (an interrupted copy): rebuild it once
        compile_()
        return ctypes.CDLL(out)


def _kernel_path(source: str) -> str:
    # the source and every header beside it (attention_mma.cuh)
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return _named(os.path.splitext(source)[0], NVCC_FLAGS,
                  [os.path.join(CSRC, f) for f in (source, *headers)])


def _nvcc(source: str) -> str:
    out = _kernel_path(source)
    t0 = time.time()
    try:
        build_log[source] = _compile(
            lambda tmp: [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                         os.path.join(CSRC, source)], out, source)
    finally:
        build_seconds[source] = time.time() - t0
    return out


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library is already built;
    returns the library path."""
    out = _kernel_path(source)
    return out if os.path.exists(out) else _nvcc(source)


def build_all() -> Dict[str, str]:
    """Build every kernel source under csrc/ at once, one nvcc process per
    source, all started together."""
    sources = sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(zip(sources, pool.map(build, sources)))


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = _open(_kernel_path(source),
                                        lambda: _nvcc(source))
        return lib


def host_lib_path(src: str, flags: Sequence[str]) -> str:
    """The library path of the host source ``src`` built with ``flags``."""
    return _named(os.path.splitext(os.path.basename(src))[0],
                  [*CXX_FLAGS, *flags, host_cpu()], [src])


def load_host(src: str, flags: Sequence[str]) -> ctypes.CDLL:
    """The loaded library of the host source ``src`` built with ``g++`` and
    ``flags`` (``-l`` flags are linked after the source), compiled unless
    it is in the build directory already."""
    out = host_lib_path(src, flags)
    # libraries must FOLLOW the source, or the linker records no DT_NEEDED
    # for them and dlopen fails with unresolved symbols
    libs = [f for f in flags if f.startswith("-l")]
    opts = [f for f in flags if not f.startswith("-l")]
    return _open(out, lambda: _compile(
        lambda tmp: ["g++", *CXX_FLAGS, *opts, src, "-o", tmp, *libs], out, src))
