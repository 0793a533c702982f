"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/`` beside this file, at first use.  The library name carries a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header is rebuilt and a stale library is never
loaded.  :func:`build` starts one ``nvcc`` per
source, all at once, and waits for them; :func:`load` returns the
``ctypes`` handle.  A missing ``nvcc`` or a failed build raises.

The host libraries (``HOST_SOURCES``: ``csrc/host_partition.cpp``, the
partitioner; ``csrc/host_sample.cpp``, the typed, temporal, HGT and ego
samplers; and ``csrc/host_spgemm.cpp``, the Gustavson SpGEMM) are plain
C++ for the CPU, copies of parts of the JAX package's
``csrc/native.cpp``, compiled by ``$CXX`` (else ``c++`` from ``PATH``)
with :func:`host_flags` into ``build/`` under the same hash naming, at
first use, beside the kernels.  They need no GPU: the CPU tests build
them too.  A missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("csr_spmm", "block_spmm", "edge_dot", "spmm_minmax",
           "edge_softmax", "plan_numeric", "block_spgemm", "random_walk",
           "shard_spmm", "smem_gather")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCES = ("host_partition", "host_sample", "host_spgemm")
# The JAX package's native build flags (its ``csrc/build.sh``), so that
# the host libraries do the same arithmetic as its native library; ISO C++
# already keeps FMA contraction off in GCC, and ``-ffp-contract=off``
# says so to any other compiler.
HOST_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared",
              "-std=c++17", "-ffp-contract=off")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc was not found (looked in $CUDA_HOME/bin, /usr/local/cuda/"
            "bin and PATH); the CUDA kernels cannot be built")
    return found


def cxx_path() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` from ``PATH``."""
    cxx = os.environ.get("CXX") or "c++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"the host C++ compiler {cxx!r} was not found ($CXX, else c++ "
            "from PATH); the host libraries cannot be built")
    return found


@functools.lru_cache(maxsize=None)
def host_flags() -> Tuple[str, ...]:
    """``HOST_FLAGS``, less ``-fopenmp`` where the compiler cannot build
    OpenMP code (a toolchain without the OpenMP runtime's development
    files).  The host sources are written for both: without OpenMP the
    threaded entry runs the serial pipeline."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe = _BUILD_DIR / f"openmp-probe.{os.getpid()}"
    src = probe.with_suffix(".cpp")
    src.write_text("#include <omp.h>\n"
                   "extern \"C\" int probe() {\n"
                   "  return omp_get_max_threads();\n}\n")
    try:
        done = subprocess.run(
            [cxx_path(), "-fopenmp", "-fPIC", "-shared", "-o",
             str(probe.with_suffix(".so")), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    finally:
        src.unlink(missing_ok=True)
        probe.with_suffix(".so").unlink(missing_ok=True)
    if done.returncode == 0:
        return HOST_FLAGS
    return tuple(f for f in HOST_FLAGS if f != "-fopenmp")


def library_path(name: str) -> Path:
    if name in HOST_SOURCES:
        src = (_SRC_DIR / f"{name}.cpp").read_bytes()
        flags = host_flags()
    else:
        src = (_SRC_DIR / f"{name}.cu").read_bytes()
        for header in sorted(_SRC_DIR.glob("*.cuh")):
            src += header.read_bytes()
        flags = NVCC_FLAGS
    digest = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()
    return _BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (register and
    shared-memory use from ``-Xptxas -v``), or "" if it was not built
    in this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _command(name: str, tmp: Path):
    if name in HOST_SOURCES:
        return [cxx_path(), *host_flags(), "-o", str(tmp),
                str(_SRC_DIR / f"{name}.cpp")]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
            str(_SRC_DIR / f"{name}.cu")]


def build(names: Iterable[str] = SOURCES + HOST_SOURCES) -> Dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, with
    one compiler process per source running in parallel (``nvcc`` for
    the kernels, the host C++ compiler for ``HOST_SOURCES``).  Each
    writes a file of its own and renames it into place, so that
    processes building at once never load a partial library."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    tmps = {n: out.with_name(f"{out.name}.{os.getpid()}.tmp")
            for n, out in todo.items()}
    cmds = {n: _command(n, tmp) for n, tmp in tmps.items()}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: (tmps[n], subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for n, cmd in cmds.items()}
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out = todo[name]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("library build failed: " + "\n".join(failures))
    return paths




def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or of the host source
    ``csrc/<name>.cpp``), built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        if name not in HOST_SOURCES:
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
