"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` source under its package's ``csrc/`` with a plain
C interface.  ``build`` compiles every source that has no library yet, one
``nvcc`` per source, all started together, into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``).  A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is reused.  ``load`` builds on first use and opens the
library with ``ctypes``.

``launches`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
SOURCES = {
    "flash_attention": _KERNELS / "flash_attention" / "csrc" / "flash_attention.cu",
    "flash_attention_wgmma":
        _KERNELS / "flash_attention" / "csrc" / "flash_attention_wgmma.cu",
    "rglru_scan": _KERNELS / "rglru_scan" / "csrc" / "rglru_scan.cu",
    "rglru_scan_grouped":
        _KERNELS / "rglru_scan" / "csrc" / "rglru_scan_grouped.cu",
    "wkv6": _KERNELS / "rwkv6_chunk" / "csrc" / "wkv6.cu",
    "wkv6_chunk": _KERNELS / "rwkv6_chunk" / "csrc" / "wkv6_chunk.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

launches: collections.Counter = collections.Counter()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path(name: str) -> Path:
    key = SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What nvcc (with ``-Xptxas -v``: registers, shared memory, spills)
    printed when the library was built."""
    return library_path(name).with_suffix(".log").read_text()


def resources(name: str) -> list:
    """(kernel function, its ``Used ... registers`` line, its spill line)
    for each kernel function of the library, from its build log."""
    found, fn, spill = [], None, ""
    for line in build_log(name).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and fn:
            found.append([fn, line.split(":", 1)[1].strip(), spill])
            fn = None
    demangle = shutil.which("c++filt")
    if demangle and found:
        names = subprocess.run([demangle], input="\n".join(f[0] for f in found),
                               capture_output=True, text=True).stdout.split("\n")
        for f, n in zip(found, names):
            short = re.search(r"(\w+(<[^>]*>)?)\(", n)    # name<args>(...
            f[0] = short.group(1) if short else (n or f[0])
    return [tuple(f) for f in found]


def build(names=None) -> list:
    """Compile the libraries of ``names`` (default: all) that are missing.

    Returns the names that were compiled.  Raises if any compile fails.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)      # atomic: another process sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return [name for name, *_ in jobs]


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
