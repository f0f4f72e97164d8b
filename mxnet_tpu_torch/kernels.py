"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``mxnet_tpu_torch/_build/`` and loaded with ``ctypes``.  The library's file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  :func:`build` starts one
``nvcc`` per source, all at once, so several kernels build in parallel.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Sequence

from .base import MXNetError

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "build_log",
           "ptxas_report"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
# every kernel source of the package, by the name of its csrc/ file
SOURCES = ("fused_norm", "flash_attention", "layernorm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            ["/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found: the CUDA kernels are built with the "
                         "CUDA toolkit (set CUDA_HOME)")
    return found


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    """Where the library built from the current ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:16]))


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together.  Returns ``{name: path}``;
    raises with the compiler's output when any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = "%s.%d.tmp" % (path, os.getpid())
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _source(n)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for n, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        _LOGS[n] = out
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (n, proc.returncode, out))
            continue
        os.replace(tmp, path)
    if failed:
        raise MXNetError("kernel build failed: " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v`` register and spill report) of
    this process's build of ``name``; empty when it was already built."""
    return _LOGS.get(name, "")


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel symbol: the last name of its
    (possibly nested) name and its integer template arguments, e.g.
    ``flash_bwd_kv_hopper<64,64,3,2>``; the symbol itself where it does not
    parse."""
    m = re.match(r"_ZN?", mangled)
    if m is None:
        return mangled
    pos, name = m.end(), None
    while pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        start = pos + len(digits)
        name = mangled[start:start + int(digits)]
        pos = start + int(digits)
    if name is None:
        return mangled
    args = []
    if mangled[pos:pos + 1] == "I":
        for lit in re.finditer(r"Li(n?\d+)E", mangled[pos + 1:]):
            if lit.start() != sum(len(a) for a in args):
                break
            args.append(lit.group())
    if not args:
        return name
    return "%s<%s>" % (name, ",".join(
        a[2:-1].replace("n", "-") for a in args))


def ptxas_report(log: str):
    """The ``-Xptxas -v`` lines of a build log, one dict a kernel:
    ``{"kernel", "registers", "spill_stores", "spill_loads"}`` in bytes of
    spill, in the order ptxas reports them."""
    out, current = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = {"kernel": _kernel_name(m.group(1)), "registers": None,
                       "spill_stores": 0, "spill_loads": 0}
            out.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _LIBS[name] = ctypes.CDLL(path)
        return lib
