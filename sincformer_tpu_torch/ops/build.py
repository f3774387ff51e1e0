"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
by ``nvcc`` for ``sm_90a`` into ``sincformer_tpu_torch/_build/`` (listed in
``.gitignore``). The library's file name carries a hash of its source and
of the ``csrc/`` headers it includes (``#include "..."``, followed through
headers that include others), so an edited kernel or header is rebuilt and
a stale library is never loaded. Nothing here runs at import time: the CPU
tests import every module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of sincformer_tpu_torch "
                       "are built from csrc/ at first use and need the CUDA "
                       "toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> Dict[str, bytes]:
    """``csrc/<name>.cu`` and every ``csrc/`` file it includes with quotes,
    directly or through another header: {file name: contents}."""
    found: Dict[str, bytes] = {}
    todo = [f"{name}.cu"]
    while todo:
        fname = todo.pop()
        if fname in found:
            continue
        with open(os.path.join(CSRC, fname), "rb") as f:
            found[fname] = f.read()
        todo.extend(inc.decode() for inc in
                    _LOCAL_INCLUDE.findall(found[fname]))
    return found


def _library_path(name: str) -> str:
    """Path of the shared library built from ``csrc/<name>.cu``."""
    h = hashlib.sha1()
    for fname, text in sorted(_sources(name).items()):
        h.update(fname.encode() + b"\0" + text + b"\0")
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile several ``csrc/<name>.cu`` at once, one ``nvcc`` process each,
    all started together (default: every source in ``csrc/``); libraries
    that exist are kept. Returns {name: library path}.

    The compiler's resource report (``-Xptxas -v``) is kept beside each
    library as ``<library>.log``.
    """
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    paths = {name: _library_path(name) for name in names}
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for name, out in paths.items():
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        running.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu:\n{stderr}")
            continue
        with open(out + ".log", "w") as f:
            f.write(stdout + stderr)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns its
    path."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(build(name))
