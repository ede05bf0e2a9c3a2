"""Build the port's native sources into shared libraries, keyed by hash.

Each library lands in ``pseudocylindrical_convolution_torch/_build/`` under
a name that hashes its sources and the headers they include, the full
command line, the compiler's own ``--version`` text and
``platform.machine()``. A library is reused only on
an exact key match -- never on a file time -- so a library built on one
host is never loaded on another with another compiler. Builds write a
temporary file and rename it into place, so concurrent processes are safe.
"""

from __future__ import annotations

import functools
import hashlib
import os
import platform
import shutil
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")


@functools.lru_cache(maxsize=None)
def _version(tool: str) -> str:
    return subprocess.run([tool, "--version"], capture_output=True,
                          text=True, check=True).stdout


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, else $PATH, else /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source on the machine with the card")


def library_key(sources, headers, cmd: list[str], compiler_version: str,
                csrc: str = CSRC) -> str:
    """The cache key of a library: the bytes of its sources and of the
    headers they include (paths under ``csrc``), the command line, the
    compiler's ``--version`` text and the host's machine type."""
    h = hashlib.sha256()
    for role, names in ((b"src", sources), (b"hdr", headers)):
        for s in names:
            with open(os.path.join(csrc, s), "rb") as f:
                h.update(role + b"\0" + s.encode() + b"\0" + f.read())
    h.update("\0".join(cmd).encode())
    h.update(compiler_version.encode())
    h.update(platform.machine().encode())
    return h.hexdigest()[:20]


def build_library(name: str, sources: list[str], cmd: list[str],
                  headers: tuple[str, ...] = ()) -> str:
    """Compile ``sources`` (paths under csrc/) with ``cmd`` (compiler and
    flags, without -o) into a cached shared library; returns its path.
    ``headers`` are the csrc/ headers the sources include: they are not
    compiled on their own, but an edit to one changes the key."""
    key = library_key(sources, headers, cmd, _version(cmd[0]))
    out = os.path.join(BUILD_DIR, f"{name}-{key}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run(cmd + ["-o", tmp]
                         + [os.path.join(CSRC, s) for s in sources],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {name} failed:\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out
