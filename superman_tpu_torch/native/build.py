"""Build the native CPU engine (perman_cpu.cpp) as a shared library.

g++ compiles the source beside this file with the flags below into
``build/superman_tpu_torch/native/<hash>/`` at the root of the checkout,
keyed by a hash of the source, the header, the flags and the target that
``-march=native`` resolves to on this host (g++ -Q --help=target), so an
edited source rebuilds, an unchanged one is built once, and a library
built for another processor is never loaded here.  The library is
written to a private temporary file and renamed into place, so several
processes building at once never load a half-written one.  A failed build
raises with the compiler's output.

Usage: python -m superman_tpu_torch.native.build   (prints the path)
The bindings (bindings/native.py) build it at first use.
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "perman_cpu.cpp"
HEADER = HERE / "superman_native.h"
BUILD_ROOT = HERE.parents[1] / "build" / "superman_tpu_torch" / "native"
LIB_NAME = "libsuperman_cpu.so"
FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fopenmp", "-shared",
         "-fPIC")


def _target() -> str:
    """What -march=native means on this host, as g++ reports it."""
    try:
        proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++: {e}") from e
    return proc.stdout


@functools.lru_cache(maxsize=None)
def _key() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_target().encode())
    for path in (SRC, HEADER):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the library unless this hash is built; returns its path."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return str(lib)
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        cmd = ["g++", *FLAGS, str(SRC), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run g++: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(lib)


if __name__ == "__main__":
    print(build())
