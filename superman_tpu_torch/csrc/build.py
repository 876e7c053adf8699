"""Build and load the port's CUDA kernels.

The sources in this directory are compiled by nvcc for sm_90a, one nvcc
per source and all at once, and linked into one shared library with a
plain C interface, loaded with ctypes.  Every launch goes through call(),
which takes each entry's signature from one table (SIGNATURES) and counts
the launch in one counter (LAUNCHES).  The build runs at first use, goes
to ``build/superman_tpu_torch/<hash>/`` at the root of the checkout, and
is keyed by a hash of the sources, the headers and the flags, so an edited
source or header rebuilds.  A failed build or load raises; nothing falls
back to the plain versions.

Usage: python -m superman_tpu_torch.csrc.build   (prints the library path
and the compiler's register/shared-memory report)
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
SOURCES = (HERE / "ryser_walk.cu", HERE / "ryser_batch.cu",
           HERE / "modp_walk.cu")
HEADERS = (HERE / "walk.cuh", HERE / "device_guard.cuh")
BUILD_ROOT = HERE.parents[1] / "build" / "superman_tpu_torch"
LIB_NAME = "libsuperman_tpu_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def tool(name: str) -> str:
    """The path of a CUDA toolkit program (nvcc, cuobjdump): on PATH, or
    under $CUDA_HOME (or $CUDA_PATH, or /usr/local/cuda)/bin."""
    found = shutil.which(name)
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get(
        "CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: put it on PATH or set "
                           f"CUDA_HOME")
    return path


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compile the library unless this source hash is already built.
    Returns (path, compiler report); the report is empty on a cache hit."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return str(lib), ""
    out_dir.mkdir(parents=True, exist_ok=True)
    # one nvcc per source, all started together; objects and the library
    # go to a private directory and the library is renamed into place, so
    # a concurrent build never sees a half-written one
    nvcc = tool("nvcc")
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs = [os.path.join(tmp_dir, src.stem + ".o") for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        report = ""
        failed = []
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            report += out
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(tmp_dir, LIB_NAME)
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return str(lib), report + proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process."""
    return ctypes.CDLL(build()[0])


_P, _I, _LL, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_uint)

#: each C entry's arguments before the (device, stream) that every entry
#: takes last; every entry returns an int, cudaGetLastError() of its launch
SIGNATURES = {
    # ids, num_chunks, x0, cols, n, n_pad, r, tier, out
    "ryser_walk": (_P, _LL, _P, _P, _I, _I, _I, _I, _P),
    # rows, num_rows, num_chunks, lanes, x0, cols, n, n_pad, r, tier, out
    "ryser_walk_blocks": (_P, _LL, _LL, _I, _P, _P, _I, _I, _I, _I, _P),
    # ids, num_chunks, x0, cols, fx0, fcols, nf, n, n_pad, r, tier, out
    "ryser_walk_reduced": (_P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P),
    # x0s, colss, batch, n, n_pad, r, tier, out
    "ryser_batch": (_P, _P, _I, _I, _I, _I, _I, _P),
    # ids, num_chunks, x0, cols, n, n_pad, r, p, pinv, r2, out
    "modp_walk": (_P, _LL, _P, _P, _I, _I, _I, _U, _U, _U, _P),
}

#: kernel launches by (entry, tier): entries "walk" (ryser_partials),
#: "blocks" (ryser_blocks), "reduced", "amp", "amp_cond", "batch" and
#: "modp"; tier None where the entry has none (amp, amp_cond, modp).  A run
#: reads it to show that a path went through the kernels
LAUNCHES: collections.Counter = collections.Counter()


def launches(*entries: str, tier=None) -> int:
    """The launches of `entries` (every entry if none is named), of `tier`
    alone unless it is None."""
    return sum(k for (e, t), k in LAUNCHES.items()
               if (not entries or e in entries) and tier in (None, t))


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    fn = getattr(load(), symbol)
    fn.argtypes = [*SIGNATURES[symbol], _I, _P]
    fn.restype = _I
    return fn


def on_card(t: torch.Tensor) -> bool:
    """True where `t` is on a CUDA device, so the kernel runs; False on
    the CPU, where its plain version runs; ValueError on any other
    device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def call(symbol: str, *args, device: torch.device, count: tuple) -> None:
    """Launch the C entry `symbol` on `device`'s current stream: `args` (a
    tensor as its data pointer), then the device's index and the stream.
    Raises RuntimeError on a nonzero return code; counts the launch in
    LAUNCHES under count, an (entry, tier) key."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _entry(symbol)(*(a.data_ptr() if isinstance(a, torch.Tensor)
                          else a for a in args), device.index, stream)
    if rc != 0:
        entry, tier = count
        label = f"{symbol} ({entry}{'' if tier is None else ', ' + tier})"
        raise RuntimeError(f"{label} launch failed: CUDA error {rc}")
    LAUNCHES[count] += 1


if __name__ == "__main__":
    path, report = build()
    print(report, end="")
    print(path)
