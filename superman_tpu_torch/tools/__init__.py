"""Tools of the port: timing and counting scripts for the kernels, and the
JAX package's tools (superman_tpu/tools/) on the port's engine.

Every tool runs on the card unless its caller names another device
(`device=` in its functions, `--device` on its command line); the card is
`cuda:0`, and without CUDA the tools raise as `api.resolve_device` does.
`device="cpu"` runs the kernels' plain versions.  The tools that read a
corpus take `--root` and otherwise read the seeded corpus of `corpus.py`;
what they write by default goes under `build/tools/` of the checkout,
under names of their own.
"""

from __future__ import annotations

from pathlib import Path

#: where the tools write by default
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "tools"


def out_path(name: str) -> str:
    """build/tools/<name> of the checkout, the directory made."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    return str(OUT_DIR / name)


def tool_device(device=None):
    """The torch device a tool runs on: cuda:0 for None, raising without
    CUDA; "cpu" runs the plain versions."""
    from ..api import resolve_device
    from ..core.flags import Flags
    return resolve_device(device, Flags())
