"""The SUPERMAN_DEBUG_NANS switch: fail fast on a NaN that a device
computation hands back.

The port of ``superman_tpu/__init__.py:35-39``, where a non-empty
SUPERMAN_DEBUG_NANS turns on ``jax_debug_nans`` when the package is
imported.  This package changes no global configuration at import, so
the variable is read at call time, by every check: setting or unsetting
it takes effect at the next call.

Like ``jax_debug_nans`` the checks look for NaN only.  The reference's
comment says "NaN/Inf", but Inf is ``jax_debug_infs``, which the
reference never sets: an Inf output passes here as it passes there.

Where an output is copied to the host anyway (the walks' words, for the
host sum) its host array is checked, so the switch adds no device work;
where it stays on the device (the float64 walk's lane sums, the
estimators' trial tensors) the check is one ``torch.isnan(t).any()`` and
one wait for the device.  With the variable unset a check reads the
environment and returns.

A NaN entry of the input never gets this far: ``permanent`` and
``permanent_batch`` reject non-finite entries with a ValueError first
(``core.matrix.require_finite``), whatever the switch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

#: any non-empty value turns the checks on, as in the reference
ENV = "SUPERMAN_DEBUG_NANS"


def debug_nans() -> bool:
    """Whether SUPERMAN_DEBUG_NANS is set to a non-empty value now."""
    return bool(os.environ.get(ENV))


def check_nan(name: str, x) -> None:
    """Under SUPERMAN_DEBUG_NANS, raise FloatingPointError if x (a torch
    tensor or a numpy array) holds a NaN; `name` says which computation
    gave it (the kernel and its tier).  Without the switch, nothing."""
    if not debug_nans():
        return
    bad = (torch.isnan(x).any() if isinstance(x, torch.Tensor)
           else np.isnan(x).any())
    if bool(bad):
        raise FloatingPointError(
            f"invalid value (nan) in the output of {name}")
