"""Randomized differential fuzzer for the exact engines, on the card.

The port of superman_tpu/tools/fuzz.py: random (size, density,
magnitude, sign, dtype) matrices through random flag combinations,
compared against the f64 oracle (ops/oracle.perman64), with the exact
integer DFS (perman_brute) as arbiter where the oracle itself cancels to
noise, and a noise floor for near-zero permanents set by the tier the
result was walked in (the JAX tool takes the tier asked for, and holds a
tf96 trial on storage that is not exact in float32, which both packages
walk in df64, to tf96's floor).  The draws
are the JAX tool's, draw for draw, so a seed fuzzes the same trials in
both packages; each trial runs through `permanent` on the card: K1 in the
df64, tf96 and f32k tiers, the reduced entry (sparse, dm_prune), the amp
walks and K3 (calc="auto"), and the certification net (compression,
scaling).

    python -m superman_tpu_torch.tools.fuzz [--trials N] [--seed S]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Iterator

import numpy as np

from . import tool_device

EPS = {"f32k": 2 ** -22, "df64": 2 ** -45, "tf96": 2 ** -60,
       "auto": 2 ** -45}


@dataclasses.dataclass
class Trial:
    index: int
    n: int
    d: float
    mag: float
    ftype: bool
    signed: bool
    a: np.ndarray
    calc: str
    kw: dict


def draw_trials(trials: int, seed: int) -> Iterator[Trial]:
    """The trials of a seed, in the JAX tool's draw order."""
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        n = int(rng.integers(19, 24))
        d = float(rng.uniform(0.08, 0.95))
        mag = float(rng.choice([1.0, 1e-12, 1e12, 1e-6]))
        ftype = rng.random() < 0.5
        signed = rng.random() < 0.25
        a = (rng.random((n, n)) < d)
        if ftype:
            v = rng.random((n, n)) * mag
            if signed:
                v = v * rng.choice([-1, 1], (n, n))
            a = (a * v).astype(np.float64)
        else:
            v = rng.integers(1, 5, (n, n))
            if signed:
                v = v * rng.choice([-1, 1], (n, n))
            a = (a * v).astype(np.int64)
        kw = {}
        roll = rng.random()
        if roll < 0.2:
            kw.update(sparse=True, preprocessing=int(rng.integers(0, 8)))
        elif roll < 0.35:
            kw.update(compression=True)
        elif roll < 0.5 and not signed:
            kw.update(scaling_threshold=float(rng.choice([1.0, 2.0])))
        elif roll < 0.6:
            kw.update(perman_algo="glynn")
        elif roll < 0.7:
            kw.update(dm_prune=True, sparse=True)
        if rng.random() < 0.2:
            kw.update(chunk_log2=int(rng.integers(5, 9)), lanes=128)
        calc = str(rng.choice(["df64", "tf96", "auto", "f32k"]))
        if kw.get("compression") and calc == "f32k":
            # d1/d2 merges multiply entries, inflating the noise floor of
            # the f32-class tiers beyond what the ORIGINAL matrix's
            # termmax bounds: compression is fuzzed at the double tiers
            calc = "df64"
        yield Trial(trial, n, d, mag, ftype, signed, a, calc, kw)


def ran_tier(calc: str, algo_name: str) -> str:
    """The tier a trial's result was walked in: calc="tf96" on storage
    that is not exact in float32 walks df64 (with a warning, in both
    packages), and its Result says so."""
    return "df64" if calc == "tf96" and algo_name.endswith("_df64") else calc


def agrees(t: Trial, got: float, tier: str, want: float) -> bool:
    """`got` of trial t, walked in `tier`, against the f64 oracle's
    `want`: within 1e-3 (f32k) or 1e-6 relative, or within the tier's
    noise floor EPS[tier] times the largest term's bound; the exact DFS
    arbitrates sparse trials, where the oracle itself cancels to
    noise."""
    from ..ops.oracle import perman_brute
    a = t.a
    with np.errstate(over="ignore"):
        termmax = float(np.prod(np.abs(a).sum(axis=1) / 2
                                + np.abs(a[:, -1])))
    floor = EPS[tier] * termmax if np.isfinite(termmax) else 0.0
    tol = 1e-3 if tier == "f32k" else 1e-6
    if np.isinf(want) or np.isinf(got):
        # an inf is acceptable where the tier's noise floor swamps the
        # true answer and an exact-preserving rescale could amplify that
        # noise past double range
        ok = (np.isinf(want) == np.isinf(got)
              or (np.isinf(got) and floor >= abs(want)))
    else:
        ok = abs(got - want) <= max(tol * abs(want), floor)
    if not ok and t.d < 0.35:
        exact = float(perman_brute(a))
        ok = abs(got - exact) <= max(tol * abs(exact), floor)
    return ok


def run(trials: int = 40, seed: int = 0, device=None, log=print) -> int:
    """Fuzz `trials` trials of `seed` on `device`; return the failures."""
    dev = tool_device(device)
    import superman_tpu_torch as spt
    from ..ops.oracle import perman64

    fails = 0
    for t in draw_trials(trials, seed):
        calc, kw = t.calc, t.kw
        try:
            want = float(perman64(t.a))
            res = spt.permanent(t.a, device=dev, calc=calc, **kw)
        except Exception as e:                 # noqa: BLE001 -- reported
            fails += 1
            log(f"RAISE trial={t.index} calc={calc} kw={kw}: "
                f"{type(e).__name__}: {e}")
            continue
        tier = ran_tier(calc, res.algo_name)
        if not agrees(t, res.permanent, tier, want):
            fails += 1
            log(f"FAIL trial={t.index} n={t.n} d={t.d:.2f} mag={t.mag:g} "
                f"signed={t.signed} ftype={t.ftype} calc={calc} "
                f"({res.algo_name}) kw={kw} want={want:.6e} "
                f"got={res.permanent:.6e}")
    log(f"fuzz: {trials - fails}/{trials} ok on {dev}")
    return fails


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superman-torch-fuzz",
                                description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    args = p.parse_args(argv)
    return 1 if run(args.trials, args.seed, args.device) else 0


if __name__ == "__main__":
    sys.exit(main())
