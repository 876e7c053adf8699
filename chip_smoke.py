"""Smoke test of superman_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against
its plain PyTorch version on the card at its path's shapes, drives the
two paths through superman_tpu_torch.permanent at n=32 -- calc="df64"
(the Ryser walk, csrc/ryser_walk.cu) and calc="exact" (the Z_p walk,
csrc/modp_walk.cu, under the modular CRT engine) -- and checks their
values, times kernels and plain versions, and prints:

  * the card's `name, power.limit` (nvidia-smi);
  * one JSON line {"kernels": [...]} with each kernel's launches on its
    path, its largest difference from the plain version and both times;
  * last, {"ok": true, "device": {...}}.

Any failure raises, so the exit code is not 0 and no last line is
printed.  Without CUDA it exits with code 2 before doing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 32
#: per(A) of random_int_matrix(np.random.default_rng(32), 32, 0.5), the
#: n=32 main-path matrix, from the JAX package's native C++ double engine
#: (OpenMP, long-double accumulation):
#:   superman_tpu.bindings.native.load().sup_perman_dense(a, 32, 6, 0)
PINNED_N32 = 1.0672717524023244e+38
#: the same permanent exactly, from the JAX package's modular CRT engine:
#:   superman_tpu.ops.exact.perman_exact_fraction(a, engine="native")
#: (the native double value above is 5.5e-13 from it)
EXACT_N32 = 106727175240173945355163340903491553305
#: kernel vs plain version, per chunk: both take the same IEEE steps, so
#: they should agree bitwise; 2^-45 of the largest partial leaves room for
#: a reordering by the compiler and nothing more
KERNEL_TOL = 2.0 ** -45
MAIN_TOL = 1e-9          # n=32 df64 vs the pinned value
SMALL_TOL = 1e-10        # n=20, 24 vs the long-double oracle
#: the Z_p kernel is checked at the largest prime the TPU kernel took and
#: at the largest the card's takes; residues must agree exactly
MOD_PRIMES = (2039, (1 << 31) - 1)
#: a 31-bit prime outside the CRT pool of the n=32 run (which descends
#: from 2^31 - 1), for the Glynn vs Nijenhuis-Wilf cross-check
GLYNN_PRIME = 1073741789


def random_int_matrix(rng, n, density, vmax=4):
    """As tests/conftest.py makes its integer matrices."""
    a = (rng.random((n, n)) < density).astype(np.int64)
    return a * rng.integers(1, vmax + 1, (n, n))


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int):
    """(mean milliseconds per call by CUDA events, the last call's result)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def compare(kern, plain, ids) -> float:
    """Largest |kernel - plain| of the per-chunk partials hi + lo; raises
    past KERNEL_TOL of the largest partial or on a nonzero sentinel."""
    import torch
    pk = kern[:, 0] + kern[:, 1]
    pp = plain[:, 0] + plain[:, 1]
    if not (torch.isfinite(pk).all() and torch.isfinite(pp).all()):
        raise AssertionError("non-finite partials")
    dead = ids < 0
    if bool((kern[dead] != 0).any()):
        raise AssertionError("a sentinel chunk wrote a nonzero partial")
    err = float((pk - pp).abs().max())
    scale = float(pp.abs().max())
    if err > KERNEL_TOL * scale:
        raise AssertionError(f"kernel vs plain: max abs err {err:.3e} > "
                             f"{KERNEL_TOL:.1e} * {scale:.3e}")
    print(f"  max abs err {err:.3e} (tol {KERNEL_TOL * scale:.3e}), "
          f"bitwise equal: {bool(torch.equal(kern, plain))}")
    return err


def compare_mod(kern, plain, ids, p) -> int:
    """Largest |kernel - plain| residue difference; raises unless the two
    are equal on every chunk, canonical, and 0 on the sentinels."""
    import torch
    if not bool(((kern >= 0) & (kern < p)).all()):
        raise AssertionError(f"p={p}: a residue outside [0, p)")
    if bool((kern[ids < 0] != 0).any()):
        raise AssertionError(f"p={p}: a sentinel chunk wrote a nonzero sum")
    err = int((kern - plain).abs().max())
    print(f"  p={p}: {ids.numel()} chunks, max residue difference {err}")
    if not torch.equal(kern, plain):
        raise AssertionError(f"p={p}: kernel and plain residues differ")
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import superman_tpu_torch as spt
    from superman_tpu_torch.csrc import build
    from superman_tpu_torch.ops import (exact, gray, modp, modp_cuda, oracle,
                                        ryser_cuda)
    from superman_tpu_torch.ops.ryser import _center_scales, _row_scales

    # ---- 1. probe and build
    card = smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    path, report = build.build()
    build.load()
    print(f"build: {time.perf_counter() - t:.1f} s -> {path}")
    print(report.strip())
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # ---- 2. kernel vs plain version on the card, main-path shapes
    a32 = random_int_matrix(np.random.default_rng(SEED), 32, 0.5)
    plan = gray.make_plan(32, sms=sms)
    print(f"plan n=32: r={plan.r} chunks={plan.num_chunks} "
          f"n_pad={plan.n_pad} sms={sms}")
    a_s = np.ldexp(a32.astype(np.float64),
                   -_center_scales(a32, _row_scales(a32))[:, None])
    x0, cols = (torch.as_tensor(v, device=dev)
                for v in gray.pack_matrix(a_s, plan.n_pad))
    ids = torch.cat([torch.arange(2048), torch.full((128,), -1),
                     torch.arange(plan.num_chunks - 2048, plan.num_chunks)]
                    ).to(dev)
    kern = ryser_cuda.ryser_partials(ids, x0, cols, n=32, r=plan.r)
    torch.cuda.synchronize()
    plain = ryser_cuda.ryser_partials_ref(ids, x0, cols, n=32, r=plan.r)
    print(f"kernel vs plain, {ids.numel()} chunk ids (start, sentinels, end):")
    max_err = compare(kern, plain, ids)

    # ---- 2b. the Z_p kernel vs its plain version, same plan and ids
    core, mult = exact._fold_lines(exact.dyadic_int_matrix(a32)[0])
    if mult != 1 or len(core) != 32:
        raise AssertionError(f"n=32 matrix folded: mult {mult}, "
                             f"core n={len(core)}")
    mod_err = 0
    for p in MOD_PRIMES:
        mx0, mcols = (t.to(dev) for t in modp.pack_mod(
            modp.reduce_core_mod(core, p), p, plan.n_pad))
        kern = modp_cuda.mod_partials(ids, mx0, mcols, p, n=32, r=plan.r)
        torch.cuda.synchronize()
        plain = modp_cuda.mod_partials_ref(ids, mx0, mcols, p, n=32,
                                           r=plan.r)
        mod_err = max(mod_err, compare_mod(kern, plain, ids, p))

    # ---- 3. the df64 path
    small = []
    for n in (20, 24):
        a = random_int_matrix(np.random.default_rng(n), n, 0.5)
        small.append((n, a, float(oracle.perman64(a, dtype=np.longdouble))))
    ryser_cuda.LAUNCHES = modp_cuda.LAUNCHES = 0
    spt.permanent(a32, calc="df64")                       # warm-up
    best = min((spt.permanent(a32, calc="df64") for _ in range(3)),
               key=lambda res: res.time)
    rel = abs(best.permanent - PINNED_N32) / PINNED_N32
    rel_exact = abs(best.permanent - EXACT_N32) / EXACT_N32
    print(f"main path n=32 df64: {best.permanent!r} in {best.time:.4f} s "
          f"(best of 3), {best.iterations / best.time / 1e9:.2f} G Gray "
          f"iters/s, rel err {rel:.3e} vs pinned {PINNED_N32!r}, "
          f"{rel_exact:.3e} vs the exact integer; {best.algo_name} "
          f"r={best.meta['r']} chunks={best.meta['chunks']}")
    if best.algo_name != "ryser_cuda_df64" or not rel <= MAIN_TOL:
        raise AssertionError(f"n=32: {best.algo_name} rel {rel:.3e}")
    for n, a, want in small:
        res = spt.permanent(a, calc="df64")
        rel_n = abs(res.permanent - want) / abs(want)
        print(f"main path n={n} df64: {res.permanent!r} vs long-double "
              f"oracle {want!r}: rel err {rel_n:.3e}")
        if res.algo_name != "ryser_cuda_df64" or not rel_n <= SMALL_TOL:
            raise AssertionError(f"n={n}: {res.algo_name} rel {rel_n:.3e}")
    launches = ryser_cuda.LAUNCHES
    print(f"ryser_walk_df64 launches on the df64 path: {launches}")
    if launches <= 0:
        raise AssertionError("the df64 path did not launch the kernel")

    # ---- 3b. the exact path
    ryser_cuda.LAUNCHES = modp_cuda.LAUNCHES = 0
    ex = []
    for _ in range(3):
        t = time.perf_counter()
        res = spt.permanent(a32, calc="exact")
        ex.append((time.perf_counter() - t, res))
    mod_launches = modp_cuda.LAUNCHES
    exact_s, res = min(ex, key=lambda e: e[0])
    meta = res.meta["exact"]
    print(f"exact path n=32: {res.meta['exact_fraction']} in {exact_s:.4f} s "
          f"(best of 3: {', '.join(f'{e[0]:.4f}' for e in ex)}); {meta}; "
          f"modp_walk launches {mod_launches}")
    for _, r_ in ex:
        if r_.meta["exact_fraction"] != EXACT_N32:
            raise AssertionError(f"exact path: {r_.meta['exact_fraction']} "
                                 f"!= {EXACT_N32}")
    if meta["engine"] != "cuda_mod" or mod_launches <= 0:
        raise AssertionError(f"exact path: engine {meta['engine']}, "
                             f"{mod_launches} modp_walk launches")
    rel_df = abs(best.permanent - EXACT_N32) / EXACT_N32
    print(f"df64 n=32 vs the exact path's integer: rel err {rel_df:.3e}")
    if not rel_df <= MAIN_TOL:
        raise AssertionError(f"df64 vs exact: rel {rel_df:.3e}")
    nw = modp.perman_core_mod(core, GLYNN_PRIME, dev)
    gl = modp.perman_core_glynn_mod(core, GLYNN_PRIME, dev)
    print(f"p={GLYNN_PRIME}: Nijenhuis-Wilf {nw}, Glynn {gl}, exact "
          f"integer mod p {EXACT_N32 % GLYNN_PRIME}")
    if not nw == gl == EXACT_N32 % GLYNN_PRIME:
        raise AssertionError("Glynn and Nijenhuis-Wilf residues disagree")

    # ---- 4. times at the full n=32 main-path plan
    ids = torch.arange(plan.num_chunks, device=dev)

    def run_kernel():
        return ryser_cuda.ryser_partials(ids, x0, cols, n=32, r=plan.r)

    run_kernel()                                          # warm-up
    kernel_ms, kern = cuda_ms(run_kernel, 5)
    plain_ms, plain = cuda_ms(lambda: ryser_cuda.ryser_partials_ref(
        ids, x0, cols, n=32, r=plan.r), 1)
    print(f"kernel vs plain, full plan ({plan.num_chunks} chunks of "
          f"2^{plan.r}): kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms")
    max_err = max(max_err, compare(kern, plain, ids))

    p = MOD_PRIMES[-1]
    mx0, mcols = (t.to(dev) for t in modp.pack_mod(
        modp.reduce_core_mod(core, p), p, plan.n_pad))

    def run_mod():
        return modp_cuda.mod_partials(ids, mx0, mcols, p, n=32, r=plan.r)

    run_mod()                                             # warm-up
    mod_ms, kern = cuda_ms(run_mod, 5)
    mod_plain_ms, plain = cuda_ms(lambda: modp_cuda.mod_partials_ref(
        ids, mx0, mcols, p, n=32, r=plan.r), 1)
    print(f"modp_walk vs plain, full plan, p={p}: kernel {mod_ms:.3f} ms "
          f"({(1 << 31) / mod_ms / 1e6:.2f} G steps/s), plain "
          f"{mod_plain_ms:.1f} ms")
    mod_err = max(mod_err, compare_mod(kern, plain, ids, p))

    print(card)
    print(json.dumps({"kernels": [{
        "name": "ryser_walk_df64", "route": "cuda",
        "source": "superman_tpu_torch/csrc/ryser_walk.cu",
        "replaces": "superman_tpu/ops/ryser_pallas.py:541",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}, {
        "name": "modp_walk", "route": "cuda",
        "source": "superman_tpu_torch/csrc/modp_walk.cu",
        "replaces": "superman_tpu/ops/modp.py:413",
        "launches": mod_launches, "max_abs_err": mod_err,
        "ms": mod_ms, "plain_ms": mod_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
