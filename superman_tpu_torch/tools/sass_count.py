"""Count the instructions of the walk kernels' step loop in their SASS.

    python -m superman_tpu_torch.tools.sass_count [--n-pad 32]
        [--kernels ryser_walk_kernel,ryser_reduced_kernel,ryser_batch_kernel]
        [--tiers 0,1,2,3] [--lib PATH] [--dump FILE]

Builds the library as csrc/build.py does (or takes --lib) and
disassembles it with cuobjdump (CUDA toolkit; no card is needed).  For
each instantiation kernel<N_PAD, TIER, ...> it finds the step loop: of the
loops (a backward branch and the code from its target to it), the one
with the most multiplies of the tier's type, the innermost of equals.  It
counts that loop's instructions by class and divides by the steps one
trip walks: the loop's multiplies over a step's (the product tree's
N_PAD - 1; in tf96 N_PAD/2 + 3 (N_PAD/2 - 1) DMULs).  Prints one JSON line
per kernel, with its registers (cuobjdump -res-usage); --dump writes the
loops' SASS to FILE.

Classes: fp64 (DADD, DMUL, DFMA), fp32 (FADD, FMUL, FFMA), lds32 / lds64
/ lds128 (shared loads by width), mem (any other load or store; a local
one is a spill), branch (BRA, BSSY, BSYNC, ...), other (integer, compare,
select, move, conversion: what issues on neither floating-point pipe).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys

from superman_tpu_torch.csrc.build import tool

FP64 = {"DADD", "DMUL", "DFMA"}
FP32 = {"FADD", "FMUL", "FFMA"}
BRANCH = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BSSY",
          "BSYNC", "BREAK", "WARPSYNC", "BPT", "YIELD"}
MEM = {"LDG", "STG", "LDL", "STL", "STS", "LD", "ST", "LDC", "LDSM",
       "ATOM", "ATOMS", "ATOMG", "RED"}
CLASSES = ("fp64", "fp32", "lds32", "lds64", "lds128", "mem", "branch",
           "other")
KERNELS = ("ryser_walk_kernel", "ryser_reduced_kernel", "ryser_batch_kernel")

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")
_NAME = re.compile(r"\d+([a-z_]+_kernel)I((?:L[ib]\d+E)+)")


def demangle(mangled: str) -> str:
    """kernel<template arguments> of a mangled kernel name, or the name;
    an int or bool argument is written as its number (ryser_walk_kernel's
    REDUCE: 0 per chunk, 1 block-reduced)."""
    m = _NAME.search(mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def functions(sass: str) -> dict:
    """{demangled name: (instructions, labels)} of cuobjdump -sass output:
    instructions [(address, opcode, text)], labels {label: address}."""
    out = {}
    name, insns, labels = None, [], {}
    pending = []

    def close():
        if name is not None:
            out[name] = (insns, labels)

    for line in sass.splitlines():
        f = _FUNC.search(line)
        if f:
            close()
            name, insns, labels, pending = demangle(f.group(1)), [], {}, []
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for p in pending:
                labels[p] = addr
            pending = []
            text = m.group(2).strip()
            body = re.sub(r"^@!?U?P\w+\s+", "", text)
            insns.append((addr, body.split()[0] if body else "", text))
    close()
    return out


def loops(insns, labels):
    """[(start, end)] index ranges of the backward branches' loops."""
    index = {addr: i for i, (addr, _, _) in enumerate(insns)}
    found = []
    for i, (addr, op, text) in enumerate(insns):
        if not op.startswith("BRA"):
            continue
        t = _TARGET.search(text.split(None, 1)[1] if " " in text else "")
        if not t:
            continue
        target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
        if target is not None and target <= addr and target in index:
            found.append((index[target], i))
    return found


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base in FP64:
        return "fp64"
    if base in FP32:
        return "fp32"
    if base == "LDS":
        return ("lds128" if ".128" in op else "lds64" if ".64" in op
                else "lds32")
    if base in MEM:
        return "mem"
    if base in BRANCH:
        return "branch"
    return "other"


def tree_muls(n_pad: int, tier: int) -> int:
    """Multiplies of one step's product tree, of the type counted."""
    h = n_pad // 2
    return h + 3 * (h - 1) if tier == 3 else n_pad - 1


def step_loop(insns, labels, n_pad: int, tier: int):
    """(counts by class per step, steps a trip, opcodes a trip, the loop's
    instructions) of the step loop, or None."""
    mul = "DMUL" if tier in (0, 3) else "FMUL"
    best = None
    for s, e in loops(insns, labels):
        body = [op for _, op, _ in insns[s:e + 1] if op != "NOP"]
        muls = sum(op.split(".")[0] == mul for op in body)
        key = (muls, -len(body))
        if muls and (best is None or key > best[0]):
            best = (key, s, e, body)
    if best is None:
        return None
    (muls, _), s, e, body = best
    steps = muls / tree_muls(n_pad, tier)
    counts = collections.Counter(classify(op) for op in body)
    per_step = {c: counts.get(c, 0) / steps for c in CLASSES}
    per_step["total"] = len(body) / steps
    return (per_step, steps,
            dict(collections.Counter(op for op in body).most_common()),
            insns[s:e + 1])


def registers(lib: str) -> dict:
    """{demangled name: registers} from cuobjdump -res-usage."""
    out = subprocess.run([tool("cuobjdump"), "-res-usage", lib],
                         capture_output=True, text=True, check=True).stdout
    regs = {}
    name = None
    for line in out.splitlines():
        f = re.search(r"Function (\S+):", line)
        if f:
            name = demangle(f.group(1))
        m = re.search(r"REG:(\d+)", line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-pad", type=int, default=32)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--tiers", default="0,1,2,3")
    ap.add_argument("--lib", default=None)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    lib = args.lib
    if lib is None:
        from superman_tpu_torch.csrc import build
        lib, _ = build.build()
    sass = subprocess.run([tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    funcs = functions(sass)
    regs = registers(lib)
    dump = []
    rc = 0
    for kernel in args.kernels.split(","):
        for tier in (int(t) for t in args.tiers.split(",")):
            # every instantiation at this N_PAD and tier (ryser_walk_kernel
            # has two, per chunk and block-reduced)
            head = f"{kernel}<{args.n_pad},{tier}"
            names = [f for f in funcs
                     if f == head + ">" or f.startswith(head + ",")]
            if not names:
                print(f"sass_count: {head}> is not in {lib}",
                      file=sys.stderr)
                rc = 1
            for name in names:
                rc |= _report(name, funcs[name], regs, args.n_pad, tier,
                              dump)
    if args.dump:
        with open(args.dump, "w") as f:
            f.write("\n\n".join(dump) + "\n")
    return rc


def _report(name, func, regs, n_pad, tier, dump) -> int:
    """Print the JSON line of one instantiation and add its loop to dump;
    returns 1 where it has no step loop."""
    found = step_loop(*func, n_pad, tier)
    if found is None:
        print(f"sass_count: no step loop in {name}", file=sys.stderr)
        return 1
    per_step, steps, opcodes, loop = found
    print(json.dumps({
        "kernel": name, "registers": regs.get(name),
        "trip_steps": steps,
        "trip_instructions": round(per_step["total"] * steps),
        "per_step": {k: round(v, 3) for k, v in per_step.items()},
        "opcodes_per_trip": opcodes}), flush=True)
    dump.append(f"==== {name}: {len(loop)} instructions, "
                f"{steps} steps a trip\n" + "\n".join(
                    f"/*{a:04x}*/ {t}" for a, _, t in loop))
    return 0


if __name__ == "__main__":
    sys.exit(main())
