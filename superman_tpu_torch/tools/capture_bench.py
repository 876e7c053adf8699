"""Capture a run of the port's bench (tools/bench.py) into a record file.

    python -m superman_tpu_torch.tools.capture_bench [--n N] [--out PATH]
        [--timeout S] [-- BENCH ARGS...]

The port of superman_tpu/tools/capture_bench.py.  It runs
`python -m superman_tpu_torch.tools.bench` (with the arguments after
`--`, e.g. `-- --device cpu --n 16`) in a subprocess at the checkout's
root and writes the same record as the JAX tool, {n, cmd, rc, tail,
parsed}: `tail` the last 4000 characters of the bench's stdout and
stderr, `parsed` the last JSON line of its stdout that has
"vs_baseline".  A bench that outlives --timeout is killed and recorded
with rc = -1 and a note on stderr.  The exit code is 0 only when the
bench's was 0 and a line was parsed.

The record goes to build/tools/bench_torch_r{N:02d}.json by default (N is
the capture's number, --n), or to --out.  A path named BENCH_r<digits>.json
is refused: that name belongs to the JAX bench's captures, which the
repo's evidence tests hold to that bench's floors.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shlex
import subprocess
import sys

from . import out_path

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the JAX bench's record names, which this tool never writes
REFERENCE_NAME = re.compile(r"BENCH_r\d+\.json")


def capture(n: int, out: str, timeout: float, bench_args=()) -> int:
    """Run the bench, write the record to `out`; the exit code."""
    argv = [sys.executable, "-m", "superman_tpu_torch.tools.bench",
            *bench_args]
    cmd = shlex.join(argv)
    try:
        proc = subprocess.run(argv, cwd=ROOT, capture_output=True,
                              text=True, timeout=timeout)
        rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        # a hang is recorded (rc=-1) rather than lost with the tool
        rc = -1
        stdout = (e.stdout or b"").decode(errors="replace") \
            if isinstance(e.stdout, bytes) else (e.stdout or "")
        stderr = f"capture_bench: bench.py hung past {timeout:.0f}s"
    tail = (stdout + stderr)[-4000:]
    parsed = None
    for line in stdout.splitlines()[::-1]:
        line = line.strip()
        if line.startswith("{"):
            try:
                cand = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "vs_baseline" in cand:
                parsed = cand
                break
    with open(out, "w") as f:
        json.dump({"n": n, "cmd": cmd, "rc": rc, "tail": tail,
                   "parsed": parsed}, f, indent=2)
    ok = rc == 0 and parsed is not None
    print(f"{os.path.basename(out)}: rc={rc} "
          f"parsed={'yes' if parsed else 'NO'}"
          + (f" value={parsed['value']} vs_baseline={parsed['vs_baseline']}"
             if parsed else ""))
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    bench_args = []
    if "--" in argv:
        i = argv.index("--")
        argv, bench_args = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(prog="superman-torch-capture-bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=1,
                   help="the capture's number, which names the record")
    p.add_argument("--out", default=None,
                   help="record path (default: build/tools/"
                        "bench_torch_r{N:02d}.json)")
    p.add_argument("--timeout", type=float, default=3600.0)
    args = p.parse_args(argv)
    out = args.out or out_path(f"bench_torch_r{args.n:02d}.json")
    if REFERENCE_NAME.fullmatch(os.path.basename(out)):
        print(f"capture_bench: refusing to write {out}: BENCH_r<N>.json "
              "records the JAX bench", file=sys.stderr)
        return 2
    return capture(args.n, out, args.timeout, bench_args)


if __name__ == "__main__":
    sys.exit(main())
