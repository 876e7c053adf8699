"""Command-line driver.

Port of ``superman_tpu/cli.py``: the reference CLI's short flags, the
same algorithm-id table (core/flags.py:id_behavior) and the same output
line (reference revised_perman/main.cpp:1665):

    Result || <algo> | <file> | <permanent %.16e> in <seconds>

One flag is new: --device names the torch device (default cuda:<-l>;
"cpu" runs the kernels' plain versions).  The reference's -d, a device
count for multi-device algorithms, is spelled -d/--gpu-num here.

The transforms and the estimators run: -a (the Monte-Carlo estimators,
-p rasmussen | scaling | gurvits, with -x trials, -y/-z Sinkhorn
intervals and sweeps, --smc), -i (the perfect matchings of a -m x -n grid
graph), -o (compression) and -u (Sinkhorn scaling).  What is still
refused by name: several devices, the hybrid scheduler and -c, the
native CPU engine.
"""

from __future__ import annotations

import argparse
import sys

from .core.flags import Flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m superman_tpu_torch", add_help=False,
        description="Matrix permanent calculator (superman_tpu_torch, "
                    "PyTorch/CUDA)")
    p.add_argument("--help", action="help")
    p.add_argument("-f", "--file", type=str, default=None)
    p.add_argument("-p", "--perman", type=str, default="auto",
                   help="algorithm id (reference-compatible) or name")
    p.add_argument("-t", "--threads", type=int, default=16)
    p.add_argument("-s", "--sparse", action="store_true")
    p.add_argument("-b", "--binary", action="store_true")
    p.add_argument("-g", "--gpu", action="store_true",
                   help="run on the accelerator (the CUDA card)")
    p.add_argument("-c", "--cpu", action="store_true")
    p.add_argument("-d", "--gpu-num", type=int, default=2,
                   help="number of devices for multi-device algorithms")
    p.add_argument("--device", type=str, default=None,
                   help="torch device, e.g. cuda:0 or cpu "
                        "(default cuda:<deviceid>)")
    p.add_argument("-a", "--approximation", action="store_true")
    p.add_argument("-x", "--numOfTimes", type=int, default=100000)
    p.add_argument("-y", "--scaleIntervals", type=int, default=4)
    p.add_argument("-z", "--scaleTimes", type=int, default=5)
    p.add_argument("-r", "--preprocessing", type=int, default=0,
                   choices=tuple(range(8)),
                   help="0 none, 1 SortOrder, 2 SkipOrder, 3 RCM, 4 BFS, "
                        "5 rowdeg, 6 firstseen, 7 coldeg-desc")
    p.add_argument("-i", "--grid", action="store_true")
    p.add_argument("-m", "--gridm", type=int, default=36)
    p.add_argument("-n", "--gridn", type=int, default=36)
    p.add_argument("-h", "--halfprecision", action="store_true",
                   help="calculate in f32 (reference -h)")
    p.add_argument("-q", "--quadprecision", action="store_true")
    p.add_argument("-w", "--storagehalf", action="store_true")
    p.add_argument("-v", "--storagequad", action="store_true")
    p.add_argument("-k", "--rep", type=int, default=1)
    p.add_argument("-e", "--gridmultip", type=int, default=1)
    p.add_argument("-o", "--compression", action="store_true")
    p.add_argument("-u", "--scaling", type=float, default=-1.0,
                   help="Sinkhorn scaling threshold (-1 = off)")
    p.add_argument("-l", "--deviceid", type=int, default=0)
    p.add_argument("--calc", type=str, default=None,
                   choices=("f32", "f32k", "df64", "tf96", "f64", "quad",
                            "auto", "exact"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smc", type=int, default=-1, choices=(-1, 0, 1),
                   help="SMC population estimator for -a scaling: "
                        "-1 auto (n>=64), 0 off, 1 on")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="journal finished work units here and resume "
                        "from it (hybrid scheduler)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON object per run instead of the "
                        "text result line")
    return p


def flags_from_args(args) -> Flags:
    # unified v1+v2 id table (core/flags.py:id_behavior): an id resolves
    # to (sparse, hybrid, multi) in the context of -s / -a
    from .core.flags import id_behavior
    beh = id_behavior(args.perman, args.sparse, args.approximation)
    hybrid = beh["hybrid"]
    # -d 1 means single-device even for a multi-device algorithm id
    mesh_shape = ((args.gpu_num,) if beh["multi"] and args.gpu_num > 1
                  else None)
    return Flags(
        cpu=args.cpu if hybrid else (args.cpu and not args.gpu),
        gpu=hybrid or not (args.cpu and not args.gpu),
        dense=not beh["sparse"], sparse=beh["sparse"],
        exact=not args.approximation, approximation=args.approximation,
        binary_graph=args.binary,
        grid_graph=args.grid, gridm=args.gridm, gridn=args.gridn,
        perman_algo=beh["algo"], threads=args.threads,
        calculation_half_precision=args.halfprecision,
        calculation_quad_precision=args.quadprecision,
        storage_half_precision=args.storagehalf,
        storage_quad_precision=args.storagequad,
        calc=args.calc,
        number_of_times=args.numOfTimes,
        scale_intervals=args.scaleIntervals, scale_times=args.scaleTimes,
        preprocessing=args.preprocessing,
        compression=args.compression, scaling_threshold=args.scaling,
        gpu_num=args.gpu_num, device_id=args.deviceid,
        rep=args.rep, grid_multip=args.gridmultip,
        mesh_shape=mesh_shape, seed=args.seed, smc=args.smc,
        hybrid=hybrid, checkpoint_path=args.checkpoint,
        filename=args.file or "",
    )


def print_flags(flags: Flags) -> None:
    """Parity: print_flags (reference main.cpp:60-95)."""
    print("*" * 72)
    for k, v in sorted(vars(flags).items()):
        print(f"  {k}: {v}")
    print("*" * 72)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.file is None and not args.grid:
        print("Error: -f/--file is required (or -i for grid graphs)",
              file=sys.stderr)
        return 1
    flags = flags_from_args(args)
    # several processes (torchrun's WORLD_SIZE > 1) join one group here
    from .parallel.mesh import init_distributed
    init_distributed()
    if not args.json:
        print_flags(flags)

    from .api import permanent
    overrides = dict(vars(flags))
    name = args.file or f"grid{flags.gridm}x{flags.gridn}"
    for _ in range(max(1, flags.rep)):
        res = permanent(args.file, device=args.device, **overrides)
        if args.json:
            import dataclasses
            import json
            rec = dataclasses.asdict(res)
            rec["file"] = name
            rec["meta"] = {k: v for k, v in rec["meta"].items()
                           if isinstance(v, (int, float, str, bool,
                                             type(None), dict))}
            print(json.dumps(rec))
        else:
            print(res.report_line(name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
