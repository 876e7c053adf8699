"""Standalone Python-binding CLI over the native C engine.

Port of ``superman_tpu/bindings/superpython.py`` over the port's own
engine (bindings/native.py).  Parity: the reference's superPython.py
(argparse -f -a -t -x -y -z over ctypes read_calculate_return,
superPython.py:6-29).  Algorithm ids follow
the libConnect mapping (interface_connector.c:19-59): 0/2 sorted exact
sparse, 1 Rasmussen, 3 scaling estimator, 4 SpaRyser, 5 dense parallel
Ryser, 6/7 SkipPer, 8 sequential Ryser.

    python -m superman_tpu_torch.bindings.superpython -f matrix.txt -a 5 -t 16
"""

from __future__ import annotations

import argparse
import sys

from .native import read_calculate_return


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="superpython")
    p.add_argument("-f", "--filename", required=True,
                   help="matrix file (v1 triplet format)")
    p.add_argument("-a", "--algorithm", type=int, default=5)
    p.add_argument("-t", "--threads", type=int, default=16)
    p.add_argument("-x", "--numOfTimes", type=int, default=100000)
    p.add_argument("-y", "--scaleIntervals", type=int, default=4)
    p.add_argument("-z", "--scaleTimes", type=int, default=5)
    args = p.parse_args(argv)
    result = read_calculate_return(args.filename, args.algorithm,
                                   args.threads, args.numOfTimes,
                                   args.scaleIntervals, args.scaleTimes)
    print(f"Permanent: {result:.16e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
