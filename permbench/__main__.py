"""python3 -m permbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""

import time

_T0 = time.perf_counter()

import sys  # noqa: E402

from permbench.harness import main, process_start  # noqa: E402

sys.exit(main(sys.argv[1:], t0=process_start(_T0)))
