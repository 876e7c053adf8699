"""Result record for a permanent computation.

Parity: ``Result{permanent, time}`` struct in the reference
(revised_perman/flags.h:28-45), including the ``operator+`` used by the
recursive compression driver (revised_perman/main.cpp:1039-1040) which sums
permanents and takes the max of the two branch times.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Result:
    permanent: float = 0.0
    time: float = 0.0
    #: name of the algorithm that produced this result (reference keeps this in
    #: flags.algo_name; we attach it to the result for observability)
    algo_name: str = ""
    #: number of rejected (zero) trials for approximation algorithms
    #: (reference logs "number of zeros": algo.h:166,361)
    zeros: int = 0
    #: total number of Gray-code iterations actually executed (exact algos);
    #: basis for the iters/sec throughput metric
    iterations: int = 0
    #: extra metadata (chunk stats, mesh shape, calc dtype, ...)
    meta: dict = dataclasses.field(default_factory=dict)

    def __add__(self, other: "Result") -> "Result":
        # branch results of d34 compression are summed; wall-clock is the max
        # of the branches (they could run concurrently), mirroring the
        # reference's Result::operator+ semantics.
        return Result(
            permanent=self.permanent + other.permanent,
            time=max(self.time, other.time),
            algo_name=self.algo_name or other.algo_name,
            zeros=self.zeros + other.zeros,
            iterations=self.iterations + other.iterations,
            meta={**other.meta, **self.meta},
        )

    def report_line(self, filename: str) -> str:
        """Canonical v2 output line (revised_perman/main.cpp:1665)."""
        return "Result || %s | %s | %.16e in %f" % (
            self.algo_name, filename, self.permanent, self.time)
