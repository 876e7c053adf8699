"""Small versions of the benchmark's cells, for runs on the CPU."""

import pytest

from permbench import harness

#: each cell at a size the plain versions walk in about a second, through
#: the same entry point and engine as the cell (the sparse one by
#: sparse=True, since the auto gate waits for n >= 28)
SMALL = {
    "erdos_int_dense.n32": dict(order=19, calc="df64", pool=5,
                                check_sample=2, warmup_calls=1,
                                flags={"chunk_log2": 8}),
    "erdos_int_sparse.n36": dict(order=20, calc="df64", pool=5,
                                 check_sample=2, warmup_calls=1,
                                 flags={"chunk_log2": 8, "sparse": True}),
    "erdos_int_dense.batch_n24x256": dict(order=14, batch=8, calc="df64",
                                          pool=3, check_sample=1,
                                          warmup_calls=1),
    # n=18: the exact value has more than 53 bits, so a double misses it
    "erdos_int_dense.exact_n30": dict(order=18, pool=20, check_sample=2,
                                      warmup_calls=1),
}
#: a seed above 2^31, which 32 signed bits cannot hold
SEED = 2 ** 31 + 7


def small_cell(name: str, checkout=harness.CHECKOUT) -> harness.Cell:
    cell = harness.load_cell(name, checkout)
    cell.traffic.update(SMALL[name])
    return cell


def run_small(name: str, traced=False, control=False, seed=SEED):
    return harness.run_cell(small_cell(name), seed, 1, traced,
                            device="cpu", control=control,
                            log=lambda msg: None)


@pytest.fixture(params=sorted(SMALL))
def cell_name(request):
    return request.param
