import numpy as np

from permbench import gen


def test_pool_repeats_exactly_from_a_seed():
    a = gen.pool(2 ** 31 + 5, 32, 0.5, 6)
    b = gen.pool(2 ** 31 + 5, 32, 0.5, 6)
    assert all((x == y).all() for x, y in zip(a, b))
    c = gen.pool(2 ** 31 + 6, 32, 0.5, 6)
    assert not all((x == y).all() for x, y in zip(a, c))


def test_batch_items_repeat_and_differ_inside():
    a = gen.pool(11, 24, 0.5, 2, batch=4)
    b = gen.pool(11, 24, 0.5, 2, batch=4)
    assert a[0].shape == (4, 24, 24)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0][0] == a[0][1]).all()


def test_suite_shape():
    m = gen.pool(3, 36, 0.15, 1)[0]
    assert m.dtype == np.int64
    assert (np.diag(m) >= 1).all() and m.max() <= 4 and m.min() >= 0
    off = m[~np.eye(36, dtype=bool)]
    assert 0.08 < np.count_nonzero(off) / off.size < 0.22


def test_frozen_copy_of_the_ports_corpus():
    """Item k at a seed is the port's corpus file int/{n}_{d}_{k}."""
    from superman_tpu_torch.tools.corpus import suite_matrix
    for n, d in ((30, "0.50"), (36, "0.15")):
        for k in (0, 3):
            assert (gen.pool(5, n, float(d), k + 1)[k]
                    == suite_matrix(5, n, d, k)).all()


def test_negative_and_large_seeds():
    assert gen.pool(-1, 8, 0.5, 1)[0].shape == (8, 8)
    assert gen.pool(2 ** 40, 8, 0.5, 1)[0].shape == (8, 8)
