"""The seeded corpus of the port's tools (superman_tpu_torch/tools/corpus.py).

The corpus stands in for the reference checkout's matrices: it must be a
pure function of its seed, read back through both packages' readers to
the matrices it was made from, and carry the structure each class of
the real suite needs, under the bounds the card prices.
"""

import os

import numpy as np
import pytest
import torch

from superman_tpu.io.matrixmarket import read_any as jax_read_any
from superman_tpu_torch.io.matrixmarket import read_any
from superman_tpu_torch.tools import corpus, real_suite
from tests.conftest import random_int_matrix

SMALL = sorted(corpus.real_matrices(0, small=True))


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_corpus_is_a_function_of_its_seed(tmp_path):
    """Two writes of one seed are byte for byte equal; another seed
    gives other files, under names that carry the seed."""
    trees = []
    for sub, seed in (("a", 0), ("b", 0), ("c", 1)):
        root = str(tmp_path / sub)
        corpus.write_int_suite(root, seed, ns=(14,), densities=("0.50",))
        corpus.write_real_corpus(root, seed, small=True)
        trees.append(_tree(root))
    assert trees[0] == trees[1]
    other = {k.replace("seed_0s_", "seed_1s_"): k for k in trees[0]}
    assert set(other) == set(trees[2])
    assert all(trees[2][k] != trees[0][other[k]] for k in trees[2])
    assert all(os.path.basename(k).startswith("seed_0s_")
               for k in trees[0] if not k.startswith("int"))


def test_int_suite_draw_is_conftest_random_int_matrix(tmp_path):
    """The int suite's entries are random_int_matrix's draw, then a full
    diagonal; both packages read the triplet file back to it."""
    path, = corpus.write_int_suite(str(tmp_path), 0, ns=(16,),
                                   densities=("0.30",))
    rng = np.random.default_rng([0, 16, 30, 0])
    want = random_int_matrix(rng, 16, 0.30)
    np.fill_diagonal(want, rng.integers(1, 5, 16))
    for reader in (read_any, jax_read_any):
        dm = reader(path)
        assert dm.type == "int"
        np.testing.assert_array_equal(dm.mat, want)
    assert os.path.basename(path) == "16_0.30_0"


@pytest.mark.parametrize("rel", SMALL)
def test_real_corpus_reads_back_through_both_packages(rel, tmp_path):
    """Every file of the real corpus reads back, through both packages'
    read_any, to the matrix it was written from (symmetric storage
    mirrored, pattern entries 1, reals to the last bit)."""
    corpus.write_real_corpus(str(tmp_path), 0, small=True)
    a, field, symmetry = corpus.real_matrices(0, small=True)[rel]
    path = str(tmp_path / rel)
    want = np.asarray(a)
    if field == "pattern":
        want = (want != 0).astype(np.int64)
    rect = want.shape[0] != want.shape[1]
    mats = [reader(path, allow_rect=rect).mat
            for reader in (read_any, jax_read_any)]
    np.testing.assert_array_equal(mats[0], mats[1])
    np.testing.assert_array_equal(mats[0], want)
    if rect:
        with pytest.raises(ValueError):
            read_any(path)


def test_full_corpus_reaches_every_class_under_the_card_bounds():
    """At full size and under the bounds a card prices (K1's rate), each
    file lands in the class it was built for; the real suite's quick run
    takes the four smallest orders, all of class A or Z."""
    bounds = real_suite.bounds_for(torch.device("cuda"))
    assert (bounds.exact_max_n, bounds.core_max_n) == (44, 35)
    want = {"seed_0_a_real.mtx": "A", "seed_0_a_int.mtxzero": "A",
            "seed_0_a_pattern.mtx": "A", "seed_0_z_singular.mtx": "Z",
            "seed_0_b_chain.mtx": "B", "seed_0_b2_sparse.mtx": "B2",
            "seed_0_c_dense.mtx": "C"}
    got, orders = {}, {}
    for rel, (a, _, _) in corpus.real_matrices(0).items():
        name = os.path.basename(rel)
        if name not in want:
            continue
        a = np.asarray(a, np.float64)
        orders[name] = a.shape[0]
        core = real_suite._core_fixed_point(a)
        got[name] = ("Z" if not real_suite._has_perfect_matching(a) else
                     real_suite.classify(a, core.shape[0], core, bounds,
                                         log=lambda s: None))
    assert got == want
    quick = sorted(orders, key=orders.get)[:4]
    assert {want[q] for q in quick} == {"A", "Z"}
    # the unknown_perman files: a few hundred rows, one of them without a
    # perfect matching, one signed, one rectangular
    unknown = {os.path.basename(rel): np.asarray(a)
               for rel, (a, _, _) in corpus.real_matrices(0).items()
               if rel.startswith(corpus.UNKNOWN)}
    assert all(a.shape[0] >= 160 for a in unknown.values())
    assert not real_suite._has_perfect_matching(
        unknown["seed_0_d_singular.mtx"].astype(np.float64))
    assert (unknown["seed_0_d_signed.mtx"] < 0).any()
    assert unknown["seed_0_d_rect.mtx"].shape == (240, 80)
