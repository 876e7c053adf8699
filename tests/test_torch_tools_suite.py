"""The port's corpus tools against the JAX package's on the seeded corpus.

tools/exact_known.py and tools/real_suite.py of both packages read the
same seeded corpus (tools/corpus.py, small orders), the JAX tools through
their module-level corpus directories pointed at it, and the port's on
device="cpu".  Every output goes under tmp_path: the JAX tools' default
outputs are the repository's evidence files.
"""

import json
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

import superman_tpu_torch.ops.exact as port_exact
from superman_tpu.tools import exact_known as jax_exact_known
from superman_tpu.tools import real_suite as jax_real_suite
from superman_tpu_torch.tools import corpus, exact_known, real_suite

#: files of the small corpus with n <= 14
SMALL_N14 = ["seed_0s_a_", "seed_0s_b_chain", "seed_0s_z_"]


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


@pytest.fixture()
def root(tmp_path, monkeypatch):
    """The small seeded corpus, with the JAX tools pointed at it."""
    r = str(tmp_path / "corpus")
    corpus.write_real_corpus(r, 0, small=True)
    for attr, sub in (("KNOWN_DIR", corpus.KNOWN), ("REAL_DIR", corpus.REAL),
                      ("SMALL_DIR", corpus.SMALL),
                      ("UNKNOWN_DIR", corpus.UNKNOWN)):
        monkeypatch.setattr(jax_real_suite, attr, os.path.join(r, sub))
    return r


def _rows(path):
    with open(path) as f:
        return {d["file"]: d for d in map(json.loads, f) if d}


def test_exact_known_numerators_match_the_reference(root, tmp_path):
    """The certified numerators of the port's run (the plain Z_p walk) are
    the JAX tool's; --reverify (native CRT and Glynn) matches them and
    --algo2-card (the Z_p walk under Glynn) checks them."""
    ours, theirs = str(tmp_path / "ours.jsonl"), str(tmp_path / "jax.jsonl")
    files = ["--files"] + SMALL_N14
    assert exact_known.main(["--root", root, "--out", ours, "--device",
                             "cpu"] + files) == 0
    assert jax_exact_known.main(["--out", theirs] + files) == 0
    mine, ref = _rows(ours), _rows(theirs)
    assert set(mine) == set(ref) and len(mine) == 5
    for name in ref:
        assert mine[name]["numerator"] == ref[name]["numerator"], name
        assert mine[name]["value"] == ref[name]["value"]
        assert mine[name]["n"] <= 14
    report = str(tmp_path / "report.json")
    assert exact_known.main(["--root", root, "--out", ours, "--reverify",
                             "--report", report, "--device", "cpu"]) == 0
    assert exact_known.main(["--root", root, "--out", ours, "--algo2-card",
                             "--report", report, "--device", "cpu"]) == 0
    with open(report) as f:
        rep = json.load(f)
    assert rep["n_mismatch"] == 0
    checked = [r for r in rep["rows"] if "crt_match" in r]
    # every row with a core left by the folds
    assert len(checked) == sum(r["engine"] not in (None, "fold_only")
                               for r in mine.values()) >= 3
    assert all(r["crt_match"] and r["glynn_ok"] and r["glynn_card_ok"]
               for r in checked)


def test_declined_row_survives_a_failed_certification(root, tmp_path,
                                                      monkeypatch):
    """A file declined by --budget stays declined in the merged output
    when the certification that would replace it raises (the JAX tool,
    tools/exact_known.py:130, drops the row before it certifies)."""
    out = str(tmp_path / "known.jsonl")
    assert exact_known.main(["--root", root, "--out", out, "--budget",
                             "0.001", "--device", "cpu"]) == 0
    declined = {k for k, r in _rows(out).items() if r.get("declined")}
    assert "seed_0s_c_dense.mtx" in declined

    real = port_exact.perman_exact_fraction

    def flaky(a, *args, **kw):
        if a.shape[0] == 13:              # seed_0s_c_dense.mtx
            raise RuntimeError("the walk failed")
        return real(a, *args, **kw)

    monkeypatch.setattr(port_exact, "perman_exact_fraction", flaky)
    assert exact_known.main(["--root", root, "--out", out, "--merge",
                             "--device", "cpu"]) == 1
    rows = _rows(out)
    assert rows["seed_0s_c_dense.mtx"]["declined"] is True
    assert rows["seed_0s_c_dense.mtx"]["engine"] is None
    assert all(rows[k].get("engine") for k in declined
               if k != "seed_0s_c_dense.mtx")
    assert set(rows) == {os.path.basename(p) for p in corpus.corpus(root)}


def test_rows_hold_their_reduced_denominator(root, tmp_path):
    """A dyadic file's row holds the reduced fraction's denominator, so
    numerator / 2^denominator_log2 is its permanent and the Glynn check
    can lift it back to the core.  The JAX tool writes k * n there with
    the reduced numerator: on seed_0s_a_real.mtx its pair is 2^-143 of the
    permanent."""
    ours, theirs = str(tmp_path / "ours.jsonl"), str(tmp_path / "jax.jsonl")
    argv = ["--files", "seed_0s_a_real"]
    assert exact_known.main(["--root", root, "--out", ours, "--device",
                             "cpu"] + argv) == 0
    assert jax_exact_known.main(["--out", theirs] + argv) == 0
    mine = _rows(ours)["seed_0s_a_real.mtx"]
    ref = _rows(theirs)["seed_0s_a_real.mtx"]
    assert mine["numerator"] == ref["numerator"]
    value = Fraction(int(mine["numerator"]), 1 << mine["denominator_log2"])
    assert float(value) == mine["value"]
    assert ref["denominator_log2"] == ref["k"] * ref["n"] \
        == mine["denominator_log2"] + 143
    assert exact_known.main(["--root", root, "--out", ours, "--algo2-card",
                             "--device", "cpu"]) == 0


def test_real_suite_quick_matches_the_reference(root, tmp_path, monkeypatch):
    """--quick on the seeded corpus under the same bounds (exact bound 9,
    core bound 30, native bound 11): the same (file, class, config,
    status) rows as the JAX run_suite, classes A, Z and B among them, no
    FAIL."""
    monkeypatch.setattr(jax_real_suite, "EXACT_MAX_N", 9)
    monkeypatch.setattr(jax_real_suite, "NATIVE_MAX_N", 11)
    bounds = real_suite.Bounds(exact_max_n=9, core_max_n=30,
                               native_max_n=11,
                               giters=real_suite.PLAIN_K1_GITERS)
    ours, theirs = str(tmp_path / "ours.jsonl"), str(tmp_path / "jax.jsonl")
    assert real_suite.run_suite(root, ours, quick=True, device="cpu",
                                bounds=bounds, log=lambda s: None) == 0
    assert jax_real_suite.run_suite(theirs, quick=True,
                                    log=lambda s: None) == 0

    def keys(path):
        with open(path) as f:
            return {(d["file"], d["class"], d["config"], d["status"])
                    for d in map(json.loads, f)}

    mine = keys(ours)
    assert mine == keys(theirs)
    assert {k[1] for k in mine} == {"A", "Z", "B"}
    assert {k[3] for k in mine} == {"ok"}


def test_real_suite_resume_keeps_the_partial_rows(root, tmp_path):
    """--resume carries the rows of an interrupted run's .partial and
    skips their files; the rest is run."""
    out = str(tmp_path / "suite.jsonl")
    bounds = real_suite.bounds_for(torch.device("cpu"))
    assert real_suite.run_suite(root, out, quick=True, device="cpu",
                                bounds=bounds, log=lambda s: None) == 0
    with open(out) as f:
        rows = [json.loads(x) for x in f]
    first = rows[0]["file"]
    with open(out + ".partial", "w") as f:
        for r in rows:
            if r["file"] == first:
                f.write(json.dumps({**r, "value": -1.0}) + "\n")
    assert real_suite.run_suite(root, out, quick=True, resume=True,
                                device="cpu", bounds=bounds,
                                log=lambda s: None) == 0
    with open(out) as f:
        again = [json.loads(x) for x in f]
    assert [r["file"] for r in again] == [r["file"] for r in rows]
    assert all(r["value"] == -1.0 for r in again if r["file"] == first)
    assert all(r["value"] != -1.0 for r in again if r["file"] != first
               and "value" in r)
    assert np.isfinite([r["value"] for r in again
                        if r["file"] != first]).all()


@pytest.mark.parametrize("l1,s1,l2,s2,agree", [
    (100.0, 0.01, 100.01, 0.01, True),      # 0.7% apart, sigma 1.4%
    (100.0, 0.01, 100.2, 0.01, False),      # 13% apart
    (100.0, 0.6, 106.0, 0.7, True),         # both degenerate: detected
    (100.0, 0.6, 106.0, 0.1, False),        # one degenerate, one sure
    (float("-inf"), 0.9, 100.0, 0.9, False),  # not finite
    (5000.0, 0.2, 5000.3, 0.2, True),       # past the double range
])
def test_seed_agreement_rule(l1, s1, l2, s2, agree):
    """The estimator rows' agreement of two seeds (classes C and D): 3
    sigma on the ratio in linear space, or mutual self-reported
    degeneracy, never a non-finite estimate."""
    assert real_suite._seeds_agree(l1, s1, l2, s2) is agree
