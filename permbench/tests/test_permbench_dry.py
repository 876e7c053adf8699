"""The whole of a run on the CPU, at small sizes: the plain versions of
the kernels under the closed loop, the reference check after it, the
control and the faults the check has to catch."""

import numpy as np
import pytest

from permbench.tests.conftest import SEED, run_small

#: the end-to-end metrics of each cell: p95_ms only where its runs repeat
#: it closely enough for a bound
E2E = {"setup_s", "perms_per_s"}
TAIL_CELLS = {"erdos_int_sparse.n36", "erdos_int_dense.exact_n30"}


def test_a_one_second_run_is_correct(cell_name):
    line = run_small(cell_name)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == E2E | (
        {"p95_ms"} if cell_name in TAIL_CELLS else set())
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"failed_calls", "mismatches" if
                                   cell_name.endswith("exact_n30")
                                   else "max_rel_err"}


def test_a_traced_run_reads_the_spans(cell_name):
    line = run_small(cell_name, traced=True)
    assert line["correct"], line["checks"]
    m = line["metrics"]
    # the device's metrics say nothing on the CPU
    assert not {"device_idle_pct", "call_mfu"} & set(m)
    assert not any(k.endswith("_roofline") for k in m)
    want = {"erdos_int_dense.n32": {"dispatch_ms", "pack_ms", "walk_ms"},
            "erdos_int_sparse.n36": {"dispatch_ms", "pack_ms", "walk_ms",
                                     "sparse_plan_ms"},
            "erdos_int_dense.batch_n24x256": {"dispatch_ms",
                                              "batch_pack_ms",
                                              "batch_walk_ms"},
            "erdos_int_dense.exact_n30": set()}[cell_name]
    assert set(m) == want | {"call_p95_ms"}
    assert all(v["value"] > 0 for v in m.values())


def test_the_control_is_not_correct(cell_name):
    """The configuration's lower tier in the program's place (f32k for
    df64, df64 for exact) fails the check."""
    assert not run_small(cell_name, control=True)["correct"]


def _alter_total(monkeypatch):
    from superman_tpu_torch.parallel import sharding
    orig = sharding.compute_total

    def altered(*a, **k):
        return orig(*a, **k) * (1 + 1e-7)
    monkeypatch.setattr(sharding, "compute_total", altered)


def _alter_batch(monkeypatch):
    from superman_tpu_torch.ops import batch
    orig = batch.walk_stack

    def altered(*a, **k):
        return orig(*a, **k) * (1 + 1e-7)
    monkeypatch.setattr(batch, "walk_stack", altered)


def _alter_exact(monkeypatch):
    from superman_tpu_torch.ops import modp
    orig = modp.crt_perman_core

    def altered(*a, **k):
        per, meta = orig(*a, **k)
        return per + 1, meta
    monkeypatch.setattr(modp, "crt_perman_core", altered)


ALTER = {"erdos_int_dense.n32": _alter_total,
         "erdos_int_sparse.n36": _alter_total,
         "erdos_int_dense.batch_n24x256": _alter_batch,
         "erdos_int_dense.exact_n30": _alter_exact}


def test_an_answer_altered_where_it_is_made(cell_name, monkeypatch):
    ALTER[cell_name](monkeypatch)
    line = run_small(cell_name)
    assert not line["correct"]
    assert line["failed"] == 0


def test_half_the_batch_left_out(monkeypatch):
    """The batch kernel walks the first half of the stack and its words
    stand for the second half too."""
    from superman_tpu_torch.ops import batch
    orig = batch.walk_stack

    def half(x0p, colsT, **k):
        h = len(x0p) // 2
        o = orig(x0p[:h], colsT[:h], **k)
        return np.concatenate([o, o])[:len(x0p)]
    monkeypatch.setattr(batch, "walk_stack", half)
    assert not run_small("erdos_int_dense.batch_n24x256")["correct"]


def test_a_failed_call_is_not_correct(monkeypatch):
    import superman_tpu_torch as spt
    calls = {"n": 0}
    orig = spt.permanent

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("lost")
        return orig(*a, **k)
    monkeypatch.setattr(spt, "permanent", flaky)
    line = run_small("erdos_int_dense.n32")
    assert line["failed"] == 1 and not line["correct"]
    assert line["checks"]["failed_calls"] == [1, 0]


def test_same_seed_same_answers():
    a = run_small("erdos_int_dense.batch_n24x256", seed=SEED + 1)
    b = run_small("erdos_int_dense.batch_n24x256", seed=SEED + 1)
    assert a["checks"]["max_rel_err"] == b["checks"]["max_rel_err"]


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 1])
def test_seeds_outside_int32(seed):
    assert run_small("erdos_int_dense.n32", seed=seed)["correct"]
