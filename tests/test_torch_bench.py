"""The port's bench and its capture tool against the JAX package's.

tools/bench.py's measuring function runs on device="cpu" (the kernels'
plain versions) on tools/corpus.py's stand-ins at n=16 (the small-n walks)
and n=20 (K1's plain version and its reduced entry) and gives the JAX
package's values (Pallas in interpret mode) in every tier within its
contract; its line carries the keys of the root bench.py's; without CUDA
it exits non-zero and prints no line.  tools/capture_bench.py writes the
JAX tool's record from the same subprocess results, and never a
BENCH_r<N>.json.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import superman_tpu as sp
import superman_tpu_torch.tools as port_tools
from superman_tpu.core.matrix import DenseMatrix
from superman_tpu.tools import capture_bench as jax_capture
from superman_tpu_torch.tools import bench, capture_bench, corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK_LOG2 = 6
#: each measured call's agreement with the JAX package: the tiers'
#: contracts (the df64 walks and the tf96 host sum both round to a double)
AGREE = {"df64": 1e-12, "tf96": 1e-12, "f32k": 1e-3, "f32": 5e-2,
         "sparse_dense": 1e-12, "sparse": 1e-10}
#: bench.py's detail keys the port names otherwise: the headline's error
#: goes by its oracle, and the reference's SkipPer times describe its own
#: matrix, so they stand only under --root
RENAMED = {"rel_err_vs_native_double", "sparse_ref_cpu_skipper_s"}


@pytest.fixture(scope="module", params=[16, 20])
def line(request):
    return request.param, bench.measure("cpu", n=request.param, reps=2,
                                        chunk_log2=CHUNK_LOG2)


def reference_keys():
    """(top-level keys, detail keys) of the dict that bench.py prints."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    top = next(node for node in ast.walk(tree) if isinstance(node, ast.Dict)
               and any(getattr(k, "value", None) == "detail"
                       for k in node.keys))
    detail = top.values[[k.value for k in top.keys].index("detail")]
    return ({k.value for k in top.keys}, {k.value for k in detail.keys})


def test_bench_values_match_the_reference(line):
    """Every measured call of the bench gives the JAX package's value on
    the same matrix with the same flags, within its tier's contract."""
    n, got = line
    d = got["detail"]
    ports = {"df64": d["permanent"], "sparse": d["sparse_permanent"],
             "sparse_dense": d["sparse_dense_permanent"]}
    ports.update({t: d[f"{t}_permanent"] for t in ("f32", "f32k", "tf96")})
    flags = {t: (bench.DENSE, dict(calc=t)) for t in bench.TIERS}
    flags["sparse_dense"] = (bench.SPARSE,
                             dict(calc="df64", skip_pruning=False))
    flags["sparse"] = (bench.SPARSE, dict(calc="df64", sparse=True))
    for tag, (density, kw) in flags.items():
        a = DenseMatrix(corpus.suite_matrix(0, n, density, 0), "int")
        want = sp.permanent(a, chunk_log2=CHUNK_LOG2, **kw).permanent
        assert ports[tag] == pytest.approx(want, rel=AGREE[tag]), tag
    # n=20 walks K1's reduced entry on a plan; the small-n walk has none
    assert (d["sparse_plan"] is not None) == (n == 20)
    assert not bench.failures(got)


def test_bench_line_has_the_reference_keys(line):
    """The line has every key of bench.py's that the port keeps, the card,
    and each run's Result.time, host wall and spans."""
    n, got = line
    top, detail = reference_keys()
    assert top <= set(got)
    want = {k.replace("n32", f"n{n}") for k in detail - RENAMED}
    assert want <= set(got["detail"])
    assert got["metric"] == f"n{n}_dense_exact_gray_iters_per_sec_per_chip"
    d = got["detail"]
    assert d["rel_err_vs_exact"] == bench.errors(got)["df64"]
    assert "card" in d and d["card"] is None and d["device"] == "cpu"
    assert set(d["runs"]) == set(bench.LIMITS)
    for tag, rec in d["runs"].items():
        assert len(rec["result_time_s"]) == len(rec["host_wall_s"]) == 2
        assert rec["median_host_wall_s"] == np.median(rec["host_wall_s"])
        assert all(w >= t for w, t in zip(rec["host_wall_s"],
                                          rec["result_time_s"]))
        assert all(any(name.startswith("permanent[") for name, _ in spans)
                   for spans in rec["spans"]), tag
    assert min(d["runs"]["df64"]["result_time_s"]) == d["wall_s"]
    assert got["value"] == pytest.approx(
        (1 << (n - 1)) / d["wall_s"] / 1e9, rel=1e-12)
    assert got["vs_baseline"] == pytest.approx(
        got["value"] * 1e9 / bench.BASELINE_ITERS_PER_SEC, rel=1e-12)
    json.dumps(got)                               # the line serialises


def test_bench_main_prints_one_line_and_fails_past_a_limit(capsys,
                                                           monkeypatch):
    argv = ["--device", "cpu", "--n", "16", "--reps", "1",
            "--chunk-log2", str(CHUNK_LOG2)]
    assert bench.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and "vs_baseline" in json.loads(out[-1])
    # f32 stands ~3e-6 from the exact value here: a limit below it fails
    monkeypatch.setitem(bench.LIMITS, "f32", 1e-9)
    assert bench.main(argv) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "f32: rel err" in cap.err


def test_bench_root_reads_the_reference_files(tmp_path):
    """--root reads int/32_0.50_0 and int/32_0.20_0 with the port's
    reader and holds them to bench.py's own oracle values."""
    corpus.write_int_suite(str(tmp_path), 0, ns=(32,),
                           densities=(bench.DENSE, bench.SPARSE))
    mats, oracle = bench.matrices(32, str(tmp_path))
    assert oracle == "native_double"
    for d, want in ((bench.DENSE, bench.NATIVE_DOUBLE_VALUE),
                    (bench.SPARSE, bench.SPARSE_VALID)):
        name, dm, value = mats[d]
        assert name == f"int/32_{d}_0" and value == want
        np.testing.assert_array_equal(dm.mat, corpus.suite_matrix(0, 32, d, 0))
    with pytest.raises(ValueError, match="--n must be 32"):
        bench.matrices(16, str(tmp_path))
    # the seeded oracle is the pinned exact integer at n=32
    mats, oracle = bench.matrices(32)
    assert oracle == "exact"
    assert {d: v for d, (_, _, v) in mats.items()} == bench.EXACT_N32


def test_bench_without_cuda_exits_nonzero_and_prints_no_line():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m",
                           "superman_tpu_torch.tools.bench"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert not any(s.lstrip().startswith("{")
                   for s in proc.stdout.splitlines())
    assert "CUDA is not available" in proc.stderr


GOOD = json.dumps({"metric": "m", "value": 1.5, "unit": "G iters/s",
                   "vs_baseline": 0.35, "detail": {}})
CANNED = {
    "success": (0, f"bench: df64 ok\n{GOOD}\n", "bench: log\n"),
    "rc": (1, "", "Traceback (most recent call last):\nRuntimeError\n"),
    "timeout": (b"bench: df64 ok\n", None, None),
    "unparsable": (0, '{"metric": "m", "value": 1}\n{not json\n', ""),
}


@pytest.mark.parametrize("case", sorted(CANNED))
def test_capture_records_match_the_reference(case, tmp_path, monkeypatch):
    """Both packages' capture tools, given the same subprocess result,
    write records that agree in rc, tail and parsed, and exit alike."""
    first, second, third = CANNED[case]
    calls = []

    def fake_run(args, **kw):
        calls.append((args, kw))
        if case == "timeout":
            raise subprocess.TimeoutExpired(args, kw["timeout"],
                                            output=first)
        return subprocess.CompletedProcess(args, first, second, third)

    monkeypatch.setattr(jax_capture.subprocess, "run", fake_run)
    monkeypatch.setattr(capture_bench.subprocess, "run", fake_run)
    recs, codes = [], []
    for tool, name in ((jax_capture, "jax.json"), (capture_bench,
                                                   "port.json")):
        out = str(tmp_path / name)
        codes.append(tool.main(["--n", "7", "--out", out,
                                "--timeout", "5"]))
        with open(out) as f:
            recs.append(json.load(f))
    jrec, prec = recs
    for key in ("n", "rc", "tail", "parsed"):
        assert prec[key] == jrec[key], key
    assert codes[0] == codes[1] == (0 if case == "success" else 1)
    assert prec["rc"] == {"success": 0, "rc": 1, "timeout": -1,
                          "unparsable": 0}[case]
    assert (prec["parsed"] is not None) == (case == "success")
    assert calls[1][0][1:3] == ["-m", "superman_tpu_torch.tools.bench"]
    assert calls[1][1]["cwd"] == REPO
    assert prec["cmd"].endswith("-m superman_tpu_torch.tools.bench")


def test_capture_default_path_and_refused_name(tmp_path, monkeypatch):
    """The record goes to build/tools/bench_torch_r{N:02d}.json; a
    BENCH_r<N>.json path is refused before the bench runs."""
    assert port_tools.OUT_DIR == Path(REPO, "build", "tools")
    ran = []

    def fake_run(args, **kw):
        ran.append(args)
        return subprocess.CompletedProcess(args, 0, GOOD + "\n", "")

    monkeypatch.setattr(capture_bench.subprocess, "run", fake_run)
    monkeypatch.setattr(port_tools, "OUT_DIR", tmp_path / "build" / "tools")
    assert capture_bench.main(["--n", "12", "--", "--device", "cpu"]) == 0
    written = os.listdir(tmp_path / "build" / "tools")
    assert written == ["bench_torch_r12.json"]
    assert not capture_bench.REFERENCE_NAME.fullmatch(written[0])
    assert ran[0][-2:] == ["--device", "cpu"]
    for name in ("BENCH_r12.json", "BENCH_r05.json"):
        assert capture_bench.main(["--out", str(tmp_path / name)]) == 2
        assert not (tmp_path / name).exists()
    assert len(ran) == 1


#: the JAX package's modules whose counterpart goes by another name
RENAMED_MODULES = {"ops/ryser_pallas.py": "ops/ryser_cuda.py",
                   "ops/ryser_xla.py": "ops/ryser_walk.py"}


def test_every_module_of_the_reference_has_a_counterpart():
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs
                if f.endswith(".py")}

    port = modules("superman_tpu_torch")
    missing = [m for m in sorted(modules("superman_tpu"))
               if RENAMED_MODULES.get(m, m) not in port]
    assert missing == []
