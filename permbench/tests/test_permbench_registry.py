"""A cell, a configuration, a traffic mix and a metric are added by
adding files: the harness finds each by its name in BENCHMARK.json."""

import json
import shutil

from permbench import harness

NEW_METRIC = '''"""calls in the window, a test metric."""


def read(ctx):
    return float(len(ctx.calls))
'''


def _copy_checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.CHECKOUT / "permbench", root / "permbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.CHECKOUT / "BENCHMARK.json", root)
    return root


def test_every_named_file_is_found():
    bench = harness.load_bench()
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.traffic["entry"] in ("permanent", "permanent_batch")
        assert cell.per_layer and cell.end_to_end
        for entry, mod in cell.per_layer:
            assert callable(mod.read), entry["name"]
    names = {m["name"] for m in bench["per_layer"]}
    files = {p.stem for p in (harness.CHECKOUT / "permbench"
                              / "metrics").glob("*.py")}
    assert names == files


def test_new_files_register_without_edits(tmp_path):
    root = _copy_checkout(tmp_path)
    pb = root / "permbench"
    cfg = json.loads((pb / "configs" / "erdos_int_dense.json").read_text())
    cfg.update(name="erdos_int_mid", density=0.3)
    (pb / "configs" / "erdos_int_mid.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "n32.json").read_text())
    tr.update(order=19, calc="df64", pool=3, check_sample=1,
              warmup_calls=1, flags={"chunk_log2": 8})
    (pb / "traffic" / "n19.json").write_text(json.dumps(tr))
    (pb / "metrics" / "calls_seen.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "erdos_int_mid", "source": "x",
                             "file": "permbench/configs/erdos_int_mid.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "erdos_int_mid.n19",
                               "config": "erdos_int_mid", "traffic": "n19",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "harness", "moves": "perms_per_s",
                               "workloads": ["erdos_int_mid.n19"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("erdos_int_mid.n19", root)
    assert cell.config["density"] == 0.3
    # the other metrics list the cells they read
    assert [e["name"] for e, _ in cell.per_layer] == ["calls_seen"]
    line = harness.run_cell(cell, 1, 1, True, device="cpu",
                            log=lambda msg: None)
    assert line["correct"]
    assert line["metrics"]["calls_seen"]["value"] == line["attempted"]
    line = harness.run_cell(cell, 1, 1, False, device="cpu",
                            log=lambda msg: None)
    # p95_ms is bounded only in the cells it lists
    assert set(line["metrics"]) == {"setup_s", "perms_per_s"}
