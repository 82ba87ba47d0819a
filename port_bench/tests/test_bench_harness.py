"""The harness on the CPU: the names in BENCHMARK.json, which cell
reports what, the result line, the refusal without a card, the count
functions and the traffic generator against numbers worked out by hand,
and a cell added by data alone."""
import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import counts
import harness
import streams
from cpu_run import IRIS, MNIST, MNIST_CONFIG, cpu_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
ALL = BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units():
    names = ([m["name"] for m in ALL] + [w["name"] for w in BENCH["workloads"]]
             + [c["name"] for c in BENCH["configs"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in ALL:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in (ALL, BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_what_its_metrics_move():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in cells:
        ends = {m["name"] for m in harness.metrics_of(BENCH, cell,
                                                      "end_to_end")}
        layers = harness.metrics_of(BENCH, cell, "per_layer")
        assert len(ends - {"setup_s"}) >= 1 and layers, cell
        for m in layers:
            assert m["moves"] in ends, (cell, m["name"])
    for m in ALL:
        assert set(m.get("workloads", cells)) <= set(cells), m["name"]


def test_every_name_has_its_file():
    for m in ALL:
        kind = "metrics" if m in BENCH["end_to_end"] else "layers"
        assert (harness.HERE / kind / f"{m['name']}.py").exists()
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        c = harness.cell(BENCH, w["name"])
        assert (harness.HERE / "drivers"
                / f"{c['traffic']['driver']}.py").exists()


KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name,config,small,ends", [
    ("iris16-k8192-online", None, IRIS,
     {"train_points_per_s", "serve_p95_ms", "setup_s"}),
    ("mnist-demo-k16-online", MNIST_CONFIG, MNIST,
     {"train_points_per_s", "setup_s"})])
def test_result_line_keys(name, config, small, ends, capsys):
    r, line = cpu_run(name, config=config, **small)
    assert list(line) == KEYS
    assert set(line["metrics"]) == ends
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    json.dumps(line)
    assert set(line["checks"]) == set(r.checks)
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    # and to standard error, each beside its limit
    capsys.readouterr()
    harness.print_checks(r)
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == len(r.checks) >= 7
    assert all(e.startswith("check ") and "(limit 0)" in e for e in err)


def test_traced_line_without_a_profile_leaves_the_device_metrics_out():
    r, line = cpu_run("iris16-k8192-online", trace=True, **IRIS)
    # a CPU run has no device trace: nothing is read as 0, and with no
    # trace there is no breakdown either (it would come before "checks")
    assert list(line) == KEYS
    assert "device_idle_share.online" not in line["metrics"]
    assert "feedback_roofline.online" not in line["metrics"]
    assert line["metrics"]["tick_ms.online"]["value"] > 0


def test_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "mnist-demo-k16-online", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stdout == ""


def test_counts_by_hand():
    # MNIST demo fleet: 10 x 2000 x 1568 automata, K = D = 16, int16
    assert counts.automata(10, 2000, 1568) == 31_360_000
    assert counts.clause_bytes(16, 16, 10, 2000, 1568) == 504_345_088
    assert counts.feedback_bytes(16, 16, 10, 2000, 1568, 2) == 2_008_025_216
    assert counts.uniforms(16, 10, 2000, 1568) == 501_824_160
    assert counts.learn_ops(16, 10, 2000, 1568) == 1_003_520_000
    # iris fleet: 3 x 16 x 32, K = D = 8192, int8
    assert counts.automata(3, 16, 32) == 1_536
    assert counts.clause_bytes(8192, 8192, 3, 16, 32) == 15_990_784
    assert counts.feedback_bytes(8192, 8192, 3, 16, 32, 1) == 26_673_152
    assert counts.uniforms(8192, 3, 16, 32) == 12_869_632
    # the uniforms are not bytes of the update: D moves only the literals
    assert (counts.feedback_bytes(8192, 128, 3, 16, 32, 1)
            == 26_673_152 - (8192 - 128) * 32)


def test_streams_by_hand():
    y = np.arange(10) % 5
    idx, lab = streams.replica_stream(y, 3, 25, seed=2**31 + 1)
    assert sorted(idx[:10]) == list(range(10))         # a permutation a pass
    assert sorted(idx[10:20]) == list(range(10))
    assert len(set(idx[20:])) == 5
    np.testing.assert_array_equal(lab, y[idx])
    again = streams.replica_stream(y, 3, 25, seed=2**31 + 1)
    np.testing.assert_array_equal(again[0], idx)
    other = streams.replica_stream(y, 4, 25, seed=2**31 + 1)
    assert not np.array_equal(other[0], idx)
    both = streams.streams(y, [3, 4], 25, seed=2**31 + 1)
    np.testing.assert_array_equal(both[0], np.stack([idx, other[0]]))


def test_a_cell_is_added_by_data_alone(tmp_path):
    """A throwaway cell (its traffic file and its BENCHMARK.json entry,
    in a copy) runs with no file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (root / "port_bench" / "traffic" / "tiny-fleet.json").write_text(
        json.dumps(dict(json.loads((harness.HERE / "traffic" /
                                    "fleet-k8192.json").read_text()),
                        **dict(IRIS, replicas=6, chunk=8))))
    bench["workloads"].append({"name": "iris16-k6-tiny", "config":
                               "tm-iris16", "traffic": "tiny-fleet",
                               "chips": 1, "why": "a throwaway cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "iris16-k8192-online" in m["workloads"]:
            m["workloads"].append("iris16-k6-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, sys, time
sys.path[:0] = [{str(root / 'port_bench')!r}, {str(harness.ROOT / 'src')!r}]
import harness, run
assert harness.ROOT == harness.Path({str(root)!r})
bench = harness.load_benchmark()
c = harness.cell(bench, "iris16-k6-tiny")
r = harness.Run(workload="iris16-k6-tiny", seed=5, seconds=1.0, trace=False,
                device="cpu", config=c["config"], traffic=c["traffic"],
                t_start=time.perf_counter())
print(json.dumps(run.execute(bench, r)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert "train_points_per_s" in line["metrics"]


@pytest.mark.gpu
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "iris16-k8192-online", "--seed", str(2**31 + 9), "--seconds", "3",
         "--trace", "1"], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for name in ("feedback_roofline.online", "clause_roofline.online"):
        assert 0 < line["metrics"][name]["value"] <= 100
