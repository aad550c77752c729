"""BENCHMARK.json resolves by name into data files, mixes and readers; a run
prints the contract's last line; without a card run.py exits with no
result."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

import pb_small
from harness import runner, spec

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_by_name(name):
    c = spec.load_cell(name)
    assert c.config["name"] == [w for w in BENCH["workloads"]
                                if w["name"] == name][0]["config"]
    assert hasattr(c.mix_module(), "Mix")
    readers = c.readers()
    assert readers and all(callable(r) for r in readers.values())
    assert set(c.settings["limits"]) and all(
        v > 0 for v in c.settings["limits"].values())
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(c.end_to_end) >= 3


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for cfg in BENCH["configs"]:
        assert cfg["file"].startswith("portbench/") and os.path.exists(
            os.path.join(ROOT, cfg["file"]))
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert os.path.exists(os.path.join(pb_small.BENCH, "metrics",
                                           m["name"] + ".py"))
        layers.setdefault(m["layer"], set()).add(m["name"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(pb_small.BENCH, "traffic",
                                           w["traffic"] + ".json"))


def _keys_in_order(out, trace):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in out["metrics"].values():
        assert {"value", "unit"} <= set(m)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(trace):
    c = pb_small.cell("cornell-nee-render")
    out = runner.run(c, 2 ** 31 + 5, 0.3, bool(trace), torch.device("cpu"),
                     0.0)
    _keys_in_order(out, trace)
    assert out["correct"] is True
    json.dumps(out)
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    else:
        # the host-span readers find something on the CPU; the device ones
        # return nothing there
        assert "readback_ms" in out["metrics"]
        assert "device_busy_pct.render" not in out["metrics"]


def test_run_py_without_a_card_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr and "no result" in p.stderr


def test_run_py_refuses_an_unknown_cell():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "no-such-cell", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(card, name):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        name, "--seed", str(2 ** 31 + 11), "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
