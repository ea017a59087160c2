"""The harness is data: a configuration, a traffic mix and a metric added
as files in a copy of the benchmark run without an edit to any file the
benchmark already has."""
import hashlib
import json
import shutil

import pytest

from benchmark import harness

FIXTURE_CONFIG = {"name": "fixture", "width": 32, "height": 16,
                  "channels": 4, "content": "mixed", "alpha": "varying",
                  "palette_classes": ["alpha_triple", "distinct"]}
FIXTURE_MIX = {"entry": "encode", "pool": 4}
FIXTURE_METRIC = '''"""fixture_requests: requests in the window."""


def read(ctx):
    return ctx.window.attempted
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_new_cell_from_files_alone(copy):
    before = _digests(copy)
    b = (copy / "benchmark")
    (b / "configs" / "fixture.json").write_text(json.dumps(FIXTURE_CONFIG))
    (b / "traffic" / "fixture-mix.json").write_text(json.dumps(FIXTURE_MIX))
    (b / "metrics" / "fixture_requests.py").write_text(FIXTURE_METRIC)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "fixture", "source": "test",
                             "file": "benchmark/configs/fixture.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "fixture.cell", "config": "fixture",
                               "traffic": "fixture-mix", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "fixture_requests", "unit": "1",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["fixture.cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("fixture.cell", copy)
    assert cell.config["width"] == 32 and cell.traffic["pool"] == 4
    assert sorted(m.name for m in cell.end_to_end) == ["fixture_requests",
                                                       "setup_s"]
    assert [m.name for m in cell.per_layer] == []
    result, notes = harness.run_cell("fixture.cell", 5, 0.2, False,
                                     device="cpu", root=copy)
    assert result["correct"]
    assert result["metrics"]["fixture_requests"]["value"] == \
        result["attempted"]
    assert set(result["metrics"]) == {"fixture_requests", "setup_s"}
    after = _digests(copy)
    assert {k: v for k, v in after.items() if k in before} == before


def test_cells_of_the_benchmark_load():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("mix", [dict(FIXTURE_MIX, in_flight=2),
                                 {"entry": "encode"}])
def test_unsupported_traffic_refused(copy, mix):
    # the harness has one traffic shape: a mix that sets anything but the
    # entry and the pool is refused, not run as if it had not
    (copy / "benchmark" / "traffic" / "encode-1x.json").write_text(
        json.dumps(mix))
    with pytest.raises(ValueError):
        harness.load_cell("capture4k-encode", copy)


def test_pool_holds_the_classes_in_their_shares(copy):
    (copy / "benchmark" / "traffic" / "encode-1x.json").write_text(
        json.dumps({"entry": "encode", "pool": 6}))
    cell = harness.load_cell("capture4k-encode", copy)
    with pytest.raises(ValueError):
        harness.make_inputs(cell, dict(cell.config, width=16, height=8), 1,
                            "cpu")
