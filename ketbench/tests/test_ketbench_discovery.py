"""A cell, a configuration, a traffic mix and a per-layer metric added as
files and entries only, in a copy of the benchmark, are found and run."""

import json
import shutil

from ketbench.core import cell_metrics, load_benchmark, load_config, load_reader, load_traffic
from ketbench.run import result_line, run_cell
from ketbench.tests.tiny import tiny

NEW_METRIC = '''
def read(run):
    return run.counters.get("forwards")
'''


def test_added_files_are_found(tmp_path):
    from ketbench.core import ROOT

    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "ketbench", root / "ketbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = load_benchmark()
    cfg_doc = json.loads((ROOT / "ketbench/configs/wd14-vit-b16-448.json").read_text())
    cfg_doc["num_hidden_layers"] = 6
    (root / "ketbench/configs/vit-six.json").write_text(json.dumps(cfg_doc))
    mix = json.loads((ROOT / "ketbench/traffic/tag-prepared.json").read_text())
    mix["pipeline_depth"] = 1
    (root / "ketbench/traffic/tag-serial.json").write_text(json.dumps(mix))
    (root / "ketbench/metrics/tag.forwards.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "vit-six", "source": "https://example.org/vit", "why": "test",
                             "file": "ketbench/configs/vit-six.json", "reduced": ["num_hidden_layers"]})
    bench["workloads"].append({"name": "vit-serial", "config": "vit-six", "traffic": "tag-serial",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("vit-serial")
    bench["per_layer"].append({"name": "tag.forwards", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "tagger", "moves": "tag_images_per_s",
                               "workloads": ["vit-serial"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    assert load_config(bench, "vit-six", root)["num_hidden_layers"] == 6
    assert load_traffic("tag-serial", root)["pipeline_depth"] == 1
    assert load_reader("tag.forwards", root) is not None
    assert [m["name"] for m in cell_metrics(bench, "vit-serial", trace=True)] == ["tag.forwards"]
    assert {m["name"] for m in cell_metrics(bench, "vit-serial", trace=False)} == {"tag_images_per_s", "setup_s"}

    record, ctx = run_cell("vit-serial", seed=3, seconds=0.3, trace=True, device="cpu", root=root, edit=tiny)
    line = result_line(bench, ctx, record, root=root)
    assert line["correct"] is True
    assert line["metrics"]["tag.forwards"]["value"] == record.counters["forwards"] > 0


def test_per_layer_metric_without_workloads_follows_its_end_to_end_metric():
    bench = load_benchmark()
    bench["per_layer"].append({"name": "x", "unit": "ms", "better": "lower", "source": "host_clock",
                               "layer": "tagger", "moves": "query_p95_ms"})
    assert "x" in [m["name"] for m in cell_metrics(bench, "vit-query", trace=True)]
    assert "x" not in [m["name"] for m in cell_metrics(bench, "vit-tag", trace=True)]
