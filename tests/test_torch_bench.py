"""The port's headline benchmark and probes against the repository's own
(``bench.py``, ``tools/bench_tagger.py``, ``tools/mfu_probe.py``,
``tools/bench_swin.py``, ``tools/trace_ops.py``), on the CPU at tiny sizes.

* ``synth_hashes`` gives the JAX original's bytes;
* ``python -m kobato_eyes_tpu_torch.bench`` at ``KET_BENCH_N=3000`` prints
  the JAX tool's keys, the same route and routing constant, and the headline
  scan's clusters equal the JAX tool's;
* the probes print the JAX tools' keys (read from the JAX source where its
  CPU run costs too much), the same analytic FLOPs, and no MFU on the CPU;
* ``trace_ops`` ranks a fixed trace as the JAX tool does, reads the
  ``.gz``, shortens kernel names and summarizes a real CPU trace;
* every tool raises when asked for ``cuda`` without a card.
"""

from __future__ import annotations

import gzip
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kobato_eyes_tpu.dup import engine as jengine
from kobato_eyes_tpu.models import swin as jswin
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch import bench as tbench
from kobato_eyes_tpu_torch.dup import engine as tengine
from kobato_eyes_tpu_torch.models import swin as tswin
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.tools import bench_swin, bench_tagger, mfu_probe, trace_ops
from kobato_eyes_tpu_torch.utils.profiling import PEAK_BF16_FLOPS, device_trace, peak_flops_for, roofline_summary
from tests.torch_bench_helpers import ROOT, dumps_keys, key_tree, last_json, load_jax_tool, run_main
from tests.torch_native import native_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

N_HASHES = 3000
TOOLS = ("bench", "tools.bench_tagger", "tools.bench_swin", "tools.mfu_probe",
         "tools.bench_query", "tools.bench_ann", "tools.bench_e2e")


# ---------------------------------------------------------------------------
# bench.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(N_HASHES, 1234), (257, 7)])
def test_synth_hashes_equal_the_jax_bytes(n, seed):
    jbench = load_jax_tool("bench.py")
    want = jbench.synth_hashes(n, seed)
    got = tbench.synth_hashes(n, seed)
    assert got.dtype == want.dtype == np.uint64
    assert got.tobytes() == want.tobytes()


def _recording(cls, token, log):
    """``cls.build_clusters`` that keeps the clusters of every call made
    with ``token`` (the headline population's)."""
    original = cls.build_clusters

    def build_clusters(self, files, *, files_token=None):
        out = original(self, files, files_token=files_token)
        if files_token == token:
            log.append(out)
        return out

    return build_clusters


@pytest.fixture(scope="module")
def bench_runs():
    """Both packages' headline benchmark at ``KET_BENCH_N=3000``, with the
    clusters of every scan of the headline population."""
    token = ("bench", tbench.SEED, N_HASHES)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KET_BENCH_N", str(N_HASHES))
        jax_log, port_log = [], []
        mp.setattr(jengine.TpuDuplicateScanner, "build_clusters",
                   _recording(jengine.TpuDuplicateScanner, token, jax_log))
        mp.setattr(tengine.TpuDuplicateScanner, "build_clusters",
                   _recording(tengine.TpuDuplicateScanner, token, port_log))
        jbench = load_jax_tool("bench.py")  # reads KET_BENCH_N when imported
        rc, out = run_main(jbench.main, None)
        runs["jax"] = (rc, last_json(out), jax_log)
        rc, out = run_main(tbench.main, ["--device", "cpu"])
        runs["port"] = (rc, last_json(out), port_log)
    return runs


def test_bench_prints_the_jax_keys(bench_runs):
    (_, want, _), (rc, got, _) = bench_runs["jax"], bench_runs["port"]
    assert rc == 0
    assert key_tree(got) == key_tree(want)
    assert got["metric"] == want["metric"] == "dup_scan_pairs_per_sec_3k"
    assert got["unit"] == "pairs/s"
    assert got["value"] > 0 and got["vs_baseline"] > 0
    # the CPU side ran the whole population, so min-vs-min is reported
    assert got["vs_baseline_min_wall"] is not None


def test_bench_route_and_routing_constant_equal_the_jax_tool(bench_runs):
    want, got = bench_runs["jax"][1], bench_runs["port"][1]
    assert got["headline_path"] == want["headline_path"] == "host"
    assert got["host_scan_max"] == want["host_scan_max"]


def test_bench_clusters_equal_the_jax_tool(bench_runs):
    want, got = bench_runs["jax"][2], bench_runs["port"][2]
    assert len(got) >= 5 and len(want) >= 5  # warm-up, 3 timed, device route, memo
    expected = jengine.cluster_ids(want[-1])
    assert expected, "the planted population has clusters"
    for clusters in got:
        assert tengine.cluster_ids(clusters) == expected


def test_bench_crossover_probe_ran(bench_runs):
    probe = bench_runs["port"][1]["crossover_probe"]
    assert "error" not in probe, probe
    assert 4096 <= probe["derived_host_scan_max"] <= 1 << 22


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_asked_for_cuda_without_a_card_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"kobato_eyes_tpu_torch.{tool}")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        module.main([])


# ---------------------------------------------------------------------------
# tagger probes
# ---------------------------------------------------------------------------

TAGGER_ARGS = ["--preset", "tiny", "--image-size", "64", "--labels", "64",
               "--batch-size", "4", "--synthetic", "12"]


@pytest.fixture(scope="module")
def tagger_runs(tmp_path_factory):
    jtool = load_jax_tool("tools/bench_tagger.py")
    rc_j, out_j = run_main(jtool.main, TAGGER_ARGS)
    profile = tmp_path_factory.mktemp("tagger_profile")
    rc_p, out_p = run_main(bench_tagger.main, TAGGER_ARGS + ["--device", "cpu", "--profile", str(profile)])
    return (rc_j, last_json(out_j)), (rc_p, last_json(out_p)), profile


def test_bench_tagger_prints_the_jax_keys(tagger_runs):
    (rc_j, want), (rc_p, got), _ = tagger_runs
    assert rc_j == rc_p == 0
    assert key_tree(got) == key_tree(want)
    for key in ("metric", "batch_size", "image_size", "labels", "preset", "batches_timed"):
        assert got[key] == want[key], key
    assert got["value"] > 0


def test_bench_tagger_roofline_is_analytic_and_has_no_cpu_mfu(tagger_runs):
    (_, want), (_, got), _ = tagger_runs
    cfg = tvit.vit_config("tiny", image_size=64, num_classes=64)
    assert got["roofline"]["flops"] == want["roofline"]["flops"] == tvit.vit_forward_flops(cfg, 4)
    assert got["roofline"]["mfu"] is None and got["roofline"]["peak_tflops"] is None
    # on the CPU the counted cost sees the plain attention too
    assert got["roofline"]["compiled_flops_scan_body"] >= got["roofline"]["flops"] * 0.9


def test_bench_tagger_profile_is_summarized(tagger_runs, capsys):
    profile = tagger_runs[2]
    assert (profile / "trace.json").stat().st_size > 0
    assert trace_ops.main([str(profile), "--device", "cpu", "--top", "50"]) == 0
    out = capsys.readouterr().out
    assert "aten::" in out and out.startswith("device events: ")


def _tiny_vit(real):
    """``vit_config`` cut to the tiny preset at 64 px (the probe builds
    ViT-B/448, too slow for the CPU)."""
    return lambda preset, **kw: real("tiny", **{**kw, "image_size": 64})


@pytest.mark.parametrize("variant", [[], ["--attn", "fused"], ["--bf16-params", "--unroll", "2"]],
                         ids=["einsum", "fused", "bf16_params"])
def test_mfu_probe_prints_the_jax_keys(variant, monkeypatch):
    monkeypatch.setattr(mfu_probe, "vit_config", _tiny_vit(tvit.vit_config))
    rc, out = run_main(mfu_probe.main, ["--device", "cpu", "--batch", "2", "--repeats", "1",
                                        "--labels", "16", *variant])
    got = last_json(out)
    assert rc == 0
    assert key_tree(got) == dumps_keys("tools/mfu_probe.py")
    assert got["mfu_pct"] is None
    assert got["ms_per_batch"] > 0
    assert got["variant"]["attn"] == ("fused" if "fused" in variant else "einsum")
    assert got["variant"]["bf16_params"] == ("--bf16-params" in variant)


def test_mfu_probe_flops_equal_the_jax_formula():
    for preset, size in (("base", 448), ("tiny", 64)):
        want = jvit.vit_forward_flops(jvit.vit_config(preset, image_size=size, num_classes=9083), 32)
        got = tvit.vit_forward_flops(tvit.vit_config(preset, image_size=size, num_classes=9083), 32)
        assert got == want


@pytest.mark.parametrize("variant", [[], ["--ln", "pallas_residual", "--qk", "bf16"],
                                     ["--attn", "einsum"]],
                         ids=["pallas", "residual_ln_bf16_qk", "einsum"])
def test_bench_swin_prints_the_jax_keys(variant):
    rc, out = run_main(bench_swin.main, ["--device", "cpu", "--preset", "tiny", "--image-size", "224",
                                         "--labels", "16", "--batch", "1", "--repeats", "1", *variant])
    got = last_json(out)
    assert rc == 0
    assert key_tree(got) == dumps_keys("tools/bench_swin.py")
    assert got["mfu_pct"] is None
    assert got["ms_per_batch"] > 0
    assert got["variant"]["attn"] == ("einsum" if "einsum" in variant else "pallas")


def test_bench_swin_flops_equal_the_jax_formula():
    for preset, size in (("base", 448), ("tiny", 224)):
        want = jswin.swin_forward_flops(jswin.swin_config(preset, image_size=size, num_classes=9083), 32)
        got = tswin.swin_forward_flops(tswin.swin_config(preset, image_size=size, num_classes=9083), 32)
        assert got == want


def test_peak_is_the_cards_and_none_on_the_cpu(monkeypatch):
    assert peak_flops_for("cpu") is None
    out = roofline_summary(1e12, 0.5, device="cpu")
    assert out["achieved_tflops"] == 2.0 and out["mfu"] is None and out["peak_tflops"] is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert peak_flops_for("cuda") == PEAK_BF16_FLOPS["h100"] == 989e12
    assert roofline_summary(98.9e12, 1.0, device="cuda")["mfu"] == pytest.approx(0.1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Other Card")
    with pytest.raises(RuntimeError, match="no published bf16 peak"):
        peak_flops_for("cuda")


def test_probes_use_no_tpu_peak():
    for module in (mfu_probe, bench_swin, bench_tagger):
        assert "197e12" not in Path(module.__file__).read_text(encoding="utf-8")


# ---------------------------------------------------------------------------
# trace_ops
# ---------------------------------------------------------------------------

WGMMA_MANGLED = "_Z17attn_wgmma_kernelILi64ELb1ELb0EEvPK13__nv_bfloat16S2_S2_PS0_iiif"


def _event(name, cat, dur, ts=0.0, pid=1, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "dur": dur, "ts": ts, "pid": pid, "tid": tid}


def fixed_trace() -> dict:
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:GPU:0"}},
        _event("void attn_wgmma_kernel<64, true, false>(__nv_bfloat16 const*, float*, int)", "kernel", 300.0),
        _event("void attn_wgmma_kernel<64, true, false>(__nv_bfloat16 const*, float*, int)", "kernel", 310.0),
        _event(WGMMA_MANGLED, "kernel", 290.0),
        _event("void gelu_lut_kernel<true>(__nv_bfloat16*, int)", "kernel", 100.0),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 50.0),
        _event("Memset (Device)", "gpu_memset", 50.0),
        _event("aten::matmul", "cpu_op", 9000.0, pid=2),
        _event("cudaLaunchKernel", "cuda_runtime", 4.0, pid=2),
    ]}


@pytest.mark.parametrize("name", ["trace.json", "trace.json.gz"])
def test_trace_ops_ranks_a_fixed_trace(tmp_path, name, capsys):
    sub = tmp_path / "run"
    sub.mkdir()
    text = json.dumps(fixed_trace())
    if name.endswith(".gz"):
        with gzip.open(sub / name, "wt", encoding="utf-8") as fh:
            fh.write(text)
    else:
        (sub / name).write_text(text, encoding="utf-8")
    assert trace_ops.main([str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device events: 6, total 1.10 ms"
    assert lines[1].split() == ["0.61", "ms", "55.5%", "x2", "attn_wgmma_kernel<64,true,false>"]
    assert lines[2].split() == ["0.29", "ms", "26.4%", "x1", "attn_wgmma_kernel<64,1,0>"]
    assert lines[3].split()[-1] == "gelu_lut_kernel<true>"
    assert len(lines) == 6  # the host's op and runtime call are not device events
    assert trace_ops.main([str(tmp_path), "--top", "1", "--raw"]) == 0
    raw = capsys.readouterr().out.splitlines()
    assert len(raw) == 2 and raw[1].endswith("(__nv_bfloat16 const*, float*, int)")


def test_trace_ops_prints_as_the_jax_tool_on_a_shared_trace(tmp_path, capsys):
    """A trace both tools read (a device process name for the JAX tool, the
    kernel category for the port's; XLA-style op names): the same lines."""
    names = ["fusion.12", "fusion.3", "copy.1", "convolution", "fusion.7", "copy.44"]
    trace = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 3, "args": {"name": "/device:GPU:0 Compute"}},
        *[_event(n, "kernel", 10.0 * (i + 1), pid=3) for i, n in enumerate(names)],
    ]}
    with gzip.open(tmp_path / "host.trace.json.gz", "wt", encoding="utf-8") as fh:
        json.dump(trace, fh)
    jtool = load_jax_tool("tools/trace_ops.py")
    for argv in ([str(tmp_path)], [str(tmp_path), "--raw", "--top", "3"]):
        assert jtool.main(argv) == 0
        want = capsys.readouterr().out
        assert trace_ops.main(argv) == 0
        assert capsys.readouterr().out == want


def test_trace_ops_shortens_kernel_names():
    assert trace_ops._group(WGMMA_MANGLED) == "attn_wgmma_kernel<64,1,0>"
    assert trace_ops._group("void k<(anonymous namespace)::f<float>, 2>(int, float)") == \
        "k<(anonymous namespace)::f<float>,2>"
    assert trace_ops._group("fusion.123") == "fusion"
    assert trace_ops.short_kernel_name("cudaMemcpyAsync") == "cudaMemcpyAsync"


def test_trace_ops_on_a_real_cpu_trace(tmp_path, capsys):
    with device_trace(tmp_path / "prof"):
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
        torch.square(torch.arange(8.0))
    rows = trace_ops.summarize(trace_ops.load_trace(tmp_path), device="cpu")
    names = [name for name, _, _ in rows]
    assert "aten::matmul" in names and "aten::square" in names
    assert "aten::mm" not in names  # nested inside aten::matmul: not counted twice
    assert trace_ops.main([str(tmp_path), "--device", "cpu"]) == 0
    assert "aten::matmul" in capsys.readouterr().out
    # a CPU trace holds no device events
    assert trace_ops.main([str(tmp_path)]) == 1


def test_trace_ops_without_a_trace_exits(tmp_path):
    with pytest.raises(SystemExit, match="no trace.json"):
        trace_ops.main([str(tmp_path)])
