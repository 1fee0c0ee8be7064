"""``kernel.layernorm_ms``: the LayerNorm kernel's device time in the traced
window over the forwards completed there, on hand-built traces; nothing
without the kernel (the parent of the kernel), without a trace or without
forwards."""

import json

from ketbench.core import ROOT, RunRecord, Trace, load_reader

KERNEL = "void (anonymous namespace)::layernorm_rows_kernel<__nv_bfloat16, __nv_bfloat16, 8, 32, 4>((anonymous namespace)::Args)"


def run_of(trace, forwards=4):
    return RunRecord(correct=True, attempted=0, failed=0, e2e={}, checks={}, trace=trace,
                     counters={"forwards": forwards, "batch_size": 32})


def trace(*ops):
    return Trace(window=(0, int(1e9)), ops=list(ops), spans=[])


def test_milliseconds_a_forward_of_the_kernel_alone():
    read = load_reader("kernel.layernorm_ms")
    ops = [(KERNEL, 1_000_000, 1_500_000), (KERNEL, 2_000_000, 2_250_000),
           ("void (anonymous namespace)::layernorm_rows_kernel<float, __nv_bfloat16, 4, 32, 8>(Args)", 3_000_000, 3_250_000),
           ("void (anonymous namespace)::ln_res_vec_kernel<__nv_bfloat16, 16, 1>(...)", 4_000_000, 9_000_000),
           ("void at::native::reduce_kernel<512, 1, ReduceOp<float, MeanOps<float, float, float, float>>>", 0, 900_000)]
    assert read(run_of(trace(*ops))) == 1.0 / 4  # 0.5 + 0.25 + 0.25 ms over 4 forwards


def test_nothing_without_the_kernel_a_trace_or_forwards():
    read = load_reader("kernel.layernorm_ms")
    assert read(run_of(trace(("void at::native::vectorized_elementwise_kernel<4>", 0, 10)))) is None
    assert read(run_of(None)) is None
    assert read(run_of(trace((KERNEL, 0, 10)), forwards=0)) is None


def test_entry_reads_the_tagging_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["per_layer"][-1] == {
        "name": "kernel.layernorm_ms", "unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "kernels", "moves": "tag_images_per_s", "workloads": ["vit-tag", "swin-tag", "pixai-tag"]}
