#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``kobato_eyes_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``kobato_eyes_tpu_torch/csrc``
with nvcc (sm_90a, one nvcc per source, all at once), holds each kernel
against its plain torch version on the card at the shapes the main paths
give it, then drives the main paths over 256 seeded images (8192 labels,
batch 32, random seeded weights):

* ViT: ``index`` through the port's CLI with the WD14 ViT-B/16 @ 448 tagger,
  and a ``search --backend sql`` for a tag the run assigned;
* SwinV2: ``run_index_once`` with the WD14 SwinV2-B/448 tagger, a
  ``search --backend sql`` through the CLI, a forward with the residual
  LayerNorm kernel (``ln_impl="pallas_residual"``), and
  ``validate-checkpoint --arch swinv2`` through the CLI on the index
  tagger's saved weights;
* dup: the dup benchmark's 70 000-hash population through
  ``TpuDuplicateScanner`` on the host route (C++ band scan) and the device
  route (resident bitmask scan), the threshold sweep, the CPU oracle on a
  subset, a 1M population through the resident multi-word scan against the
  host scan, and ``audit_clusters`` over the 70k clusters with the
  all-pairs Hamming kernel; then ``index`` (fused signatures), ``dup
  --sweep --audit`` and ``dup --refine`` through the CLI over 48 seeded
  images with re-encodes and resizes;
* query: on the ViT run's catalog, ``search`` with the default (device)
  backend through the CLI against ``--backend sql`` line for line, a
  three-query batch and the snapshot's reuse; a ViT index run with an
  ``EpochManager`` (a full epoch build, then a delta on a second run); a
  seeded 20 000-file catalog on which every query of a list equals the SQL
  backend in ids and relevance, the batch equals the singles and
  ``update_epoch`` equals a fresh ``build_epoch``; and 1 000 000 files with
  ~31 M postings through ``_assemble_epoch``, masks against a plain numpy
  evaluation, build wall, device memory and query latencies;
* ANN: the CLIP ViT-B/32 @ 224 embed forward (ms, MFU), an index run with
  ``index.enabled`` whose fused lane must embed every tagged file from the
  tagger's own device tensor, flat search at 1M x 512 against an f64
  evaluation (planted duplicates: ties lowest row first), IVF at 1M with
  its recall against flat, HNSW at 20 000 on the host, and ``ann
  --similar-to``, ``--build`` and ``--query-image`` through the CLI.

Kernels 3 and 5 run shorter than the host takes to enqueue a call, so their
times are taken through CUDA graphs. Each kernel's launch count is set to 0
just before the path that runs it and read just after; the attention
wrapper counts its packed and its separate-q, k, v entries apart, and the
latter's count is summed over the ViT, SwinV2 and ANN index runs. It checks each tagger's fast forward against its exact
forward, and prints one JSON line of kernel numbers, then
``{"ok": true, "device": {...}}`` as the last line. Any failed phase exits
non-zero before the last line. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate, the bf16
# tensor-core rate and the f32 rate outside the tensor cores. The kernels'
# bounds use these.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
DEVICE = "cuda"

VIT_B448 = dict(batch=32, tokens=785, heads=12, head_dim=64)
# SwinV2-B/448 window attention per stage: (windows per image, heads); every
# stage has n = 7*7 tokens per window and head_dim 32
SWIN_B448_STAGES = ((256, 4), (64, 8), (16, 16), (4, 32))
SWIN_B448_DEPTHS = (2, 2, 18, 2)
SWIN_WINDOW = 7
N_IMAGES = 256
BATCH = 32
N_LABELS = 8192
# dup path: the dup benchmark's population (70 000 hashes, 30% planted
# near-duplicates, threshold 8), a 1M population above the host/device
# crossover, the audit's batch bound, and the CLI library's base images
N_DUP = 70_000
N_DUP_BIG = 1_000_000
DUP_SEED = 1234
AUDIT_BATCH = 4096
DUP_LIB_IMAGES = 48
# ANN path: the flat and IVF corpus (1M x 512 f32, 2.05 GB resident), its
# query batch, IVF's clusters, Lloyd steps and probes, the HNSW corpus
ANN_N = 1_000_000
ANN_DIM = 512
ANN_QUERIES = 32
ANN_K = 10
ANN_CLUSTERS = 1000
ANN_PLANTED = 16  # source rows, each copied to 4 other rows: 64 planted duplicates
IVF_ITERS = 10
IVF_NPROBE = 8
HNSW_N = 20_000


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def synchronize() -> None:
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fns, replays: int = 5) -> float:
    """Mean device time of one call, with the calls of ``fns`` captured into
    one CUDA graph and replayed: the host's time to enqueue a call (tens of
    microseconds through a Python wrapper) is out of the reading, which
    ``cuda_ms`` cannot keep out for a kernel shorter than that."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:  # warm up (and build) outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * len(fns))


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def build_kernels() -> float:
    """Compile every source in csrc/ at once (one nvcc each); returns seconds."""
    from kobato_eyes_tpu_torch.ops import build

    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        libs = list(pool.map(build.build, sources))
    seconds = time.perf_counter() - t0
    for lib in libs:
        log = lib.with_suffix(".log").read_text(encoding="utf-8") if lib.with_suffix(".log").exists() else ""
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib.name}: {line.strip()}")
    print(f"kernel build: {len(sources)} source(s) in {seconds:.1f} s")
    return seconds


# ---------------------------------------------------------------------------
# Kernel phase: each kernel against its plain version on the card
# ---------------------------------------------------------------------------


def _extreme_qkv(t: int, h: int, d: int, seed: int):
    """q aligned or anti-aligned with k at magnitude 100: logits in +-1e4."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u = rng.normal(size=(t, d))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sign = np.where(rng.random((t, 1)) < 0.5, 1.0, -1.0)
    q = np.broadcast_to((100.0 * u)[None, :, None, :], (1, t, h, d))
    k = np.broadcast_to((100.0 * sign * u)[None, :, None, :], (1, t, h, d))
    v = rng.normal(size=(1, t, h, d))
    return np.stack([q, k, v], axis=2).astype(np.float32)


def attention_phase() -> tuple[dict, dict]:
    """Kernel 1 (packed qkv) and kernel 2 (separate q, k, v; the same CUDA
    kernels) against their plain versions; returns both kernels' entries."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.ops import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain version in IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def qkv_of(shape, dtype, seed):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)

    def compare(name, qkv, scale, tol, packed=True):
        if packed:
            got = attn.head_resident_attention_packed(qkv, scale=scale)
            want = attn.head_resident_attention_packed_plain(qkv, scale=scale)
        else:  # unpacked entry: three separate contiguous tensors
            q, k, v = (x.contiguous() for x in qkv.unbind(dim=2))
            got = attn.head_resident_attention(q, k, v, scale=scale)
            want = attn.head_resident_attention_plain(q, k, v, scale=scale)
        torch.cuda.synchronize()
        check(got.dtype == qkv.dtype and got.shape == want.shape, f"{name}: dtype/shape")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        variant = attn.kernel_variant(qkv.dtype, qkv.shape[-1])
        print(f"attention {name} [{variant}]: max_abs_err={err:.3e} (tol {tol:g})")
        check(err <= tol, f"{name}: max_abs_err {err} > {tol}")
        return err

    b, t, h, d = (VIT_B448[k] for k in ("batch", "tokens", "heads", "head_dim"))
    scale = d**-0.5
    main = qkv_of((b, t, 3, h, d), torch.bfloat16, 0)
    err_main = compare("vit-b448 bf16 B=32", main, scale, 3e-2)
    # f32: 5e-5, the online softmax sums in another order than the plain one
    compare("vit-b448 f32 B=2", qkv_of((2, t, 3, h, d), torch.float32, 1), scale, 5e-5)
    compare("ragged T=50 f32 D=64", qkv_of((2, 50, 3, 4, 64), torch.float32, 2), 0.125, 5e-5)
    compare("ragged T=37 f32 D=32 unpacked", qkv_of((1, 37, 3, 2, 32), torch.float32, 3),
            0.25, 5e-5, packed=False)
    compare("ragged T=50 bf16 D=32", qkv_of((1, 50, 3, 3, 32), torch.bfloat16, 4), 32**-0.5, 3e-2)
    ext = torch.from_numpy(_extreme_qkv(64, 2, 32, seed=3)).to(dev)
    compare("logits +-1e4 f32", ext, 1.0, 5e-5)
    compare("logits +-1e4 bf16", ext.to(torch.bfloat16), 1.0, 5e-2)
    # the tensor-core kernel's tiling: lengths around its 64-key tiles and
    # its 128-row q tiles (a second warpgroup with and without rows); B * H = 15
    check(attn.kernel_variant(torch.bfloat16, 64) == "wgmma" and
          attn.kernel_variant(torch.float32, 64) == "fma", "attention kernel variants")
    for t_len in (1, 17, 63, 64, 65, 127, 128, 129, 768, 785, 832):
        compare(f"bf16 T={t_len} D=64", qkv_of((3, t_len, 3, 5, 64), torch.bfloat16, 100 + t_len),
                0.125, 3e-2)
    for t_len in (17, 129, 785):  # D = 32: 64-byte swizzle, a scale that is no power of two
        compare(f"bf16 T={t_len} D=32", qkv_of((3, t_len, 3, 5, 32), torch.bfloat16, 200 + t_len),
                32**-0.5, 3e-2)
    # a strided slice of a larger projection: batch stride != T * 3 * H * D
    big = qkv_of((4, 200, 3, 5, 64), torch.bfloat16, 300)
    compare("bf16 strided slice T=129", big[1:, 2:131], 0.125, 3e-2)
    compare("bf16 unpacked T=129 D=32", qkv_of((2, 129, 3, 3, 32), torch.bfloat16, 301),
            32**-0.5, 3e-2, packed=False)
    ext129 = torch.from_numpy(_extreme_qkv(129, 3, 64, seed=4)).to(dev, torch.bfloat16)
    compare("logits +-1e4 bf16 T=129 D=64", ext129, 1.0, 5e-2)
    const = qkv_of((1, 37, 3, 2, 64), torch.float32, 5)
    const[:, :, 2] = 3.25
    got = attn.head_resident_attention_packed(const, scale=0.25)
    torch.cuda.synchronize()
    rel = float(((got - 3.25).abs() / 3.25).max())
    print(f"attention constant v: max_rel_err={rel:.3e} (rtol 1e-05)")
    check(rel <= 1e-5, f"constant v: rel err {rel}")

    # timing at the main path's shape
    ms = cuda_ms(lambda: attn.head_resident_attention_packed(main, scale=scale), iters=20)
    plain_ms = cuda_ms(lambda: attn.head_resident_attention_packed_plain(main, scale=scale), iters=5)
    q, k, v = (x.transpose(1, 2) for x in main.unbind(dim=2))  # (B, H, T, D) views
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale), iters=20
    )
    flops = 4.0 * t * t * d * b * h
    bytes_moved = (main.numel() + b * t * h * d) * main.element_size()
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(
        f"attention vit-b448 bf16 B=32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
        f"({flops / 1e9:.1f} GFLOP, {bytes_moved / 1e6:.1f} MB), "
        f"kernel rate {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s"
    )
    # kernel 2: the same kernels through the entry with separate q, k, v
    err_sep = compare("vit-b448 bf16 B=32 unpacked", main, scale, 3e-2, packed=False)
    qs, ks, vs = (x.contiguous() for x in main.unbind(dim=2))
    sep_ms = cuda_ms(lambda: attn.head_resident_attention(qs, ks, vs, scale=scale), iters=20)
    sep_plain_ms = cuda_ms(lambda: attn.head_resident_attention_plain(qs, ks, vs, scale=scale), iters=5)
    print(f"attention vit-b448 bf16 B=32 unpacked q, k, v: kernel {sep_ms:.4f} ms, plain {sep_plain_ms:.4f} ms")
    separate = {
        "name": "head_resident_attention (separate q, k, v)",
        "route": "cuda",
        "source": "kobato_eyes_tpu_torch/csrc/head_resident_attention.cu",
        "replaces": "kobato_eyes_tpu/ops/pallas_attention.py:78",
        "launches": None,  # filled from the main paths' runs
        "max_abs_err": err_sep,
        "ms": sep_ms,
        "plain_ms": sep_plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }
    packed = {
        "name": "head_resident_attention",
        "route": "cuda",
        "source": "kobato_eyes_tpu_torch/csrc/head_resident_attention.cu",
        "replaces": "kobato_eyes_tpu/ops/pallas_attention.py:104",
        "launches": None,  # filled from the main path's run
        "max_abs_err": err_main,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }
    return packed, separate


def _window_inputs(batch, nw, n, heads, hd, dtype, seed, masked):
    """Seeded window-attention inputs on the card: qkv N(0, 1), the JAX
    tests' scale range exp(U(1, 2)), a CPB-like bias 16*sigmoid(N(0, 1)),
    and (masked) SwinV2's real shift mask for a square grid of nw windows."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.models.swin import _shift_attn_mask

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    qkv = torch.from_numpy(rng.normal(size=(batch, nw, n, 3, heads, hd)).astype(np.float32)).to(dev, dtype)
    scale = torch.from_numpy(np.exp(rng.uniform(1.0, 2.0, heads)).astype(np.float32)).to(dev)
    bias = torch.from_numpy((16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n))))).astype(np.float32)).to(dev)
    mask = None
    if masked:
        w = int(round(n**0.5))
        grid = int(round(nw**0.5)) * w
        mask = torch.from_numpy(_shift_attn_mask(grid, w, w // 2)).to(dev)
    return qkv, scale, bias, mask


def window_attention_phase() -> dict:
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.ops import window_attention as wa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def compare(name, qkv, scale, bias, mask, tol, qk_precision="default", variant=None):
        got = wa.windowed_cosine_attention_packed(qkv, scale, bias, mask, qk_precision=qk_precision)
        want = wa.windowed_cosine_attention_packed_plain(qkv, scale, bias, mask, qk_precision=qk_precision)
        torch.cuda.synchronize()
        check(got.dtype == qkv.dtype and got.shape == want.shape, f"window {name}: dtype/shape")
        check(bool(torch.isfinite(got).all()), f"window {name}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        ran = wa.kernel_variant(qkv.dtype, qkv.shape[2], qkv.shape[-1], aligned=wa.aligned_for_mma(qkv))
        print(f"window attention {name} [{ran}]: max_abs_err={err:.3e} (tol {tol:g})")
        check(variant is None or ran == variant, f"window {name}: ran {ran}, expected {variant}")
        check(err <= tol, f"window {name}: max_abs_err {err} > {tol}")
        return err

    b, n, hd = BATCH, SWIN_WINDOW**2, 32
    errs = []
    main = {}
    for stage, (nw, h) in enumerate(SWIN_B448_STAGES):
        for masked in (False, True):
            ins = _window_inputs(b, nw, n, h, hd, torch.bfloat16, 10 + stage, masked)
            # bf16 output: one bf16 rounding of |out| <= ~4 is 2^-6
            errs.append(compare(f"swinv2-b448 stage {stage} bf16 {'masked' if masked else 'unmasked'}",
                                *ins, 3e-2, variant="mma"))
            if masked:
                main[stage] = ins
    # f32: 5e-5, the JAX package's kernel tolerance (sums in another order)
    compare("f32 stage 1 masked B=4", *_window_inputs(4, 64, n, 8, hd, torch.float32, 20, True), 5e-5,
            variant="rows")
    compare("n=196 f32 masked", *_window_inputs(2, 4, 196, 2, 32, torch.float32, 21, True), 5e-5,
            variant="rows")
    compare("n=196 hd=16 bf16", *_window_inputs(2, 4, 196, 3, 16, torch.bfloat16, 22, False), 3e-2,
            variant="rows")
    compare("qk_precision=bf16 f32", *_window_inputs(2, 16, n, 4, hd, torch.float32, 23, True), 5e-5,
            qk_precision="bf16", variant="rows")
    compare("qk_precision=bf16 bf16", *_window_inputs(2, 16, n, 4, hd, torch.bfloat16, 24, True), 3e-2,
            qk_precision="bf16", variant="mma")
    # the tensor-core kernel off the main path's shape: window 8, other head
    # widths, a head count that leaves a warp without a head, fewer windows
    # than blocks, a strided slice of a larger projection
    compare("n=64 hd=16 bf16 H=6", *_window_inputs(2, 4, 64, 6, 16, torch.bfloat16, 25, True), 3e-2,
            variant="mma")
    compare("n=64 hd=32 bf16 H=3", *_window_inputs(3, 4, 64, 3, 32, torch.bfloat16, 26, True), 3e-2,
            variant="mma")
    compare("n=49 hd=64 bf16", *_window_inputs(2, 16, n, 4, 64, torch.bfloat16, 27, True), 3e-2,
            variant="mma")
    compare("n=64 hd=64 bf16", *_window_inputs(2, 4, 64, 2, 64, torch.bfloat16, 28, False), 3e-2,
            variant="rows")
    compare("n=16 hd=32 bf16 B=1 nW=1", *_window_inputs(1, 1, 16, 4, hd, torch.bfloat16, 29, False), 3e-2,
            variant="mma")
    qkv, scale, bias, mask = _window_inputs(3, 16, n, 8, hd, torch.bfloat16, 30, True)
    big = torch.zeros((4, 16, n + 3, 3, 8, hd), dtype=torch.bfloat16, device=dev)
    big[1:, :, 2:n + 2] = qkv
    compare("bf16 strided slice", big[1:, :, 2:n + 2], scale, bias, mask, 3e-2, variant="mma")
    # production bounds: clamped scale 100, CPB bias at its 16 ceiling, one
    # window masked off the diagonal: rows survive on the diagonal only
    qkv, _, _, _ = _window_inputs(1, 4, 196, 2, 32, torch.float32, 2, False)
    scale = torch.full((2,), 100.0, device=dev)
    bias = torch.full((2, 196, 196), 16.0, device=dev)
    mask_np = np.zeros((4, 196, 196), np.float32)
    mask_np[0] = -100.0
    for i in range(196):
        mask_np[0, i, i] = 0.0
    compare("production bounds f32", qkv, scale, bias, torch.from_numpy(mask_np).to(dev), 5e-4,
            variant="rows")
    qkv, _, _, _ = _window_inputs(2, 4, n, 4, hd, torch.bfloat16, 3, False)
    compare("production bounds bf16 n=49", qkv, torch.full((4,), 100.0, device=dev),
            torch.full((4, n, n), 16.0, device=dev),
            torch.from_numpy(np.ascontiguousarray(mask_np[:, :n, :n])).to(dev), 3e-2, variant="mma")

    # Times. Stages 2 and 3 run shorter than the host takes to enqueue a
    # call, so every kernel time is taken through a CUDA graph: 24 calls
    # rotating over copies of qkv that together exceed the 50 MB L2 ("cold",
    # as the byte bound assumes). The eager reading (host included) is
    # printed beside it.
    rows = []
    for stage, (nw, h) in enumerate(SWIN_B448_STAGES):
        qkv, scale, bias, mask = main[stage]
        call_bytes = qkv.numel() * qkv.element_size() * 4 // 3  # qkv read, out written
        copies = min(24, -(-400_000_000 // call_bytes))
        sets = [qkv] + [qkv.clone() for _ in range(copies - 1)]
        ms = cuda_graph_ms([lambda x=sets[i % copies]: wa.windowed_cosine_attention_packed(x, scale, bias, mask)
                            for i in range(24)])
        unmasked_ms = cuda_graph_ms([lambda x=sets[i % copies]: wa.windowed_cosine_attention_packed(x, scale, bias, None)
                                     for i in range(24)])
        del sets
        eager_ms = cuda_ms(lambda: wa.windowed_cosine_attention_packed(qkv, scale, bias, mask), iters=20)
        plain_ms = cuda_ms(lambda: wa.windowed_cosine_attention_packed_plain(qkv, scale, bias, mask), iters=5)
        # yardstick: SDPA on pre-normalised, per-head-scaled q and k laid out
        # (B, nW*H, n, hd) with attn_mask = bias + mask; the normalisation
        # and the relayout are done beforehand and only the SDPA call is timed
        q, k, v = qkv.unbind(dim=3)
        qn = torch.nn.functional.normalize(q.float(), dim=-1) * scale[:, None]
        kn = torch.nn.functional.normalize(k.float(), dim=-1)

        def heads_major(x):
            return x.to(torch.bfloat16).permute(0, 1, 3, 2, 4).reshape(b, nw * h, n, hd).contiguous()

        qs, ks, vs = heads_major(qn), heads_major(kn), heads_major(v)
        attn_mask = (bias[None] + mask[:, None]).reshape(1, nw * h, n, n).to(torch.bfloat16)
        library_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn_mask, scale=1.0),
            iters=20,
        )
        del q, k, v, qn, kn, qs, ks, vs, attn_mask
        flops = 4.0 * n * n * hd * b * nw * h
        bytes_moved = (qkv.numel() + b * nw * n * h * hd) * qkv.element_size() + (bias.numel() + mask.numel()) * 4
        # under "default" the q k^T half of the operations has f32 operands
        # (the FMA units' rate), the P V half bf16 ones (the tensor cores')
        t_ops = (flops / 2 / F32_FLOPS_PER_S + flops / 2 / BF16_FLOPS_PER_S) * 1e3
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        print(
            f"window attention swinv2-b448 stage {stage} bf16 B={b} nW={nw} H={h}: kernel {ms:.4f} ms "
            f"through a CUDA graph, cold over {copies} input set(s) ({unmasked_ms:.4f} ms without a mask; "
            f"{ms / max(t_ops, t_bytes):.2f}x the bound; enqueued call by call {eager_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, sdpa call alone {library_ms:.4f} ms, "
            f"bound {max(t_ops, t_bytes):.4f} ms (bytes {t_bytes:.4f}: {bytes_moved / 1e6:.1f} MB; operations "
            f"{t_ops:.4f}: {flops / 1e9:.2f} GFLOP, half of them on f32 operands at {F32_FLOPS_PER_S / 1e12:.0f} "
            f"TFLOP/s; {'bytes' if t_bytes >= t_ops else 'operations'} bound), "
            f"kernel moves {bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s"
        )
        rows.append((stage, ms, plain_ms, library_ms, t_ops, t_bytes))
    _, ms, plain_ms, library_ms, t_ops, t_bytes = rows[0]  # stage 0 is the reported shape
    return {
        "name": "window_cosine_attention",
        "route": "cuda",
        "source": "kobato_eyes_tpu_torch/csrc/window_cosine_attention.cu",
        "replaces": "kobato_eyes_tpu/ops/pallas_window_attention.py:110",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": library_ms,
    }


def layernorm_residual_phase() -> dict:
    """Kernel 4 at all four SwinV2-B/448 stage shapes (bf16 and f32) through
    the ``"vec8"`` kernel, the ``"scalar"`` kernel on what ``"vec8"`` does not
    take (C = 100, a view 8 bytes off a 16-byte boundary) and forced on the
    stage shapes; then each stage shape timed: both kernels, the plain
    version, ``x + F.layer_norm`` and the byte bound."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.ops import layernorm_residual as lnr

    dev = torch.device("cuda")

    def inputs(rows, c, dtype, seed):
        rng = np.random.default_rng(seed)

        def t(a, dt):
            return torch.from_numpy(a.astype(np.float32)).to(dev, dt)

        return (t(rng.normal(size=(rows, c)) * 3, dtype), t(rng.normal(size=(rows, c)), dtype),
                t(rng.uniform(0.5, 2.0, c), torch.float32), t(rng.normal(size=c), torch.float32))

    def compare(name, x, res, gamma, beta, expect, variant=None):
        ran = variant or lnr.kernel_variant(x.shape[-1], aligned=lnr.aligned_for_vec(x, res, gamma, beta))
        check(ran == expect, f"ln {name}: runs {ran}, expected {expect}")
        got = lnr.layernorm_residual(x, res, gamma, beta, variant=variant)
        want = lnr.layernorm_residual_plain(x, res, gamma, beta)
        torch.cuda.synchronize()
        check(got.dtype == x.dtype and got.shape == x.shape, f"ln {name}: dtype/shape")
        check(bool(torch.isfinite(got).all()), f"ln {name}: non-finite output")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if x.dtype == torch.bfloat16:
            # sums in another order may move the one final rounding by one
            # bf16 step: 2^-7 of the value's magnitude
            ok = bool((diff <= 2.0**-7 * want.float().abs() + 1e-6).all())
            tol = "one bf16 rounding"
        else:
            ok = err <= 2e-4  # the JAX package's tolerance
            tol = "2e-4"
        print(f"layernorm_residual {name} [{ran}]: max_abs_err={err:.3e} (tol {tol})")
        check(ok, f"ln {name}: max_abs_err {err} over {tol}")
        return err

    errs = []
    main = []
    for stage, (nw, _) in enumerate(SWIN_B448_STAGES):
        rows, c = BATCH * nw * SWIN_WINDOW**2, 128 << stage
        for dtype in (torch.bfloat16, torch.float32):
            ins = inputs(rows, c, dtype, seed=c)
            name = f"stage {stage} ({rows}, {c}) {str(dtype).split('.')[-1]}"
            err = compare(name, *ins, expect="vec8")
            compare(name, *ins, expect="scalar", variant="scalar")
            if dtype == torch.bfloat16:
                errs.append(err)
                main.append(ins)
    # what "vec8" does not take, by shape: C not a multiple of 8, C = 8 * odd
    # (taken, a ragged last lane), rows that leave a ragged last warp, and a
    # contiguous view that starts 8 bytes off a 16-byte boundary
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        compare(f"(4096, 100) {dt}", *inputs(4096, 100, dtype, 3), expect="scalar")
        compare(f"(4099, 104) {dt}", *inputs(4099, 104, dtype, 4), expect="vec8")
        compare(f"(37, 128) {dt}", *inputs(37, 128, dtype, 5), expect="vec8")
        compare(f"(301, 640) {dt}", *inputs(301, 640, dtype, 6), expect="vec8")
        compare(f"(5, 8) {dt}", *inputs(5, 8, dtype, 7), expect="vec8")
        x, res, gamma, beta = inputs(1025, 256, dtype, 8)
        off = 8 // x.element_size()
        x_off = torch.cat([x.new_zeros(off), x.reshape(-1)])[off:].view(1025, 256)
        check(x_off.data_ptr() % 16 == 8 and x_off.is_contiguous(), "misaligned view")
        compare(f"(1025, 256) {dt} misaligned view", x_off, res, gamma, beta, expect="scalar")
    try:
        lnr.layernorm_residual(*inputs(8, 100, torch.float32, 9), variant="vec8")
    except ValueError:
        pass
    else:
        raise SmokeFailure("ln: variant='vec8' on C = 100 did not raise")

    # Times. A call's device time is 11 to 110 microseconds, less than the
    # host takes to enqueue it, so the calls are captured into a CUDA graph.
    # "cold": 24 calls walk over copies of x and the shortcut that together
    # exceed the 50 MB L2 several times, as the byte bound assumes; "warm":
    # the same tensors every call (stages 2 and 3 then fit in the L2).
    rows_out = []
    for stage, (x, res, gamma, beta) in enumerate(main):
        c = x.shape[-1]
        bytes_moved = 3 * x.numel() * x.element_size() + 2 * gamma.numel() * 4
        copies = min(24, -(-400_000_000 // bytes_moved))
        sets = [(x, res)] + [(x.clone(), res.clone()) for _ in range(copies - 1)]
        g16, b16 = gamma.to(x.dtype), beta.to(x.dtype)

        def calls(fn, n=24):
            return [lambda a=a, r=r: fn(a, r) for a, r in (sets[i % len(sets)] for i in range(n))]

        def vec8(a, r):
            return lnr.layernorm_residual(a, r, gamma, beta)

        def scalar(a, r):
            return lnr.layernorm_residual(a, r, gamma, beta, variant="scalar")

        def library(a, r):  # yardstick: two calls, F.layer_norm then the residual add
            return r + torch.nn.functional.layer_norm(a, (c,), g16, b16, 1e-5)

        ms = cuda_graph_ms(calls(vec8))
        scalar_ms = cuda_graph_ms(calls(scalar))
        library_ms = cuda_graph_ms(calls(library))
        ms2 = cuda_graph_ms(calls(vec8))
        warm = [cuda_graph_ms([lambda: fn(x, res)] * 24) for fn in (vec8, scalar, library)]
        eager = [cuda_ms(lambda: fn(x, res), iters=50, warmup=5) for fn in (vec8, scalar, library)]
        plain_ms = cuda_ms(lambda: lnr.layernorm_residual_plain(x, res, gamma, beta), iters=5)
        del sets
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = 8.0 * x.numel() / F32_FLOPS_PER_S * 1e3  # f32 arithmetic outside the tensor cores
        bound = max(t_ops, t_bytes)
        print(
            f"layernorm_residual stage {stage} ({x.shape[0]}, {c}) bf16, cold over {copies} input sets: "
            f"kernel [vec8] {ms:.4f} ms (again {ms2:.4f}; {ms / bound:.2f}x the bound, "
            f"{bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s), [scalar] {scalar_ms:.4f} ms, "
            f"layer_norm + add (two calls) {library_ms:.4f} ms; bound {bound:.4f} ms "
            f"({bytes_moved / 1e6:.1f} MB, {'bytes' if t_bytes >= t_ops else 'operations'}); "
            f"warm (one input set) vec8 / scalar / layer_norm + add {warm[0]:.4f} / {warm[1]:.4f} / {warm[2]:.4f} ms; "
            f"enqueued call by call (host included) {eager[0]:.4f} / {eager[1]:.4f} / {eager[2]:.4f} ms; "
            f"plain {plain_ms:.4f} ms; {2 * SWIN_B448_DEPTHS[stage]} launches a residual-LN forward"
        )
        rows_out.append((ms, plain_ms, library_ms, t_ops, t_bytes))
    ms, plain_ms, library_ms, t_ops, t_bytes = rows_out[0]  # stage 0 is the reported shape
    return {
        "name": "layernorm_residual",
        "route": "cuda",
        "source": "kobato_eyes_tpu_torch/csrc/layernorm_residual.cu",
        "replaces": "kobato_eyes_tpu/ops/pallas_layernorm_residual.py:76",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": library_ms,
    }


def pairwise_hamming_phase() -> dict:
    """Kernel 5 against its plain version, exact, at the audit's batch
    (4096 x 4096), a stripe (4096 x 6000), ragged shapes and known values;
    then its time at 4096 x 4096 beside the plain version, the byte bound and
    the copy of the result to the host (what the audit does with it)."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.ops import pairwise_hamming as pw

    dev = torch.device(DEVICE)

    def hashes(n, seed):
        return pw.hashes_to_tensor(np.random.default_rng(seed).integers(0, 1 << 64, size=n, dtype=np.uint64), dev)

    def compare(name, a, b):
        got = pw.pairwise_hamming_tensor(a, b)
        want = pw.pairwise_hamming_plain(a, b)
        synchronize()
        check(got.dtype == torch.int32 and got.shape == want.shape, f"pairwise {name}: dtype/shape")
        err = int((got - want).abs().max()) if got.numel() else 0
        print(f"pairwise_hamming {name}: max_abs_err={err} (exact)")
        check(err == 0, f"pairwise {name}: max_abs_err {err} != 0")
        errs.append(err)
        return got

    errs = []

    a = hashes(AUDIT_BATCH, 30)
    compare(f"{AUDIT_BATCH}x{AUDIT_BATCH}", a, a)
    compare(f"{AUDIT_BATCH}x6000 stripe", a, hashes(6000, 31))
    compare("300x300", hashes(300, 32), hashes(300, 32))
    compare("70x513", hashes(70, 33), hashes(513, 34))
    known = pw.hashes_to_tensor(np.array([0, 0xFFFFFFFFFFFFFFFF, 1], np.uint64), dev)
    got = compare("known values", known, known).cpu()
    check((int(got[0, 1]), int(got[0, 2]), int(got[1, 2])) == (64, 1, 63), "pairwise known values")

    # the kernel runs ~0.02-0.03 ms, under the host's enqueue time: timed
    # through a CUDA graph over rotating input sets (the output alone, 67 MB,
    # exceeds the 50 MB L2); the eager reading is printed beside it
    sets = [hashes(AUDIT_BATCH, 40 + i) for i in range(4)]
    ms = cuda_graph_ms([lambda x=sets[i % 4]: pw.pairwise_hamming_tensor(x, x) for i in range(24)])
    eager_ms = cuda_ms(lambda: pw.pairwise_hamming_tensor(a, a), iters=50)
    plain_ms = cuda_ms(lambda: pw.pairwise_hamming_plain(a, a), iters=5)
    out = pw.pairwise_hamming_tensor(a, a)
    synchronize()
    d2h = []
    for _ in range(5):
        t0 = time.perf_counter()
        out.cpu()
        d2h.append((time.perf_counter() - t0) * 1e3)
    n = AUDIT_BATCH
    bytes_moved = n * n * 4 + 2 * n * 8
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    # xor, popcount and store: a few integer operations a distance on the
    # CUDA cores, counted at the non-tensor f32 rate
    t_ops = 4.0 * n * n / F32_FLOPS_PER_S * 1e3
    print(
        f"pairwise_hamming {n}x{n}: kernel {ms:.4f} ms through a CUDA graph "
        f"({ms / max(t_ops, t_bytes):.2f}x the bound; enqueued call by call {eager_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms ({bytes_moved / 1e6:.1f} MB, bytes), "
        f"result copy to host {min(d2h):.3f} ms (min of 5; all {', '.join(f'{x:.3f}' for x in d2h)})"
    )
    return {
        "name": "pairwise_hamming",
        "route": "cuda",
        "source": "kobato_eyes_tpu_torch/csrc/pairwise_hamming.cu",
        "replaces": "kobato_eyes_tpu/ops/pallas_hamming.py:56",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": None,  # torch has no popcount: no single call computes this
    }


# ---------------------------------------------------------------------------
# Dup path: the banded scan, the cluster engine and the cohesion audit
# ---------------------------------------------------------------------------


def synth_hashes(n: int, seed: int) -> "np.ndarray":
    """Synthetic pHash population with planted near-duplicate clusters: 30%
    of the hashes copy a random original and flip 0..6 random bits (the
    repository's dup benchmark population, ``bench.py:synth_hashes``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_dups = int(n * 0.3)
    n_orig = n - n_dups
    originals = rng.integers(0, 1 << 64, size=n_orig, dtype=np.uint64)
    src = rng.integers(0, n_orig, size=n_dups)
    dups = originals[src].copy()
    for i in range(n_dups):
        k = int(rng.integers(0, 7))
        for bit in rng.integers(0, 64, size=k):
            dups[i] ^= np.uint64(1) << np.uint64(bit)
    out = np.concatenate([originals, dups])
    rng.shuffle(out)
    return out


def _dup_timers() -> str:
    from kobato_eyes_tpu_torch.utils.metrics import metrics

    timers = metrics.snapshot()["timers"]
    return " ".join(f"{k}={v['total'] * 1e3:.1f}ms" for k, v in sorted(timers.items())
                    if k.startswith("dup."))


def _audit_batches(clusters, batch: int) -> list[tuple[int, int]]:
    """The (rows, columns) of each kernel launch ``audit_clusters`` makes:
    whole clusters packed into batches of at most ``batch`` members, one
    launch each; a larger cluster takes one launch per ``batch``-row stripe."""
    shapes, total = [], 0
    for cl in clusters:
        m = len(cl.files)
        if m > batch:
            if total:
                shapes.append((total, total))
            shapes += [(min(batch, m - s), m) for s in range(0, m, batch)]
            total = 0
            continue
        if total + m > batch:
            shapes.append((total, total))
            total = 0
        total += m
    return shapes + ([(total, total)] if total else [])


def dup_scan_phase() -> int:
    """The 70k population through the engine on both routes, the sweep, the
    CPU oracle on a subset, a 1M population through the resident scan, and
    the cohesion audit over the 70k clusters. Returns the audit's launches
    of kernel 5."""
    from pathlib import Path as _P

    import numpy as np

    from kobato_eyes_tpu_torch.dup import audit
    from kobato_eyes_tpu_torch.dup.cpu_ref import CpuDuplicateScanner
    from kobato_eyes_tpu_torch.dup.engine import TpuDuplicateScanner, cluster_ids
    from kobato_eyes_tpu_torch.dup.types import DuplicateFileMeta, DuplicateScanConfig
    from kobato_eyes_tpu_torch.native import build as native_build
    from kobato_eyes_tpu_torch.ops import hamming, pairwise_hamming
    from kobato_eyes_tpu_torch.utils.metrics import metrics

    t0 = time.perf_counter()
    hashes = synth_hashes(N_DUP, DUP_SEED)
    sizes = np.random.default_rng(DUP_SEED + 1).integers(10_000, 5_000_000, size=N_DUP)
    files = [
        DuplicateFileMeta(file_id=i, path=_P(f"/bench/img_{i:07d}.png"), size=int(sizes[i]),
                          width=None, height=None, phash=int(hashes[i]))
        for i in range(N_DUP)
    ]
    config = DuplicateScanConfig(hamming_threshold=8)
    print(f"dup population: {N_DUP} hashes in {time.perf_counter() - t0:.1f} s")

    runs = {}
    for route, host_scan_max in (("host", None), ("device", 0)):
        scanner = TpuDuplicateScanner(config, device=DEVICE, host_scan_max=host_scan_max)
        for attempt in ("first", "warm"):
            metrics.reset()
            t0 = time.perf_counter()
            clusters = scanner.build_clusters(files)
            synchronize()
            wall = time.perf_counter() - t0
            print(f"dup scan {N_DUP} {route} route ({attempt}): {len(clusters)} clusters, "
                  f"{sum(len(c.files) for c in clusters)} members, wall {wall * 1e3:.1f} ms, "
                  f"window {scanner._scanner.last_window}; {_dup_timers()}")
        runs[route] = (scanner, clusters)
    check(not hamming._NATIVE_SCAN_UNAVAILABLE, "the native band scan did not load (numpy fallback)")
    check({"module:hamming_scan", "module:assembly"} <= set(native_build._CACHE),
          f"native modules loaded: {sorted(native_build._CACHE)}")
    host_ids = cluster_ids(runs["host"][1])
    check(len(host_ids) > 1000, f"only {len(host_ids)} clusters at 70k")
    check(cluster_ids(runs["device"][1]) == host_ids, "device-route clusters != host-route clusters")
    check(0 < runs["device"][0]._scanner.last_window <= 32, "70k device scan window outside 1..32")

    metrics.reset()
    t0 = time.perf_counter()
    sweep = runs["device"][0].build_clusters_sweep(files, range(0, 9))
    print(f"dup sweep 0..8 device route: {time.perf_counter() - t0:.3f} s; {_dup_timers()}")
    host_sweep = runs["host"][0].build_clusters_sweep(files, range(0, 9))
    for t in range(9):
        check(cluster_ids(sweep[t]) == cluster_ids(host_sweep[t]), f"sweep threshold {t}: device != host")
    print("dup sweep: clusters per threshold " + ", ".join(f"{t}:{len(sweep[t])}" for t in range(9)))

    subset = files[:5000]
    want = cluster_ids(CpuDuplicateScanner(config).build_clusters(subset))
    got = cluster_ids(TpuDuplicateScanner(config, device=DEVICE, host_scan_max=0).build_clusters(subset))
    check(got == want and len(want) > 0, "5000-hash subset: device route != CpuDuplicateScanner")
    print(f"dup oracle: 5000-hash subset, {len(want)} clusters equal to CpuDuplicateScanner")

    # 1M hashes: above the default crossover, so the resident device scan
    big = synth_hashes(N_DUP_BIG, DUP_SEED + 2)
    scanner = hamming.BandedHammingScanner(device=DEVICE)
    check(scanner.host_scan_max < N_DUP_BIG, "1M population would route to the host")
    for attempt in ("first", "warm"):
        metrics.reset()
        t0 = time.perf_counter()
        ei, ej, ed = scanner.scan(big, hamming_threshold=8)
        wall = time.perf_counter() - t0
        print(f"dup scan {N_DUP_BIG} device route ({attempt}): {len(ei)} edges, "
              f"window {scanner.last_window} (max run {scanner._max_run}), wall {wall * 1e3:.1f} ms; "
              f"{_dup_timers()}")
    check(scanner.last_window > 32, f"1M window {scanner.last_window} <= 32: the multi-word scan did not run")
    t0 = time.perf_counter()
    hi, hj, hd = hamming.host_window_scan(big, band_bits=16, band_count=4, hamming_threshold=8)
    print(f"dup host scan {N_DUP_BIG}: {len(hi)} edges in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    order_d = np.lexsort((ej, ei))
    order_h = np.lexsort((hj, hi))
    check(len(ei) == len(hi) and np.array_equal(ei[order_d], hi[order_h])
          and np.array_equal(ej[order_d], hj[order_h]) and np.array_equal(ed[order_d], hd[order_h]),
          "1M device-scan edges != host_window_scan edges")

    clusters = runs["host"][1]
    shapes = _audit_batches(clusters, AUDIT_BATCH)
    expected = len(shapes)
    pairwise_hamming.launches = 0
    t0 = time.perf_counter()
    stats = audit.audit_clusters(clusters, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = pairwise_hamming.launches
    t0 = time.perf_counter()
    want = audit.audit_clusters_np(clusters)
    np_wall = time.perf_counter() - t0
    as_tuples = lambda ss: [(s.keeper_id, s.size, s.diameter, s.mean_distance, s.keeper_max) for s in ss]  # noqa: E731
    check(as_tuples(stats) == as_tuples(want), "audit stats != audit_clusters_np")
    check(launches == expected, f"audit launches {launches} != {expected} batches")

    # where the audit's time goes: the same audit again with each batch's
    # kernel (synchronised) and its copy to the host timed apart
    real = audit.pairwise_hamming
    split = {"kernel": 0.0, "copy": 0.0}

    def timed(a_u64, b_u64=None, *, device=None):
        ta = pairwise_hamming.hashes_to_tensor(a_u64, DEVICE)
        tb = ta if b_u64 is None else pairwise_hamming.hashes_to_tensor(b_u64, DEVICE)
        synchronize()
        t0 = time.perf_counter()
        out = pairwise_hamming.pairwise_hamming_tensor(ta, tb)
        synchronize()
        t1 = time.perf_counter()
        host = out.cpu().numpy()
        split["kernel"] += t1 - t0
        split["copy"] += time.perf_counter() - t1
        return host

    audit.pairwise_hamming = timed
    try:
        t0 = time.perf_counter()
        audit.audit_clusters(clusters, device=DEVICE)
        wall2 = time.perf_counter() - t0
    finally:
        audit.pairwise_hamming = real
    print(f"audit {len(clusters)} clusters ({sum(len(c.files) for c in clusters)} members): "
          f"{launches} launches, wall {wall * 1e3:.1f} ms (numpy spec {np_wall * 1e3:.1f} ms); "
          f"timed apart: wall {wall2 * 1e3:.1f} ms, kernel launch+run {split['kernel'] * 1e3:.1f} ms, "
          f"copy to host {split['copy'] * 1e3:.1f} ms, rest (packing, numpy reductions) "
          f"{(wall2 - split['kernel'] - split['copy']) * 1e3:.1f} ms; diameter max "
          f"{max(s.diameter for s in stats)}")

    # the kernel at the shapes the audit launched it with, on seeded hashes,
    # each timed through a CUDA graph (the eager reading beside it)
    rng = np.random.default_rng(DUP_SEED + 3)
    times, eager, bounds = [], [], []
    for rows, cols in shapes:
        ta = pairwise_hamming.hashes_to_tensor(rng.integers(0, 1 << 64, size=rows, dtype=np.uint64), DEVICE)
        tb = pairwise_hamming.hashes_to_tensor(rng.integers(0, 1 << 64, size=cols, dtype=np.uint64), DEVICE)
        times.append(cuda_graph_ms([lambda: pairwise_hamming.pairwise_hamming_tensor(ta, tb)] * 12))
        eager.append(cuda_ms(lambda: pairwise_hamming.pairwise_hamming_tensor(ta, tb), iters=20))
        bounds.append((rows * cols * 4 + (rows + cols) * 8) / HBM_BYTES_PER_S * 1e3)
    print(f"pairwise_hamming at the audit's {len(shapes)} launch shapes, through a CUDA graph: kernel "
          f"{sum(times):.4f} ms in all against a byte bound of {sum(bounds):.4f} ms "
          f"({sum(times) / sum(bounds):.2f}x; enqueued call by call {sum(eager):.4f} ms); "
          + ", ".join(f"{r}x{c} {t:.4f} ms" for (r, c), t in zip(shapes, times)))
    return launches


def write_dup_library(root: Path) -> dict[str, str]:
    """48 seeded images, a JPEG q=85 re-encode of 16 of them and a 0.9x
    resize of 8; returns {derivative name: base name}."""
    import numpy as np
    from PIL import Image

    write_library(root, DUP_LIB_IMAGES, seed=7)
    bases = sorted(root.iterdir())
    derived = {}
    rng = np.random.default_rng(8)
    for i in rng.choice(len(bases), size=16, replace=False):
        p = bases[int(i)]
        Image.open(p).convert("RGB").save(root / f"{p.stem}_q85.jpg", quality=85)
        derived[f"{p.stem}_q85.jpg"] = p.name
    for i in rng.choice(len(bases), size=8, replace=False):
        p = bases[int(i)]
        img = Image.open(p).convert("RGB")
        img.resize((int(img.width * 0.9), int(img.height * 0.9)), Image.Resampling.LANCZOS).save(
            root / f"{p.stem}_r90.png")
        derived[f"{p.stem}_r90.png"] = p.name
    return derived


def _hash_tiles(kind: str, shape: tuple[int, int], n: int, seed: int) -> "np.ndarray":
    """n seeded float32 grayscale tiles: uniform noise, or smooth photo-like
    fields (bicubic up-sampled 4x4 noise, what the LANCZOS front end gives)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, 255, size=(n, *shape)).astype(np.float32)
    h, w = shape
    return np.stack([
        np.asarray(Image.fromarray(t).resize((w, h), Image.Resampling.BICUBIC), np.float32)
        for t in rng.integers(0, 256, size=(n, 4, 4), dtype=np.uint8)
    ])


def dup_cli_phase(work: Path) -> int:
    """pHash/dHash words on the card against their specs; ``index`` (dummy
    tagger, fused signatures) then ``dup --sweep --audit`` and ``dup
    --refine`` through the port's CLI; the catalog's signature words and the
    refine pass's device words and sums against their specs. Returns the
    kernel-5 launches of the ``dup --audit`` run."""
    import numpy as np

    from kobato_eyes_tpu_torch.core.config.schema import PipelineSettings, Settings, TaggerSettings
    from kobato_eyes_tpu_torch.core.config.service import save_settings
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import missing_signature_ids
    from kobato_eyes_tpu_torch.dup.refine_clusters import _load_small_gray
    from kobato_eyes_tpu_torch.ops import mae, pairwise_hamming, phash, tile_hash
    from kobato_eyes_tpu_torch.sig.signatures import _decode_one
    from kobato_eyes_tpu_torch.utils.bits import U64_MASK, u32pair_to_u64

    # the device DCT (float64) and bit packing, exact against the specs
    for kind in ("uniform", "smooth"):
        g32 = _hash_tiles(kind, (32, 32), 512, seed=40)
        g98 = _hash_tiles(kind, (8, 9), 512, seed=41)
        ph = u32pair_to_u64(phash.to_u32pairs(phash.phash_batch(g32, device=DEVICE)))
        dh = u32pair_to_u64(phash.to_u32pairs(phash.dhash_batch(g98, device=DEVICE)))
        ph_bad = sum(int(h) != phash.phash_np(g) for h, g in zip(ph, g32))
        dh_bad = sum(int(h) != phash.dhash_np(g) for h, g in zip(dh, g98))
        print(f"phash/dhash on the card, 512 {kind} tiles: {ph_bad} pHash and {dh_bad} dHash words "
              f"differ from phash_np/dhash_np")
        check(ph_bad == 0 and dh_bad == 0, f"{kind} tiles: device hash words != specs")

    lib = work / "dup_library"
    derived = write_dup_library(lib)
    n_files = DUP_LIB_IMAGES + len(derived)
    settings = Settings(pipeline=PipelineSettings(roots=[lib], batch_size=BATCH),
                        tagger=TaggerSettings(name="dummy"))
    check(settings.pipeline.inline_signatures, "inline_signatures is not the default")
    cfg = work / "dup_settings.yaml"
    save_settings(settings, cfg)
    data = work / "dup_data"
    base = ["--config", str(cfg), "--data-dir", str(data), "--device", DEVICE]

    stats = json.loads(run_cli(base + ["index"]).strip().splitlines()[-1])
    print(f"dup library index: tagged={stats['tagged']} signatures_fused={stats['extra']['signatures_fused']} "
          f"elapsed_sec={stats['elapsed_sec']:.3f}")
    check(stats["tagged"] == n_files, f"tagged {stats['tagged']} != {n_files}")
    check(stats["extra"]["signatures_fused"] == stats["tagged"],
          f"signatures_fused {stats['extra']['signatures_fused']} != tagged {stats['tagged']}")
    conn = bootstrap(data / "db" / "catalog.sqlite3")
    try:
        check(missing_signature_ids(conn) == [], "files without signatures after a fused index")
        rows = conn.execute("SELECT f.path, s.phash_u64, s.dhash_u64 FROM files f "
                            "JOIN signatures s ON s.file_id = f.id").fetchall()
    finally:
        conn.close()
    # the fused lane's words in the catalog against the specs on the same
    # files, decoded by the standalone lane's front end
    check(len(rows) == n_files, f"{len(rows)} signature rows != {n_files} files")
    bad = []
    for path, ph_s64, dh_s64 in rows:
        g32, g98 = _decode_one(path)
        if (ph_s64 & U64_MASK, dh_s64 & U64_MASK) != (phash.phash_np(g32), phash.dhash_np(g98)):
            bad.append(Path(path).name)
    print(f"catalog signatures: {len(rows) - len(bad)}/{len(rows)} pHash/dHash pairs equal the specs")
    check(not bad, f"fused signature words != phash_np/dhash_np for {bad[:5]}")

    pairwise_hamming.launches = 0
    out = run_cli(base + ["dup", "--sweep", "--audit"])
    launches = pairwise_hamming.launches
    cluster_of = {}
    for line in out.splitlines():
        if "  " in line and "h=" in line:
            cluster_of[Path(line.rsplit("  ", 1)[1].strip()).name] = int(line.split()[0])
    together = sum(1 for d, b in derived.items() if d in cluster_of and cluster_of.get(d) == cluster_of.get(b))
    print(f"dup --sweep --audit: {len(set(cluster_of.values()))} clusters over {len(cluster_of)} files; "
          f"{together}/{len(derived)} derivatives share their base's cluster; kernel launches {launches}")
    check(together == len(derived), "a re-encode or resize does not share its base's cluster")
    check(launches > 0, "dup --audit launched no pairwise_hamming kernel")

    refined = run_cli(base + ["dup", "--refine"])
    n_refined = len({int(line.split()[0]) for line in refined.splitlines() if "h=" in line})
    print(f"dup --refine: {n_refined} clusters")

    # the refine pass's device words and sums against the specs, on the
    # thumbnails refinement decodes
    paths = sorted(lib.iterdir())
    thumbs = np.stack([_load_small_gray(p, 64) for p in paths])
    words = tile_hash.tile_ahash_batch(thumbs, grid=8, tile=8, device=DEVICE)
    check(all(tile_hash.words_to_int(w) == tile_hash.tile_ahash_np(t, 8, 8) for w, t in zip(words, thumbs)),
          "tile-aHash words != tile_ahash_np")
    big = np.stack([_load_small_gray(p, 128) for p in paths])
    keeper = np.roll(np.arange(len(paths)), 1)
    sums = mae.abs_diff_sums(big, big[keeper], device=DEVICE)
    maes = (sums.astype(np.float64) / (128 * 128)) / 255.0
    check(all(float(m) == mae.mae01_np(a, b) for m, a, b in zip(maes, big, big[keeper])), "MAE sums != mae01_np")
    print(f"refine ops on the card: tile-aHash words and MAE sums of {len(paths)} thumbnails equal the specs")
    return launches


# ---------------------------------------------------------------------------
# Query path: the device tag-query engine
# ---------------------------------------------------------------------------

CATEGORY_NAMES = ("general", "artist", "rating", "copyright", "character", "meta")
CASED_CATEGORIES = (0, 3, 4)  # general, copyright, character: the SQL threshold CASE
# Thresholds that f32 holds exactly (the fallbacks for character and
# copyright, 0.25, are such too; the general fallback 0.35 is not and is
# overridden): the SQL backend compares f64 scores with the f64 threshold,
# the engine f32 with f32, and the two part on a score equal to an inexact
# threshold's f32 rounding. Score terms in the queries are dyadic as well.
THRESHOLD_SETS = ({0: 0.375}, {0: 0.5, 4: 0.25}, {3: 0.75, 1: 0.5, 5: 0.125, 0: 0.25})
ORDERINGS = ("relevance", "mtime", "path", "id")


def _canonical_postings(epoch):
    """(tag, row)-ordered rows and scores of an epoch's host CSR. A delta
    keeps a tag's surviving postings and appends its fresh ones, a full
    build has them in catalog order: as sets per tag they must be equal."""
    import numpy as np

    tags = np.repeat(np.arange(epoch.num_tags), np.diff(epoch.offsets))
    order = np.lexsort((epoch.rows_np, tags))
    return order, epoch.rows_np[order], epoch.scores_np[order]


def check_epochs_equal(got, want, what: str) -> None:
    """Every array of two epochs, host and device; postings as sets per tag."""
    import numpy as np
    import torch

    check((got.num_files, got.num_tags, got.nnz, got.n_pad, got.t_pad)
          == (want.num_files, want.num_tags, want.nnz, want.n_pad, want.t_pad), f"{what}: sizes differ")
    check(got.paths == want.paths and got.tag_names == want.tag_names, f"{what}: paths or tag names differ")
    for name in ("file_ids", "mtimes", "sizes", "tag_cats", "offsets"):
        check(np.array_equal(getattr(got, name), getattr(want, name)), f"{what}: {name} differs")
    for name in ("cat_max_dev", "cat_present_dev", "smax_dev", "smin_dev"):
        check(torch.equal(getattr(got, name), getattr(want, name)), f"{what}: {name} differs")
    (go, gr, gs), (wo, wr, ws) = _canonical_postings(got), _canonical_postings(want)
    check(np.array_equal(gr, wr) and np.array_equal(gs, ws), f"{what}: host postings differ")
    nnz = got.nnz
    for name in ("rows_dev", "scores_dev"):
        g, w = getattr(got, name).cpu().numpy(), getattr(want, name).cpu().numpy()
        check(np.array_equal(g[:nnz][go], w[:nnz][wo]) and np.array_equal(g[nnz:], w[nnz:]),
              f"{what}: {name} differs")


def _sql_rows(conn, query, thr, order_by, limit, offset):
    from kobato_eyes_tpu_torch.db.repository import search_files
    from kobato_eyes_tpu_torch.query.ast import extract_positive_tag_terms
    from kobato_eyes_tpu_torch.query.sql import normalize_thresholds, translate_query

    frag = translate_query(query, thresholds=thr)
    return search_files(conn, frag.where, frag.params, positive_tags=extract_positive_tag_terms(query),
                        thresholds=normalize_thresholds(thr), order_by=order_by, limit=limit, offset=offset,
                        hydrate=False)


def check_rows_equal_sql(rows, sql, what: str, relevance: bool) -> None:
    check([r.file_id for r in rows] == [r.file_id for r in sql], f"{what}: ids differ from the SQL backend's")
    if relevance:
        # f64 sums of the same f64 scores; SQLite adds in row order, the
        # engine in term order: 1e-9 covers the last bits
        check(all(abs(a.relevance - b.relevance) <= 1e-9 for a, b in zip(rows, sql)),
              f"{what}: relevance differs from the SQL backend's")


def _search_lines(out: str) -> list[tuple[str, str]]:
    return [tuple(line.split(None, 1)) for line in out.splitlines() if line.strip() and not line.startswith("#")]


def query_cli_phase(work: Path, lib: Path, labels: Path, cfg: Path) -> None:
    """On the ViT run's catalog: ``search`` with the default (device) backend
    through the CLI against ``--backend sql``, a three-query batch, a second
    call that loads the snapshot; then the ViT index run with an
    ``EpochManager`` (a full build), and a second run over the library with
    files rewritten, removed and added (a delta)."""
    import numpy as np
    from PIL import Image

    from kobato_eyes_tpu_torch.core.config.service import load_settings
    from kobato_eyes_tpu_torch.core.pipeline import run_index_once
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.query import engine
    from kobato_eyes_tpu_torch.utils.paths import get_app_paths

    data = work / "data"
    base = ["--config", str(cfg), "--data-dir", str(data)]  # no --device: the default is the card
    conn = bootstrap(data / "db" / "catalog.sqlite3")
    try:
        names = [r[0] for r in conn.execute(
            "SELECT t.name FROM file_tags ft JOIN tags t ON t.id = ft.tag_id WHERE t.category = 0 "
            "GROUP BY t.id ORDER BY COUNT(*) DESC, t.name LIMIT 6")]
        route = "native (C sqlite3 walk)" if engine._fetch_file_tag_arrays_native(conn) is not None else "python"
    finally:
        conn.close()
    check(len(names) == 6, "the ViT index run wrote fewer than 6 general tags")
    print(f"query cli: catalog fetch route: {route}")

    builds = []
    real_build = engine.build_epoch

    def counting_build(*args, **kwargs):
        builds.append(str(kwargs.get("device")))
        return real_build(*args, **kwargs)

    engine.build_epoch = counting_build
    try:
        snap = get_app_paths(data).index_dir / "epoch.npz"
        check(not snap.exists(), "an epoch snapshot exists before the first device search")
        queries = [names[0], f"{names[0]} {names[1]} -{names[2]}", f"( {names[3]} OR {names[4]} ) category:character",
                   f"{names[5]} score>=0.875"]
        for i, query in enumerate(queries):
            t0 = time.perf_counter()
            device = _search_lines(run_cli(base + ["search", query]))
            wall = time.perf_counter() - t0
            sql = _search_lines(run_cli(base + ["search", "--backend", "sql", query]))
            check(device == sql, f"search {query!r}: device backend != sql backend, line for line")
            print(f"query cli: search {query!r}: {len(device)} lines equal to --backend sql "
                  f"({'built and saved the snapshot' if i == 0 else 'loaded the snapshot'}, {wall * 1e3:.1f} ms)")
        check(len(_search_lines(run_cli(base + ["search", queries[0]]))) > 0, "device search returned nothing")
        check(builds == [DEVICE], f"epoch builds over five device searches: {builds} (one expected, then the snapshot)")
        check(snap.exists() and snap.with_suffix(".json").exists(), "no epoch snapshot after a device search")
        out = run_cli(base + ["search", "--limit", "20", *queries[:3]])
        groups = out.split("# query: ")[1:]
        check(len(groups) == 3, "three-query batch: three sections expected")
        for query, group in zip(queries[:3], groups):
            single = _search_lines(run_cli(base + ["search", "--limit", "20", query]))
            check(_search_lines(group.split("\n", 1)[1]) == single, f"batch section {query!r} != its single search")
        print(f"query cli: three-query batch equals the singles; epoch builds in all: {len(builds)}")
    finally:
        engine.build_epoch = real_build

    # the ViT index run with an epoch manager: full build, then a delta
    lib2 = work / "library_epoch"
    shutil.copytree(lib, lib2)
    settings = load_settings(cfg)
    settings.pipeline.roots = [lib2]
    tagger = WD14Tagger(labels_path=labels, device=DEVICE)
    manager = engine.EpochManager()
    check(manager.device.type == DEVICE, "EpochManager() did not default to the card")
    db = work / "data_epoch" / "db" / "catalog.sqlite3"
    db.parent.mkdir(parents=True)
    stats = run_index_once(db, settings, tagger, epoch_manager=manager)
    first = manager.current
    print(f"query cli: vit-b448 index with an EpochManager: tagged={stats.tagged} epoch_version={stats.epoch_version} "
          f"stage_walls={json.dumps(stats.extra['stage_walls'])} files={first.num_files} tags={first.num_tags} "
          f"nnz={first.nnz} on {first.device}")
    check(stats.epoch_version == 1 and stats.tagged == N_IMAGES and stats.tag_failed == 0, "first epoch run")
    check("epoch" in stats.extra["stage_walls"] and first.device.type == DEVICE, "epoch stage wall / device")
    files = sorted(lib2.iterdir())
    rng = np.random.default_rng(5)
    for path in files[:3]:  # rewritten: retagged in place
        Image.fromarray(rng.integers(0, 256, size=(200, 240, 3), dtype=np.uint8)).save(path)
    files[3].unlink()
    files[4].unlink()
    Image.fromarray(rng.integers(0, 256, size=(300, 200, 3), dtype=np.uint8)).save(lib2 / "zz_added.png")
    stats = run_index_once(db, settings, tagger, epoch_manager=manager)
    second = manager.current
    print(f"query cli: second run: tagged={stats.tagged} missing={stats.missing} epoch_version={stats.epoch_version} "
          f"stage_walls={json.dumps(stats.extra['stage_walls'])} files={second.num_files} nnz={second.nnz}")
    check(stats.epoch_version == 2 and stats.tagged == 4 and stats.missing == 2, "second epoch run")
    check(second.num_files == N_IMAGES - 1 and first.version == 1 and first.num_files == N_IMAGES,
          "delta epoch file axis / the first epoch was written")
    conn = bootstrap(db)
    try:
        check_epochs_equal(second, engine.build_epoch(conn, version=2), "delta after the second index run")
        for query in ("", names[0], f"-{names[0]}", "category:character score>=0.5"):
            rows = engine.search_epoch(second, query, limit=1000)
            check_rows_equal_sql(rows, _sql_rows(conn, query, {}, "relevance", 1000, 0), f"delta epoch {query!r}", True)
    finally:
        conn.close()
    print("query cli: the delta epoch equals a fresh build and the SQL backend")
    del tagger


def _write_query_catalog(db: Path, n_files: int, n_tags: int, seed: int):
    """A seeded catalog written in bulk: ``n_files`` files with ~30 distinct
    tags each from a Zipf-like vocabulary over all six categories, f32 scores
    (a tenth of them exactly 0.5), mtimes with ties. Returns the connection."""
    import numpy as np

    from kobato_eyes_tpu_torch.db.connection import bootstrap

    rng = np.random.default_rng(seed)
    db.parent.mkdir(parents=True, exist_ok=True)
    conn = bootstrap(db)
    p = 1.0 / (np.arange(n_tags) + 8.0)
    draws = rng.choice(n_tags, size=(n_files, 36), p=p / p.sum())
    keys = np.unique(np.arange(n_files, dtype=np.int64)[:, None] * n_tags + draws)
    fid, tid = keys // n_tags + 1, keys % n_tags + 1
    scores = rng.uniform(0.05, 1.0, len(keys)).astype(np.float32)
    scores[rng.random(len(keys)) < 0.1] = 0.5
    cats = np.asarray((0, 0, 0, 0, 4, 3, 1, 2, 5, 0))[np.arange(n_tags) % 10]
    with conn:
        conn.executemany("INSERT INTO files (id, path, size, mtime, is_present) VALUES (?, ?, ?, ?, 1)",
                         [(i + 1, f"/lib/{i % 97:02d}/img_{i:06d}.png", 1000 + i % 5000, 1e9 + (i % 1013) * 60.0)
                          for i in range(n_files)])
        conn.executemany("INSERT INTO tags (id, name, category) VALUES (?, ?, ?)",
                         [(t + 1, f"tag_{t:04d}", int(cats[t])) for t in range(n_tags)])
        conn.executemany("INSERT INTO file_tags (file_id, tag_id, score) VALUES (?, ?, ?)",
                         zip(fid.tolist(), tid.tolist(), scores.astype(np.float64).tolist()))
    return conn, len(keys)


def _parity_queries() -> list[str]:
    a, b, c, d, e, f = (f"tag_{t:04d}" for t in (0, 1, 2, 4, 5, 40))
    rare, mid = "tag_1900", "tag_0300"
    queries = [
        "", a, f"{a} {b}", f"{a} AND {b}", f"{a} OR {b}", f"{a} -{b}", f"NOT {a}", f"-{a} -{b}",
        f"( {a} OR {b} ) {c}", f"{a} AND ( {d} OR {e} )", f"-( {a} {b} )", f"( {a} OR {rare} ) -( {b} OR {mid} )",
        f"{d} {e}", f"{d} OR {e} OR {f}", f"{rare} OR {mid}", f"{mid} -{a}", f"NOT ( {a} OR {b} OR {c} )",
        "unknown_tag", f"{a} OR unknown_tag", f"{a} unknown_tag", "-unknown_tag",
        f"{a} score>=0.75", f"{a} score>0.5", f"{b} score<=0.125", f"{c} score<0.25", "score=0.5", f"{a} -score=0.5",
        "score>=0.96875", "score<0.0625", f"NOT score>0.5 {a}",
    ]
    queries += [f"category:{name}" for name in CATEGORY_NAMES]
    queries += [f"category:{name} {a}" for name in ("character", "copyright", "meta")]
    queries += ["category:character score>=0.5", "-category:artist", "category:rating OR category:meta",
                f"( category:character OR {rare} ) -{a}", f"category:general -category:character {b}"]
    return queries


def query_parity_phase(work: Path) -> None:
    """A seeded catalog of 20 000 files x ~30 tags (2 000-tag vocabulary, six
    categories): every query of the list through ``search_epoch`` on the card
    against the SQL backend (ids and relevance), the batch against the
    singles, the mask evaluation under the sync debug mode, then a delta
    (500 retagged, 100 removed, 100 added) against a fresh build."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.db.repository import TaggingItem, delete_files, mark_files_absent, upsert_file
    from kobato_eyes_tpu_torch.db.repository import write_tagging_batch
    from kobato_eyes_tpu_torch.query import engine
    from kobato_eyes_tpu_torch.query.ast import parse_query
    from kobato_eyes_tpu_torch.query.sql import normalize_thresholds
    from kobato_eyes_tpu_torch.utils.metrics import metrics

    n_files, n_tags = 20_000, 2_000
    t0 = time.perf_counter()
    conn, nnz = _write_query_catalog(work / "parity" / "catalog.sqlite3", n_files, n_tags, seed=11)
    t_write = time.perf_counter() - t0
    try:
        metrics.reset()
        t0 = time.perf_counter()
        epoch = engine.build_epoch(conn, version=1)
        t_build = time.perf_counter() - t0
        timers = metrics.snapshot()["timers"]
        print(f"query parity: catalog {n_files} files x {n_tags} tags, {nnz} postings written in {t_write:.1f} s; "
              f"build_epoch {t_build * 1e3:.0f} ms (sort {timers['epoch.sort']['total'] * 1e3:.0f} ms, "
              f"upload {timers['epoch.upload']['total'] * 1e3:.1f} ms) on {epoch.device}, n_pad={epoch.n_pad}")
        check(epoch.device.type == DEVICE and epoch.num_files == n_files and epoch.nnz == nnz, "parity epoch")

        queries = _parity_queries()
        check(len(queries) >= 40, f"{len(queries)} parity queries")
        hits = 0
        for i, query in enumerate(queries):
            thr = THRESHOLD_SETS[i % 3]
            order_by = ORDERINGS[i % 4]
            limit, offset = ((1000, 0), (50, 7), (200, 0))[i % 3]
            rows = engine.search_epoch(epoch, query, thresholds=thr, order_by=order_by, limit=limit, offset=offset)
            sql = _sql_rows(conn, query, thr, order_by, limit, offset)
            check_rows_equal_sql(rows, sql, f"parity {query!r} {thr} {order_by}", order_by == "relevance")
            hits += len(rows)
        # every ordering on one query with a large hit set, relevance ties included
        for order_by in ORDERINGS:
            rows = engine.search_epoch(epoch, "tag_0000 OR tag_0001", thresholds=THRESHOLD_SETS[1],
                                       order_by=order_by, limit=300, offset=20)
            check_rows_equal_sql(rows, _sql_rows(conn, "tag_0000 OR tag_0001", THRESHOLD_SETS[1], order_by, 300, 20),
                                 f"parity ordering {order_by}", order_by == "relevance")
        print(f"query parity: {len(queries)} queries (AND / OR / NOT / parentheses / category: / score ops / unknown tag; "
              f"3 threshold sets, 4 orderings, offsets) equal the SQL backend in ids and relevance; {hits} rows")

        for order_by, thr in (("relevance", THRESHOLD_SETS[1]), ("path", {})):
            kw = dict(thresholds=thr, order_by=order_by, limit=100, offset=3)
            batch = engine.search_epoch_batch(epoch, queries, **kw)
            singles = [engine.search_epoch(epoch, q, **kw) for q in queries]
            check(batch == singles, f"search_epoch_batch != the singles ({order_by})")
        print(f"query parity: search_epoch_batch of {len(queries)} equals the singles")

        # no step of the mask evaluation may read a device value on the host
        thr = normalize_thresholds(THRESHOLD_SETS[1])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            words = [engine._mask_words(epoch, engine._slot_tables_np(epoch, parse_query(q), thr)) for q in queries]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(all(w.dtype == torch.uint8 and w.shape == (epoch.n_pad // 8,) for w in words), "packed words")
        print(f"query parity: {len(words)} masks evaluated under set_sync_debug_mode('error'): no sync")

        # delta: 500 retagged in place (new tags among them), 100 removed, 100 added
        rng = np.random.default_rng(12)
        ids = rng.permutation(n_files)[:600] + 1
        retag, gone = ids[:500].tolist(), ids[500:].tolist()
        items = []
        for k, fid in enumerate(retag):
            picks = rng.choice(n_tags, size=12, replace=False)
            tags = [(f"tag_{t:04d}", float(np.float32(rng.uniform(0.05, 1.0))), int((0, 0, 0, 0, 4, 3, 1, 2, 5, 0)[t % 10]))
                    for t in picks]
            if k % 50 == 0:
                tags.append((f"fresh_tag_{k}", 0.75, 0))
            items.append(TaggingItem(file_id=fid, tags=tags, tagger_sig="s2"))
        write_tagging_batch(conn, items)
        mark_files_absent(conn, gone[:50])
        delete_files(conn, gone[50:])
        added = [upsert_file(conn, path=f"/lib/new/img_{i:04d}.png", size=77 + i, mtime=2e9 + i) for i in range(100)]
        write_tagging_batch(conn, [TaggingItem(file_id=f, tags=[("tag_0000", 0.5, 0), ("tag_0004", 0.875, 4),
                                                                 ("fresh_tag_0", 0.25, 0)]) for f in added])
        conn.commit()
        metrics.reset()
        t0 = time.perf_counter()
        delta = engine.update_epoch(conn, epoch, changed_file_ids=retag + gone + added, version=2)
        t_delta = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh = engine.build_epoch(conn, version=2)
        t_fresh = time.perf_counter() - t0
        check_epochs_equal(delta, fresh, "update_epoch after 500 retagged, 100 removed, 100 added")
        check(delta.num_files == n_files and "fresh_tag_0" in delta.name_to_tid and epoch.num_files == n_files
              and "fresh_tag_0" not in epoch.name_to_tid, "delta epoch axis / previous epoch untouched")
        for i, query in enumerate(queries[:20] + ["fresh_tag_0", "fresh_tag_0 OR fresh_tag_50"]):
            rows = engine.search_epoch(delta, query, thresholds=THRESHOLD_SETS[i % 3], limit=500)
            check_rows_equal_sql(rows, _sql_rows(conn, query, THRESHOLD_SETS[i % 3], "relevance", 500, 0),
                                 f"delta {query!r}", True)
        print(f"query parity: update_epoch (500 retagged, 100 removed, 100 added) in {t_delta * 1e3:.0f} ms equals a "
              f"fresh build_epoch ({t_fresh * 1e3:.0f} ms) array for array, and the SQL backend on 22 queries")
    finally:
        conn.close()


SCALE_FILES = 1_000_000
SCALE_TAGS = 8192


def _numpy_mask(expr, csr, thr: dict) -> "np.ndarray":
    """The query's file mask by plain numpy over the host CSR: the SQL
    backend's semantics (an EXISTS per term; a tag's score against its
    category's threshold, f32 against f32 as the engine stores them) written
    out independently of the engine's panels and packed words."""
    import numpy as np

    from kobato_eyes_tpu_torch.query import ast

    n, offsets, rows, scores, tag_cats, entry_cats, name_to_tid = csr

    def rows_mask(sel_rows):
        mask = np.zeros(n, dtype=bool)
        mask[sel_rows] = True
        return mask

    def ev(node):
        if node is None:
            return np.ones(n, dtype=bool)
        if isinstance(node, ast.TagExpr):
            tid = name_to_tid.get(node.name)
            if tid is None:
                return np.zeros(n, dtype=bool)
            cat = int(tag_cats[tid])
            gate = np.float32(thr.get(cat if cat in CASED_CATEGORIES else -1, 0.0))
            lo, hi = int(offsets[tid]), int(offsets[tid + 1])
            return rows_mask(rows[lo:hi][scores[lo:hi] >= gate])
        if isinstance(node, ast.CategoryExpr):
            cat = int(node.category)
            return rows_mask(rows[(entry_cats == cat) & (scores >= np.float32(thr.get(cat, 0.0)))])
        if isinstance(node, ast.ScoreExpr):
            t = np.float32(node.threshold)
            op = {">=": np.greater_equal, ">": np.greater, "<=": np.less_equal, "<": np.less, "=": np.equal}[node.op]
            return rows_mask(rows[op(scores, t)])
        if isinstance(node, ast.NotExpr):
            return ~ev(node.operand)
        if isinstance(node, ast.AndExpr):
            return ev(node.left) & ev(node.right)
        if isinstance(node, ast.OrExpr):
            return ev(node.left) | ev(node.right)
        raise SmokeFailure(f"unhandled query node {node!r}")

    return ev(expr)


def query_scale_phase() -> None:
    """The size the engine is written for: 1 000 000 files, 8 192 tags with a
    Zipf-like frequency, ~30 M postings, drawn from a seed on the card and
    put through ``_assemble_epoch`` (no SQLite). A dozen queries' masks against
    a plain numpy evaluation over the host CSR; build wall, device memory,
    warm single-query latency and a batch of 32 against 32 singles."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.query import engine
    from kobato_eyes_tpu_torch.query.ast import parse_query
    from kobato_eyes_tpu_torch.query.sql import normalize_thresholds
    from kobato_eyes_tpu_torch.utils.metrics import metrics

    n, n_tags = SCALE_FILES, SCALE_TAGS
    t_phase = time.perf_counter()
    # the postings are drawn on the card (the host takes a minute for the
    # same draws): 32 tags a file by inverse CDF, distinct (file, tag) pairs
    # kept, file-major as a catalog lists them; scores on a 1/512 grid
    gen = torch.Generator(device=DEVICE).manual_seed(2024)
    weights = 1.0 / (torch.arange(n_tags, dtype=torch.float64, device=DEVICE) + 24.0)
    cdf = torch.cumsum(weights / weights.sum(), 0).float()
    draws = torch.searchsorted(cdf, torch.rand(n * 32, generator=gen, device=DEVICE)).clamp_(max=n_tags - 1)
    draws += torch.arange(n, device=DEVICE).repeat_interleave(32) * n_tags
    keys = torch.unique(draws)
    del draws
    nnz = int(keys.numel())
    grid = torch.round((torch.rand(nnz, generator=gen, device=DEVICE) * 0.95 + 0.05) * 512) / 512
    r_idx = (keys // n_tags).to(torch.int32).cpu().numpy()
    t_idx = (keys % n_tags).cpu().numpy()
    sc = grid.double().cpu().numpy()  # f32-exact values as the f64 a catalog returns
    del keys, grid, cdf, weights
    torch.cuda.empty_cache()
    tag_cats = np.asarray((0, 0, 0, 0, 4, 3, 1, 2, 5, 0), dtype=np.int32)[np.arange(n_tags) % 10]
    tag_names = [f"tag_{t:04d}" for t in range(n_tags)]
    t_made = time.perf_counter() - t_phase

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    metrics.reset()
    t0 = time.perf_counter()
    epoch = engine._assemble_epoch(
        version=1, file_ids=np.arange(1, n + 1, dtype=np.int64),
        mtimes=1e9 + (np.arange(n) % 100_003) * 7.0, sizes=np.arange(n, dtype=np.int64) % 9_999_991,
        paths=[f"/lib/{i % 997:03d}/img_{i:07d}.png" for i in range(n)],
        tag_names=tag_names, tag_cats=tag_cats, t_idx=t_idx, r_idx=r_idx, sc=sc,
    )
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    timers = metrics.snapshot()["timers"]
    resident = torch.cuda.memory_allocated() - before
    postings_bytes = epoch.rows_dev.numel() * 4 + epoch.scores_dev.numel() * 4
    panel_bytes = sum(t.numel() * t.element_size() for t in
                      (epoch.cat_max_dev, epoch.cat_present_dev, epoch.smax_dev, epoch.smin_dev))
    print(f"query scale: {n} files, {n_tags} tags, {nnz} postings (made in {t_made:.1f} s); _assemble_epoch "
          f"{t_build:.2f} s (epoch.sort {timers['epoch.sort']['total']:.2f} s, epoch.upload "
          f"{timers['epoch.upload']['total'] * 1e3:.1f} ms, the rest panels and offsets on the host); on the card "
          f"{resident / 1e6:.1f} MB (postings {postings_bytes / 1e6:.1f} MB padded to {epoch.rows_dev.numel()}, "
          f"panels {panel_bytes / 1e6:.1f} MB at n_pad={epoch.n_pad}), peak {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    check(epoch.device.type == DEVICE and epoch.nnz == nnz and nnz > 20 * n, "scale epoch")
    del t_idx, r_idx, sc

    # masks against plain numpy over the host CSR
    scores32 = epoch.scores_np.astype(np.float32)
    entry_cats = np.repeat(tag_cats, np.diff(epoch.offsets))
    csr = (n, epoch.offsets, epoch.rows_np, scores32, tag_cats, entry_cats, epoch.name_to_tid)
    a, b, c, d, e = (f"tag_{t:04d}" for t in (0, 1, 2, 4, 5))
    mid, rare = "tag_0500", "tag_8000"
    queries = [
        a, f"{a} {b}", f"{a} OR {mid}", f"{a} -{b}", f"NOT {rare}", f"( {a} OR {b} ) {c}", f"{a} AND ( {d} OR {e} )",
        "category:character", "category:meta score>=0.5", "score>=0.998", "score<0.0625", "score=0.5",
        "unknown_tag", f"{rare} OR unknown_tag", f"-( {a} {b} ) category:copyright",
    ]
    t0 = time.perf_counter()
    for i, query in enumerate(queries):
        thr = normalize_thresholds(THRESHOLD_SETS[i % 3])
        words = engine._mask_words(epoch, engine._slot_tables_np(epoch, parse_query(query), thr))
        got = engine._unpack_mask(words.cpu().numpy(), n)
        want = _numpy_mask(parse_query(query), csr, thr)
        check(np.array_equal(got, want), f"scale mask {query!r}: differs from the numpy evaluation "
              f"({int((got != want).sum())} of {n} files)")
        if i < 3 or query.startswith("score"):
            print(f"query scale: mask {query!r}: {int(got.sum())} files")
    print(f"query scale: {len(queries)} masks equal the numpy evaluation over the host CSR "
          f"({time.perf_counter() - t0:.1f} s)")
    del scores32, entry_cats, csr

    # latency, warm: 50 single queries by the host clock, the device's share
    # of each by CUDA events around the mask evaluation
    mix = [q for q in queries if q != "score=0.5"] + [f"tag_{t:04d} tag_{t + 1:04d}" for t in range(10, 40, 3)]
    for query in mix[:3]:
        engine.search_epoch(epoch, query, limit=200)
    walls, dev_ms, eval_ms = [], [], []
    for k in range(50):
        query = mix[k % len(mix)]
        thr = normalize_thresholds({})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = engine.search_epoch(epoch, query, limit=200)  # the catalog's default thresholds
        walls.append((time.perf_counter() - t0) * 1e3)
        tables = engine._slot_tables_np(epoch, parse_query(query), thr)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        words = engine._mask_words(epoch, tables)
        end.record()
        host = words.cpu()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        del rows, host
    p50 = float(np.median(walls))
    print(f"query scale: warm search_epoch over {len(walls)} queries (limit 200, relevance order): host clock p50 "
          f"{p50:.3f} ms, min {min(walls):.3f}, max {max(walls):.3f}; mask evaluation + copy of {epoch.n_pad // 8} "
          f"bytes p50 {float(np.median(eval_ms)):.3f} ms, of which the device is busy p50 "
          f"{float(np.median(dev_ms)):.3f} ms (CUDA events); the rest of a query is parse, unpack, relevance and "
          f"ordering on the host")
    t0 = time.perf_counter()
    engine.search_epoch(epoch, "score=0.5", limit=200)
    print(f"query scale: 'score=0.5' (the one term that walks all {nnz} postings): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")

    batch_queries = [mix[k % len(mix)] for k in range(32)]
    engine.search_epoch_batch(epoch, batch_queries[:4], limit=200)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = engine.search_epoch_batch(epoch, batch_queries, limit=200)
    t_batch = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    singles = [engine.search_epoch(epoch, q, limit=200) for q in batch_queries]
    t_singles = (time.perf_counter() - t0) * 1e3
    check(batch == singles, "scale: search_epoch_batch != the singles")
    print(f"query scale: batch of 32: {t_batch:.2f} ms; the same 32 one by one: {t_singles:.2f} ms; equal results; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    del epoch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Slice phase: the port's CLI over a seeded library
# ---------------------------------------------------------------------------


def write_library(root: Path, n: int, seed: int) -> None:
    """Seeded images of mixed sizes, PNG and JPEG: smooth colour fields with
    noise, so they decode and resize like photos rather than like static."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        w, h = (int(x) for x in rng.integers(160, 1024, size=2))
        small = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(small).resize((w, h), Image.Resampling.BICUBIC)).astype(np.int16)
        img = np.clip(img + rng.integers(-12, 13, size=img.shape), 0, 255).astype(np.uint8)
        if i % 2:
            Image.fromarray(img).save(root / f"img_{i:04d}.jpg", quality=90)
        else:
            Image.fromarray(img).save(root / f"img_{i:04d}.png")


def write_labels(path: Path, n: int) -> None:
    """WD14 ``selected_tags.csv`` format: 4 rating rows (category 9), then
    general (0) with character (4) and copyright (3) rows interleaved."""
    lines = ["tag_id,name,category,count"]
    for i in range(n):
        cat = 9 if i < 4 else 4 if i % 17 == 0 else 3 if i % 23 == 0 else 0
        lines.append(f"{i},tag_{i},{cat},{n - i}")
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def run_cli(argv: list[str]) -> str:
    from kobato_eyes_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv} exited {rc}")
    return out.getvalue()


def write_workspace(work: Path) -> tuple[Path, Path, Path]:
    """The seeded library, its label table and a settings file naming both;
    returns (library, labels, settings path)."""
    from kobato_eyes_tpu_torch.core.config.schema import PipelineSettings, Settings, TaggerSettings
    from kobato_eyes_tpu_torch.core.config.service import save_settings

    t0 = time.perf_counter()
    lib = work / "library"
    write_library(lib, N_IMAGES, seed=0)
    labels = work / "selected_tags.csv"
    write_labels(labels, N_LABELS)
    settings = Settings(
        pipeline=PipelineSettings(roots=[lib], batch_size=BATCH, inline_signatures=False),
        tagger=TaggerSettings(name="wd14", labels_path=labels),
    )
    cfg = work / "settings.yaml"
    save_settings(settings, cfg)
    print(f"slice setup: {N_IMAGES} images + {N_LABELS} labels in {time.perf_counter() - t0:.1f} s")
    return lib, labels, cfg


def search_top_tag(data: Path, base: list[str]) -> None:
    """``search --backend sql`` through the CLI for the general tag the index
    run assigned most often; fails on an empty result."""
    from kobato_eyes_tpu_torch.db.connection import bootstrap

    conn = bootstrap(data / "db" / "catalog.sqlite3")
    try:
        row = conn.execute(
            "SELECT t.name, COUNT(*) AS n FROM file_tags ft JOIN tags t ON t.id = ft.tag_id "
            "WHERE t.category = 0 GROUP BY t.id ORDER BY n DESC, t.name LIMIT 1"
        ).fetchone()
        n_rows = conn.execute("SELECT COUNT(*) FROM file_tags").fetchone()[0]
    finally:
        conn.close()
    check(row is not None, "index run wrote no general tags")
    hits = [line for line in run_cli(base + ["search", "--backend", "sql", row["name"]]).splitlines() if line.strip()]
    print(f"search --backend sql {row['name']!r}: {len(hits)} results "
          f"(tag on {row['n']} files; {n_rows} file_tags rows)")
    check(len(hits) > 0, "search returned no results")


def print_index_stats(name: str, stats: dict, wall: float, launches: str) -> None:
    print(
        f"{name} index: tagged={stats['tagged']} tag_failed={stats['tag_failed']} "
        f"written={stats['written']} elapsed_sec={stats['elapsed_sec']:.3f} wall={wall:.3f} s "
        f"images/s={stats['tagged'] / stats['elapsed_sec']:.2f} "
        f"stage_walls={json.dumps(stats['extra']['stage_walls'])} "
        f"tag_infer_s={stats['extra']['tag_infer_s']} {launches}"
    )
    check(stats["tagged"] == N_IMAGES, f"{name}: tagged {stats['tagged']} != {N_IMAGES}")
    check(stats["tag_failed"] == 0, f"{name}: tag_failed {stats['tag_failed']} != 0")


def slice_phase(work: Path, lib: Path, labels: Path, cfg: Path) -> tuple[int, int]:
    """ViT index + search through the CLI; returns the attention launches of
    the index run through the packed and the separate q, k, v entries."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.ops import attention

    data = work / "data"
    base = ["--config", str(cfg), "--data-dir", str(data), "--device", "cuda"]
    attention.launches = attention.launches_separate = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["index"])
    wall = time.perf_counter() - t0
    launches, separate = attention.launches, attention.launches_separate
    stats = json.loads(out.strip().splitlines()[-1])
    print_index_stats("vit-b448", stats, wall, f"attention_launches={launches} separate_qkv={separate}")
    depth = 12  # ViT-B: one attention launch per layer per batch
    check(launches == depth * (N_IMAGES // BATCH),
          f"attention launches {launches} != {depth * (N_IMAGES // BATCH)}")
    search_top_tag(data, base)

    # the fast forward (attention kernel + tanh-gelu) against the exact
    # einsum/erf forward, same weights, on a few of the library's images
    from kobato_eyes_tpu_torch.models.labels import load_labels
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

    fast = WD14Tagger(labels=load_labels(labels), device="cuda")
    exact = WD14Tagger(labels=load_labels(labels), device="cuda", fast_math=False,
                       params=fast._model.state_dict())
    check(fast.cfg.attn_impl == "pallas" and exact.cfg.attn_impl == "einsum", "fast_math knobs")
    imgs = [load_rgb_array(p) for p in sorted(lib.iterdir())[:4]]
    batch = fast.prepare_batch_from_rgb(imgs)
    p_fast = fast.forward_probs(batch)
    p_exact = exact.forward_probs(batch)
    torch.cuda.synchronize()
    check(tuple(p_fast.shape) == (4, N_LABELS), f"probs shape {tuple(p_fast.shape)}")
    check(bool(torch.isfinite(p_fast).all()), "non-finite probabilities")
    dev = float((p_fast - p_exact).abs().max())
    hit_frac = float((p_fast >= 0.35).float().mean())
    print(f"fast vs exact forward: max |dp| = {dev:.3e} (tol 0.02); "
          f"share of labels >= 0.35: {hit_frac:.3f}")
    check(dev <= 0.02, f"fast vs exact probability deviation {dev} > 0.02")

    # where a batch's device time goes: the forward at batch 32, fast and
    # exact, beside the attention kernel's share (one launch per layer)
    b32 = np.concatenate([batch] * (BATCH // len(batch)))
    fast_ms = cuda_ms(lambda: fast.forward_probs(b32), iters=5)
    exact_ms = cuda_ms(lambda: exact.forward_probs(b32), iters=5)
    print(f"vit-b448 batch-{BATCH} forward_probs: fast {fast_ms:.2f} ms, exact {exact_ms:.2f} ms "
          f"({BATCH / fast_ms * 1e3:.1f} images/s device-side on the fast path)")
    del fast, exact
    return launches, separate


def swin_phase(work: Path, lib: Path, labels: Path, cfg: Path) -> tuple[int, int, int]:
    """SwinV2-B/448: index through ``run_index_once``, search through the CLI,
    fast / exact / residual-LN forwards, then ``validate-checkpoint`` through
    the CLI on the index tagger's weights. Returns the window-kernel and the
    separate-q, k, v attention launches of the index run and the LN-kernel
    launches of the residual-LN batch."""
    import dataclasses

    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.core.config.service import load_settings
    from kobato_eyes_tpu_torch.core.pipeline import run_index_once
    from kobato_eyes_tpu_torch.models.labels import load_labels
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.ops import attention, layernorm_residual, window_attention
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

    t0 = time.perf_counter()
    fast = WD14Tagger(arch="swinv2", labels_path=labels, device="cuda")
    check(fast.cfg.attn_impl == "pallas" and fast.cfg.ln_impl == "xla", "swinv2 fast_math knobs")
    print(f"swinv2-b448 tagger: seeded init + upload in {time.perf_counter() - t0:.1f} s")
    data = work / "data_swin"
    (data / "db").mkdir(parents=True)
    window_attention.launches = 0
    layernorm_residual.launches = 0
    attention.launches_separate = 0
    t0 = time.perf_counter()
    stats = run_index_once(data / "db" / "catalog.sqlite3", load_settings(cfg), fast).__dict__
    wall = time.perf_counter() - t0
    win_launches, ln_launches = window_attention.launches, layernorm_residual.launches
    separate = attention.launches_separate
    print_index_stats("swinv2-b448", stats, wall,
                      f"window_launches={win_launches} ln_launches={ln_launches} separate_qkv={separate}")
    depth = sum(SWIN_B448_DEPTHS)  # one window-kernel launch per block per batch
    check(win_launches == depth * (N_IMAGES // BATCH),
          f"window launches {win_launches} != {depth * (N_IMAGES // BATCH)}")
    check(ln_launches == 0, f"LN launches {ln_launches} != 0 with ln_impl=xla")
    search_top_tag(data, ["--config", str(cfg), "--data-dir", str(data), "--device", "cuda"])

    state = fast._model.state_dict()
    exact = WD14Tagger(arch="swinv2", labels=load_labels(labels), device="cuda", fast_math=False,
                       params=state)
    ln_fast = WD14Tagger(labels=load_labels(labels), device="cuda", params=state,
                         swin=dataclasses.replace(fast.cfg, ln_impl="pallas_residual"))
    check(exact.cfg.attn_impl == "einsum" and ln_fast.cfg.ln_impl == "pallas_residual", "swinv2 knobs")
    imgs = [load_rgb_array(p) for p in sorted(lib.iterdir())[:4]]
    batch = fast.prepare_batch_from_rgb(imgs)
    b32 = np.concatenate([batch] * (BATCH // len(batch)))
    p_fast = fast.forward_probs(b32)
    p_exact = exact.forward_probs(b32)
    layernorm_residual.launches = 0
    ln_results = ln_fast.infer_batch_prepared(b32)
    ln_launches = layernorm_residual.launches
    p_ln = ln_fast.forward_probs(b32)
    torch.cuda.synchronize()
    check(len(ln_results) == BATCH, "residual-LN batch results")
    check(tuple(p_fast.shape) == (BATCH, N_LABELS), f"probs shape {tuple(p_fast.shape)}")
    for name, p in (("fast", p_fast), ("exact", p_exact), ("residual-LN", p_ln)):
        check(bool(torch.isfinite(p).all()), f"swinv2 {name}: non-finite probabilities")
    dev_exact = float((p_fast - p_exact).abs().max())
    dev_ln = float((p_fast - p_ln).abs().max())
    print(f"swinv2-b448 fast vs exact forward: max |dp| = {dev_exact:.3e} (tol 0.02); "
          f"residual-LN vs fast: max |dp| = {dev_ln:.3e} (tol 0.02); "
          f"LN launches in one residual-LN batch: {ln_launches}")
    check(dev_exact <= 0.02, f"swinv2 fast vs exact deviation {dev_exact} > 0.02")
    check(dev_ln <= 0.02, f"swinv2 residual-LN vs fast deviation {dev_ln} > 0.02")
    check(ln_launches == 2 * depth, f"LN launches {ln_launches} != {2 * depth}")

    fast_ms = cuda_ms(lambda: fast.forward_probs(b32), iters=5)
    exact_ms = cuda_ms(lambda: exact.forward_probs(b32), iters=5)
    ln_ms = cuda_ms(lambda: ln_fast.forward_probs(b32), iters=5)
    print(f"swinv2-b448 batch-{BATCH} forward_probs: fast {fast_ms:.2f} ms, exact {exact_ms:.2f} ms, "
          f"fast with residual-LN kernel {ln_ms:.2f} ms "
          f"({BATCH / fast_ms * 1e3:.1f} images/s device-side on the fast path)")
    del exact, ln_fast

    # validate-checkpoint through the CLI on the index tagger's weights
    ckpt = work / "swinv2_b448.pt"
    torch.save(state, ckpt)
    del fast, state
    t0 = time.perf_counter()
    out = run_cli(["--device", "cuda", "validate-checkpoint", str(ckpt), "--arch", "swinv2",
                   "--classes", str(N_LABELS)])
    report = json.loads(out)
    print(
        f"validate-checkpoint swinv2: ok={report['ok']} finite={report['finite']} "
        f"max_prob_deviation={report['max_prob_deviation']:.3e} "
        f"tag_flips={report['tag_flips']} out_of_band={report['tag_flips_out_of_band']} "
        f"import={report['import']} fast_path={report['fast_path']} "
        f"in {time.perf_counter() - t0:.1f} s"
    )
    check(report["finite"], "validate-checkpoint: non-finite forward")
    check(report["max_prob_deviation"] <= 0.02, "validate-checkpoint: deviation over 0.02")
    return win_launches, separate, ln_launches


# ---------------------------------------------------------------------------
# ANN path: the CLIP embedder, the fused embed lane, flat / IVF / HNSW, ket ann
# ---------------------------------------------------------------------------


def _f64_topk(corpus, queries, k: int, chunk: int = 131_072):
    """Exact top-k by an f64 evaluation, chunk by chunk on the card, equal
    scores lowest row first: -> (scores (Q, k) f64, rows (Q, k))."""
    import numpy as np
    import torch

    q = queries.double()
    cand_s, cand_r = [], []
    for start in range(0, corpus.shape[0], chunk):
        sims = q @ corpus[start:start + chunk].double().t()
        s, r = torch.topk(sims, min(4 * k, sims.shape[1]), dim=1)
        cand_s.append(s)
        cand_r.append(r + start)
    scores = torch.cat(cand_s, dim=1).cpu().numpy()
    rows = torch.cat(cand_r, dim=1).cpu().numpy()
    out_s, out_r = [], []
    for s, r in zip(scores, rows):
        order = np.lexsort((r, -s))[:k]
        out_s.append(s[order])
        out_r.append(r[order])
    return np.stack(out_s), np.stack(out_r)


def check_against_f64(got_rows, got_scores, want_scores, want_rows, what: str) -> tuple[int, int]:
    """Device rows against the f64 evaluation, query by query. Entries whose
    f64 scores lie within 1e-6 of the next form a group: a group of equal
    scores (spread under 1e-9: exact duplicates) must come out as the f64
    order has it, lowest row first; a group the f32 product cannot order
    (spread 1e-9 to 1e-6) is held as a set, unless k cuts it. Returns (tie
    groups, near-tie groups)."""
    import numpy as np

    ties = near = 0
    for qi, (g, gs, ws, wr) in enumerate(zip(got_rows, got_scores, want_scores, want_rows)):
        err = float(np.abs(gs - ws).max())
        check(err <= 1e-5, f"{what} query {qi}: scores off the f64 ones by {err:.2e}")
        lo = 0
        while lo < len(wr):
            hi = lo + 1
            while hi < len(wr) and ws[hi - 1] - ws[hi] < 1e-6:
                hi += 1
            spread = ws[lo] - ws[hi - 1]
            if hi - lo == 1 or spread < 1e-9:
                ties += hi - lo > 1
                check(list(g[lo:hi]) == list(wr[lo:hi]), f"{what} query {qi}: rows {list(g)} != f64 {list(wr)}")
            else:
                near += 1
                check(hi == len(wr) or set(g[lo:hi]) == set(wr[lo:hi]), f"{what} query {qi}: near-tie set differs")
            lo = hi
    return ties, near


def _profiled_busy(fn, wall_ms: float, runs: int = 5) -> str:
    """Device time a call of ``fn`` by ``torch.profiler`` (the sum of its
    kernels), beside ``wall_ms``, the CUDA-event time of a call: their
    difference is the device's idle share, the host's enqueue time."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            synchronize()
        events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    except Exception as exc:  # noqa: BLE001 - a diagnostic: say why it is missing
        return f"not measured ({type(exc).__name__}: {exc})"
    busy = sum(e.self_device_time_total for e in events) / runs / 1e3
    if busy <= 0:
        return "not measured (the profiler recorded no device time)"
    kernels = sum(e.count for e in events) / runs
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
    return (f"{busy:.3f} ms of kernels a call ({kernels:.0f} device ops), idle share "
            f"{max(0.0, 1 - busy / wall_ms):.3f} of the {wall_ms:.3f} ms; most time in "
            + "; ".join(f"{e.key[:60]} {e.self_device_time_total / runs / 1e3:.3f} ms" for e in top))


def ann_phase(work: Path, lib: Path, labels: Path) -> tuple[int, int]:
    """The ANN slice on the card: the CLIP ViT-B/32 @ 224 embed forward,
    an index run with ``index.enabled`` (fused embed lane) over the library,
    flat search at 1M x 512 against an f64 evaluation, IVF at 1M, HNSW at
    20 000, and ``ket ann`` through the CLI. Returns the attention launches
    of the index run through the packed and the separate q, k, v entries
    (the fast ViT tagger runs kernel 1 beside the embedder)."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.core.config.schema import IndexSettings, PipelineSettings, Settings, TaggerSettings
    from kobato_eyes_tpu_torch.core.config.service import save_settings
    from kobato_eyes_tpu_torch.core.pipeline import IndexPipeline, run_index_once
    from kobato_eyes_tpu_torch.core.pipeline.embed_stage import load_embeddings
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.index import embedder as emb_mod
    from kobato_eyes_tpu_torch.index.flat import FlatIndex, _search_kernel, find_similar, topk_rows
    from kobato_eyes_tpu_torch.index.hnsw import HnswIndex
    from kobato_eyes_tpu_torch.index.ivf import IvfFlatIndex, _ivf_search_kernel, recall_at_k
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.models.vit import vit_forward_flops
    from kobato_eyes_tpu_torch.ops import attention
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array
    from kobato_eyes_tpu_torch.utils.metrics import metrics
    from kobato_eyes_tpu_torch.utils.paths import get_app_paths

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on: the exact index needs IEEE f32")
    t_phase = time.perf_counter()

    # 1. the embed forward: CLIP ViT-B/32 @ 224 (random weights, seed 0) on
    # the 448 px letterbox pooled 2x2, batch 32, pixels resident
    emb = emb_mod.ImageEmbedder(derive_from=448, device=DEVICE)
    files = sorted(lib.iterdir())
    batch = torch.from_numpy(emb.prepare_batch_from_rgb([load_rgb_array(p) for p in files[:BATCH]])).to(DEVICE)
    ms = cuda_ms(lambda: emb.dispatch_batch_prepared(batch), iters=5)
    cfg = emb.cfg
    flops = vit_forward_flops(cfg, BATCH, with_head=False) + 2.0 * BATCH * cfg.hidden_dim * emb.embed_dim
    print(f"ann embed forward clip-vit-b32-224 (hidden {cfg.hidden_dim}, depth {cfg.depth}, patch "
          f"{cfg.patch_size}, {emb.embed_dim}-d, derived from 448) batch {BATCH}: {ms:.3f} ms "
          f"(CUDA events, warm, mean of 5), {flops / 1e9:.1f} GFLOP, MFU {flops / (ms * 1e-3) / BF16_FLOPS_PER_S:.4f} "
          f"against {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16 ({flops / BF16_FLOPS_PER_S * 1e3:.3f} ms at peak)")
    print(f"ann embed forward, device busy by torch.profiler: {_profiled_busy(lambda: emb.dispatch_batch_prepared(batch), ms)}")

    # 2. an index run with index.enabled over the library, fused lane on:
    # the embedder must read the tagger's device tensor (one upload a batch)
    data = work / "data_ann"
    paths = get_app_paths(data).ensure()
    settings = Settings(
        pipeline=PipelineSettings(roots=[lib], batch_size=BATCH, inline_signatures=False),
        tagger=TaggerSettings(name="wd14", labels_path=labels),
        index=IndexSettings(enabled=True),
    )
    cfg_path = work / "settings_ann.yaml"
    save_settings(settings, cfg_path)
    tagger = WD14Tagger(labels_path=labels, device=DEVICE)
    seen: dict[str, list] = {"embed": [], "tag": []}

    def spy(obj, key):
        orig = obj.dispatch_batch_prepared

        def record(pixels, *a, **kw):
            seen[key].append(pixels)
            return orig(pixels, *a, **kw)
        return record

    real_build = IndexPipeline._build_embedder

    def build_spied(self):
        built = real_build(self)
        built.dispatch_batch_prepared = spy(built, "embed")
        return built

    tagger.dispatch_batch_prepared = spy(tagger, "tag")
    IndexPipeline._build_embedder = build_spied
    attention.launches = attention.launches_separate = 0
    try:
        t0 = time.perf_counter()
        stats = run_index_once(paths.db_path, settings, tagger).__dict__
        wall = time.perf_counter() - t0
    finally:
        IndexPipeline._build_embedder = real_build
    launches, separate = attention.launches, attention.launches_separate
    extra = stats["extra"]
    print_index_stats("ann vit-b448 + clip", stats, wall, f"attention_launches={launches} separate_qkv={separate} "
                      f"embedded_fused={extra.get('embedded_fused')} embedded={extra.get('embedded')}")
    walls_ann = extra["stage_walls"]
    print(f"ann index run: embedder setup wall {walls_ann.get('embed_setup')} s (seeded init of the CLIP "
          f"tower, upload, the prep check), residual embed stage wall {walls_ann.get('embed')} s, "
          f"{stats['tagged'] / stats['elapsed_sec']:.2f} images/s with the embed lane, "
          f"{stats['tagged'] / (stats['elapsed_sec'] - walls_ann.get('embed_setup', 0.0)):.2f} without its setup")
    check(extra.get("embedded_fused") == N_IMAGES and extra.get("embedded") == N_IMAGES,
          f"fused embeddings {extra.get('embedded_fused')} / {extra.get('embedded')} != {N_IMAGES}: "
          f"a fused batch was downgraded")
    check(launches == 12 * (N_IMAGES // BATCH), f"attention launches {launches} in the ANN index run")
    n_batches = N_IMAGES // BATCH
    check(len(seen["embed"]) == len(seen["tag"]) == n_batches, f"dispatches {len(seen['embed'])} / {len(seen['tag'])}")
    check(all(isinstance(e, torch.Tensor) and e.device.type == DEVICE and e is g
              for e, g in zip(seen["embed"], seen["tag"])),
          "the embedder did not read the tagger's device tensor (a second upload)")
    print(f"ann fused lane: {n_batches} batches, each one device tensor read by the embedder and the tagger")
    del seen, tagger

    conn = bootstrap(paths.db_path)
    try:
        ids, vecs = load_embeddings(conn)
        by_id = {int(r["id"]): r["path"] for r in conn.execute("SELECT id, path FROM files")}
    finally:
        conn.close()
    check(vecs.shape == (N_IMAGES, 512) and bool(np.isfinite(vecs).all()), f"stored vectors {vecs.shape}")
    want = np.concatenate([emb.embed_batch([load_rgb_array(by_id[int(i)]) for i in ids[s:s + BATCH]])
                           for s in range(0, len(ids), BATCH)])
    cos = np.sum(vecs * want, axis=1) / (np.linalg.norm(vecs, axis=1) * np.linalg.norm(want, axis=1))
    print(f"ann stored vectors vs the standalone embedder: least cosine {cos.min():.6f} over {len(ids)} files; "
          f"norms {np.linalg.norm(vecs, axis=1).min():.6f}..{np.linalg.norm(vecs, axis=1).max():.6f}")
    check(cos.min() >= 0.999, f"stored vectors vs standalone: cosine {cos.min()}")

    # 3. flat at 1M x 512: a seeded clustered corpus made on the card, with
    # ANN_PLANTED rows copied four times each; half the queries are those rows
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    centers = torch.randn(ANN_CLUSTERS, ANN_DIM, generator=gen, device=DEVICE)
    member = torch.randint(0, ANN_CLUSTERS, (ANN_N,), generator=gen, device=DEVICE)
    corpus = centers[member] + 0.35 * torch.randn(ANN_N, ANN_DIM, generator=gen, device=DEVICE)
    rng = np.random.default_rng(6)
    sources = rng.choice(ANN_N, size=ANN_PLANTED, replace=False)
    targets = rng.choice(np.setdiff1d(np.arange(ANN_N), sources), size=4 * ANN_PLANTED, replace=False)
    corpus[torch.from_numpy(targets).to(DEVICE)] = corpus[torch.from_numpy(np.repeat(sources, 4)).to(DEVICE)]
    queries = torch.cat([corpus[torch.from_numpy(sources).to(DEVICE)],
                         centers[torch.randint(0, ANN_CLUSTERS, (ANN_QUERIES - ANN_PLANTED,), generator=gen,
                                               device=DEVICE)]
                         + 0.35 * torch.randn(ANN_QUERIES - ANN_PLANTED, ANN_DIM, generator=gen, device=DEVICE)])
    vecs_np, q_np = corpus.cpu().numpy(), queries.cpu().numpy()
    del corpus, centers, member, queries
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    flat = FlatIndex(vecs_np, device=DEVICE)
    synchronize()
    flat_build = time.perf_counter() - t0
    flat_bytes = torch.cuda.memory_allocated() - base_bytes
    scores, rows = flat.search(q_np, k=ANN_K)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        flat.search(q_np, k=ANN_K)
        walls.append((time.perf_counter() - t0) * 1e3)
    qn = q_np / np.linalg.norm(q_np, axis=1, keepdims=True)
    q_dev = torch.from_numpy(qn).to(DEVICE)
    with torch.inference_mode():
        dev_ms = cuda_ms(lambda: _search_kernel(q_dev, flat._corpus_t, k=ANN_K), iters=20)
        mm_ms = cuda_ms(lambda: torch.matmul(q_dev, flat._corpus_t), iters=20)
        sims = torch.matmul(q_dev, flat._corpus_t)
        topk_ms = cuda_ms(lambda: topk_rows(sims, ANN_K), iters=20)
        del sims
        want_s, want_r = _f64_topk(flat._corpus_t.t(), q_dev, ANN_K)
    ties, near = check_against_f64(rows, scores, want_s, want_r, "flat 1M")
    t_bytes = ANN_N * ANN_DIM * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * ANN_QUERIES * ANN_DIM * ANN_N / F32_FLOPS_PER_S * 1e3
    print(f"ann flat {ANN_N}x{ANN_DIM} f32: build {flat_build:.3f} s (host normalize + upload), resident "
          f"{flat_bytes / 1e9:.3f} GB; search of {ANN_QUERIES} queries k={ANN_K}: host p50 {np.median(walls):.3f} ms "
          f"(min {min(walls):.3f}, max {max(walls):.3f}); device {dev_ms:.4f} ms (matmul {mm_ms:.4f}, tie-ordered "
          f"top-k {topk_ms:.4f}); bound {max(t_bytes, t_ops):.4f} ms "
          f"(bytes {t_bytes:.4f}, f32 operations {t_ops:.4f}); ids equal the f64 evaluation, {ties} exact-tie "
          f"groups lowest row first, {near} near-tie groups held as sets")
    check(ties >= ANN_PLANTED, f"only {ties} tie groups among {ANN_PLANTED} planted duplicate queries")
    exact_rows = rows
    del flat, q_dev
    torch.cuda.empty_cache()

    # 4. IVF at 1M: 1000 clusters, 10 Lloyd steps, nprobe 8, against flat
    timers = ("ivf.upload", "ivf.train", "ivf.lists")
    before = {n: metrics.percentiles(n)["total"] for n in timers}
    t0 = time.perf_counter()
    ivf = IvfFlatIndex(vecs_np, n_clusters=ANN_CLUSTERS, train_iters=IVF_ITERS, device=DEVICE)
    synchronize()
    ivf_build = time.perf_counter() - t0
    split = {n: metrics.percentiles(n)["total"] - before[n] for n in timers}
    ivf_bytes = torch.cuda.memory_allocated() - base_bytes
    _, ivf_ids = ivf.search(q_np, k=ANN_K, nprobe=IVF_NPROBE)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        ivf.search(q_np, k=ANN_K, nprobe=IVF_NPROBE)
        walls.append((time.perf_counter() - t0) * 1e3)
    q_dev = torch.from_numpy(qn).to(DEVICE)
    with torch.inference_mode():
        ivf_ms = cuda_ms(lambda: _ivf_search_kernel(q_dev, ivf._centroids, ivf._assign_list, ivf._corpus,
                                                    nprobe=IVF_NPROBE, k=ANN_K), iters=20)
    recall = recall_at_k(ivf_ids, exact_rows, k=ANN_K)
    print(f"ann ivf {ANN_N}x{ANN_DIM}, {ANN_CLUSTERS} clusters ({ivf.n_lists} lists), {IVF_ITERS} Lloyd steps: "
          f"build {ivf_build:.3f} s = upload {split['ivf.upload']:.3f} + Lloyd steps {split['ivf.train']:.3f} "
          f"+ list assembly {split['ivf.lists']:.3f} + host normalize and rest "
          f"{ivf_build - sum(split.values()):.3f}; resident {ivf_bytes / 1e9:.3f} GB; search nprobe {IVF_NPROBE}: "
          f"host p50 {np.median(walls):.3f} ms (min {min(walls):.3f}), device {ivf_ms:.4f} ms; "
          f"recall@{ANN_K} against flat {recall:.4f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    check(recall >= 0.9, f"ivf recall@10 {recall} < 0.9")
    del ivf, q_dev
    torch.cuda.empty_cache()

    # 5. HNSW at 20 000 x 512 on the host, against flat on the same rows
    sub = vecs_np[:HNSW_N]
    _, sub_exact = FlatIndex(sub, device=DEVICE).search(q_np, k=ANN_K)
    t0 = time.perf_counter()
    graph = HnswIndex(dim=ANN_DIM)
    graph.add(sub)
    hnsw_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, hnsw_ids = graph.search(q_np, k=ANN_K)
    hnsw_ms = (time.perf_counter() - t0) * 1e3
    recall = recall_at_k(hnsw_ids, sub_exact, k=ANN_K)
    print(f"ann hnsw {HNSW_N}x{ANN_DIM} (host C++, M 16, ef_construction 200): build {hnsw_build:.3f} s; "
          f"search of {ANN_QUERIES} queries (ef 64) {hnsw_ms:.3f} ms; recall@{ANN_K} against flat {recall:.4f}")
    check(recall >= 0.9, f"hnsw recall@10 {recall} < 0.9")
    del graph, vecs_np, sub

    # 6. ket ann through the CLI on the index run's catalog
    base = ["--config", str(cfg_path), "--data-dir", str(data), "--device", DEVICE]
    flat = FlatIndex(vecs, ids, device=DEVICE)
    for fid in (int(ids[0]), int(ids[len(ids) // 2]), int(ids[-1])):
        lines = [line for line in run_cli(base + ["ann", "--similar-to", str(fid), "--limit", "5"]).splitlines() if line]
        want = [f"{score:8.4f}  {by_id[f]}" for f, score in
                find_similar(flat, vecs[list(ids).index(fid)], exclude_id=fid, k=5)]
        check(lines == want, f"ann --similar-to {fid}: {lines} != find_similar {want}")
    print("ann cli: --similar-to equals find_similar over load_embeddings for 3 files")
    out = run_cli(base + ["ann", "--build"]).strip().splitlines()
    check(out[-1].startswith(f"built ANN index (HnswIndex) over {N_IMAGES} images"), f"ann --build: {out[-1]}")
    probe = files[7]
    lines = [line for line in run_cli(base + ["ann", "--query-image", str(probe), "--limit", "5"]).splitlines() if line]
    check(len(lines) == 5 and lines[0].split(None, 1)[1] == str(probe), f"ann --query-image {probe}: {lines}")
    print(f"ann cli: --build then --query-image {probe.name}: the file first at {lines[0].split()[0]}")
    print(f"ann phase {time.perf_counter() - t_phase:.1f} s")
    return launches, separate


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not (REPO / "kobato_eyes_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the kobato_eyes_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])

    t_start = time.perf_counter()
    build_kernels()
    attn, attn_separate = attention_phase()
    window = window_attention_phase()
    ln = layernorm_residual_phase()
    hamming = pairwise_hamming_phase()
    kernels = [attn, attn_separate, window, ln, hamming]
    work_root = REPO / "build"
    work_root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=work_root))
    try:
        lib, labels, cfg = write_workspace(work)
        attn["launches"], sep_vit = slice_phase(work, lib, labels, cfg)
        window["launches"], sep_swin, ln["launches"] = swin_phase(work, lib, labels, cfg)
        query_cli_phase(work, lib, labels, cfg)
        hamming["launches"] = dup_scan_phase()
        dup_cli_phase(work)
        query_parity_phase(work)
        query_scale_phase()
        ann_launches, sep_ann = ann_phase(work, lib, labels)
        check(ann_launches == attn["launches"], "attention launches of the ANN index run")
        attn_separate["launches"] = sep_vit + sep_swin + sep_ann
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
