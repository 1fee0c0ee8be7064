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
  --similar-to``, ``--build`` and ``--query-image`` through the CLI;
* upkeep: ``import-weights`` of the ViT run's weights from a
  ``.safetensors`` and an ``.onnx`` file (constant-folded names among its
  initializers) and ``inspect``; ``index`` with ``tagger.model_path`` naming
  the checkpoint, whose catalog must equal the ViT run's; a SwinV2-B/448
  checkpoint against the tagger holding its weights; the ``bf16_params``
  forward beside the f32-weight one; ``refresh``, ``retag``, the watcher
  (batch-of-one tag jobs on worker threads) and the host commands against
  SQL, ``reset`` last;
* GELU: the erf and tanh pass (bf16 and f32) and its gradient against
  their plain versions, in bf16 through the tables (``"lut"``) on all 65 536
  bf16 inputs and at ViT-B/448's and SwinV2-B/448's MLP shapes, timed beside
  the ``"vec"`` body and ``F.gelu``, and both taggers' forwards with the
  pass, the ``"vec"`` body, the plain sequence and ``F.gelu``;
* training: ``train`` through the CLI on the ViT run's catalog (ViT-B/16 @
  448, batch 16, one epoch), the checkpoint in ``TorchTagger`` and an
  ``index`` from it, the step's time and MFU;
* flash attention (``attn_impl="flash"``): the forward, dK/dV and dQ
  kernels (bf16 through both bodies, ``"wgmma"`` and ``"fma"``) against
  their plain versions at ViT-B/448 (bf16 and f32) and on
  strided and misaligned views at D = 48 / 32, each timed beside SDPA's
  forward or backward; the ViT-B/448 forward at batch 32 with the flash
  path beside the einsum forward; 3 flash train steps at batch 16 beside
  the einsum step and an f32 step's gradients;
* serving: the port's server in this process on the 20 000-file, the dup
  and the ANN catalogs: ``/search`` against SQL, ``/dup?audit=1`` against
  ``dup --audit``, ``/similar`` against ``find_similar``, ``/delta``,
  ``/reload``, ``/trash``, ``/file``, ``/thumb``;
* the sigmoid: the XLA-rounded pass of ``probs_from_logits`` against its
  plain version on every f32 input (2^32), at the tagger's (32, 8192)
  logits and at (1024, 8192), timed in turns with ``torch.sigmoid``;
* the measuring entry points, as a user runs them: ``python -m
  kobato_eyes_tpu_torch.bench`` (the dup headline at 70 000 hashes) in its
  own process, then ``tools/``'s ``bench_tagger`` (ViT-B/448, the fast
  forward; a small run under ``--profile``, whose trace ``trace_ops`` reads
  kernel 1 from), ``mfu_probe`` (einsum and SDPA), ``bench_swin`` (the
  window kernel, and the residual LayerNorm kernel), ``bench_query`` at
  70 000 files, ``bench_ann`` at 100 000 x 512 and ``bench_e2e`` at 500
  images, each in this process through its ``main``, printing its JSON line
  (where a size is cut from the tool's default, the line before says which
  and why), with exact kernel launches;
* multi-device, on a mesh of four entries (the cards when there are
  several, else ``cuda:0`` four times): the ViT-B/448 tagger at data=4 and
  at data=2, model=2, the ViT-B/448 train step at data=2, model=2 (3
  steps at batch 16), the sharded dup scan at 70k, the sharded query at
  20 000 files, flat and IVF search at 100k x 512, each against the
  single-device path; then ``dryrun_multichip`` over the four entries.

Kernels 3 and 5 run shorter than the host takes to enqueue a call, so their
times are taken through CUDA graphs. Each kernel's launch count is set to 0
just before the path that runs it and read just after; the attention
wrapper counts its packed and its separate-q, k, v entries apart, and the
latter's count is summed over the ViT, SwinV2, ANN and upkeep runs; the
upkeep steps' and the fine-tuned index run's kernel-1 launches and the
upkeep steps' window launches are added to those kernels'; the GELU count
sums the ViT and SwinV2 index runs, the training and the fine-tuned index
run; kernel 5's adds the server's ``/dup?audit=1``; the multi-device
tagger forwards add to kernel 1's and the GELU pass's, the sharded train
steps and the dry run to both GELU passes'; the sigmoid's sums the ViT and
SwinV2 index runs, the multi-device forwards and the dry run; the flash
forward's the flash ViT forward and train steps, the flash backward
kernels' the train steps; the bench phase's add to kernels 1, 3 and 4, the
GELU pass and the sigmoid pass. It
checks each tagger's fast forward against its exact forward, and prints one JSON line of kernel numbers, then
``{"ok": true, "device": {...}}`` as the last line. Any failed phase exits
non-zero before the last line. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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


def ptxas_registers(source: str) -> dict[str, int]:
    """Registers a thread of each kernel of ``csrc/<source>``, from its
    build log (``-Xptxas -v``), by mangled name."""
    import re

    from kobato_eyes_tpu_torch.ops import build

    log = build.library_path(source).with_suffix(".log")
    regs, name = {}, None
    for line in log.read_text(encoding="utf-8").splitlines() if log.exists() else []:
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            name = hit.group(1)
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name is not None:
            regs[name] = int(hit.group(1))
            name = None
    return regs


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


def tiny_fast_math() -> None:
    """The tiny preset with four heads (192 / 4 = 48 wide, as the dry run's
    infer check builds it) at 448 px with ``fast_math`` on ``cuda``: kernel
    1 at D = 48 inside the tagger's forward, against the exact forward from
    the same weights, max |dp| <= 0.02."""
    import numpy as np

    from kobato_eyes_tpu_torch.models.labels import synthetic_labels
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.models.vit import vit_config
    from kobato_eyes_tpu_torch.ops import attention as attn

    labels = synthetic_labels(N_LABELS)
    cfg = vit_config("tiny", image_size=448, num_classes=N_LABELS, num_heads=4)
    fast = WD14Tagger(labels=labels, vit=cfg, device="cuda")
    exact = WD14Tagger(labels=labels, vit=cfg, device="cuda", fast_math=False, params=fast._model.state_dict())
    check(fast.cfg.attn_impl == "pallas" and fast.cfg.hidden_dim // fast.cfg.num_heads == 48,
          "tiny preset: fast_math at head width 48")
    rng = np.random.default_rng(9)
    batch = fast.prepare_batch_from_rgb([rng.integers(0, 256, size=(448, 448, 3), dtype=np.uint8)
                                         for _ in range(8)])
    before = attn.launches
    p_fast = fast.forward_probs(batch).float()
    launched = attn.launches - before
    p_exact = exact.forward_probs(batch).float()
    dp = float((p_fast - p_exact).abs().max())
    print(f"tiny preset fast_math (D 48) on cuda: {launched} kernel-1 launches, max |dp| {dp:.3e} (tol 0.02)")
    check(launched == fast.cfg.depth, f"tiny fast_math: {launched} kernel-1 launches, not {fast.cfg.depth}")
    check(dp <= 0.02, f"tiny fast_math: max |dp| {dp} against the exact forward")
    del fast, exact


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

    def ulp(x: float) -> float:  # one bf16 ulp of |x| (8 significant bits)
        return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)

    def compare(name, qkv, scale, tol, packed=True, exact=False):
        """max |kernel - plain| <= tol. With ``exact`` (bf16), also no
        further from the f64 plain version than twice the bf16 plain version
        is, plus one bf16 ulp of the largest output (tol stays the outer
        limit)."""
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
        if exact and qkv.dtype == torch.bfloat16:
            q64, k64, v64 = qkv.double().unbind(dim=2)
            w64 = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q64 * scale, k64), dim=-1)
            ref = torch.einsum("bhqk,bkhd->bqhd", w64, v64)
            k_err = float((got.double() - ref).abs().max())
            p_err = float((want.double() - ref).abs().max())
            bar = 2 * p_err + ulp(float(ref.abs().max()))
            print(f"attention {name}: max |kernel - f64| {k_err:.3e}, max |bf16 plain - f64| {p_err:.3e} "
                  f"(bar {bar:.3e})")
            check(k_err <= bar, f"{name}: max |kernel - f64| {k_err} > {bar}")
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
    # every head width has a body: bf16 widths round up to the wgmma depth
    # of 16 (16 as one 16-column block, 48 three, 80 five, 96 three of 32,
    # 112 seven of 16, 128 two of 64), f32 ones pad to 32, 64 or 128; a
    # scale that is no power of two; held beside the f64 plain version too
    for hd in (16, 48, 80, 96, 112, 128):
        for t_len in (37, 129, 785):
            compare(f"bf16 T={t_len} D={hd}", qkv_of((2, t_len, 3, 3, hd), torch.bfloat16, 400 + hd + t_len),
                    hd**-0.5, 3e-2, exact=True)
        compare(f"f32 T=129 D={hd}", qkv_of((2, 129, 3, 3, hd), torch.float32, 500 + hd), hd**-0.5, 2e-5)
    # D = 36 from a view of a 40-wide projection (aligned: the last 16-byte
    # chunk of each row is read half and zero-filled, and written half)
    wide = qkv_of((2, 129, 3, 4, 40), torch.bfloat16, 600)
    compare("bf16 T=129 D=36 narrow view", wide[..., :36], 36**-0.5, 3e-2, exact=True)
    compare("bf16 T=785 D=20", qkv_of((2, 785, 3, 3, 24), torch.bfloat16, 602)[..., :20], 20**-0.5, 3e-2,
            exact=True)
    compare("f32 T=37 D=20", qkv_of((2, 37, 3, 3, 20), torch.float32, 601), 20**-0.5, 2e-5)
    tiny_fast_math()
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
    # batch 1, the watcher's and the tag job's shape: 7 q tiles x 12 heads,
    # 84 blocks on the card's SMs; timed through a CUDA graph (the kernel is
    # shorter than the host's enqueue)
    one = qkv_of((1, t, 3, h, d), torch.bfloat16, 7)
    err_b1 = compare("vit-b448 bf16 B=1", one, scale, 3e-2)
    q1, k1, v1 = (x.transpose(1, 2) for x in one.unbind(dim=2))
    b1_ms = cuda_graph_ms([lambda: attn.head_resident_attention_packed(one, scale=scale)] * 8)
    b1_plain = cuda_graph_ms([lambda: attn.head_resident_attention_packed_plain(one, scale=scale)] * 4)
    b1_sdpa = cuda_graph_ms([lambda: torch.nn.functional.scaled_dot_product_attention(q1, k1, v1, scale=scale)] * 8)
    b1_ops = flops / b / BF16_FLOPS_PER_S * 1e3
    b1_bytes = bytes_moved / b / HBM_BYTES_PER_S * 1e3
    print(
        f"attention vit-b448 bf16 B=1 (CUDA graph): kernel {b1_ms:.4f} ms, plain {b1_plain:.4f} ms, "
        f"sdpa {b1_sdpa:.4f} ms, bound {max(b1_ops, b1_bytes):.4f} ms "
        f"({'operations' if b1_ops >= b1_bytes else 'bytes'}: {flops / b / 1e9:.2f} GFLOP, "
        f"{bytes_moved / b / 1e6:.2f} MB), max_abs_err {err_b1:.3e}, "
        f"grid {-(-t // 128)} q tiles x {h} heads = {-(-t // 128) * h} blocks of 128 rows on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs"
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
    from kobato_eyes_tpu_torch.ops import xla_math

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # XLA's CPU rsqrt on the card (the estimate table read from this host's
    # rsqrtps, xla_rsqrt.cuh, which both window bodies include): the CUDA
    # pass bit for bit against the plain version on 2^24 random f32 bit
    # patterns and every binade's edges, specials included
    gen = torch.Generator(device=dev).manual_seed(31)
    bits = torch.randint(-2**31, 2**31, (1 << 24,), generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
    edges = torch.tensor([0, 1, 2, 8191, 8192, 1 << 22, (1 << 23) - 1], dtype=torch.int32, device=dev)
    exps = torch.arange(256, dtype=torch.int32, device=dev) << 23
    binades = (exps[:, None] | edges[None]).flatten()
    bits = torch.cat([bits, binades, binades | (-2**31)])
    x = bits.view(torch.float32)
    got, want = xla_math.xla_rsqrt_f32(x), xla_math.rsqrt_plain(x)
    apart = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    print(f"xla rsqrt on the card: {apart} of {x.numel()} f32 inputs apart from the plain version "
          f"(estimate table from the host's rsqrtps)")
    check(apart == 0, f"xla rsqrt: {apart} inputs apart")
    del bits, x, got, want

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


# GELU shapes: the MLP activation of ViT-B/448 at batch 32 (32 x 785 tokens x
# 3072) and of SwinV2-B/448's four stages (tokens x 4C)
VIT_GELU = (BATCH * 785, 3072)
SWIN_GELU = tuple((BATCH * (112 >> s) ** 2, 512 << s) for s in range(4))
# f32 operations an element by the path it takes (a fused multiply-add counts
# two, exp / tanh / a division one each): erf |z| < 1, erf |z| >= 1, tanh;
# the gradient's are erfc's and 12 more (erf), 22 (tanh)
GELU_OPS = {"erf_small": 20, "erf_big": 46, "tanh": 12, "erf_small_bwd": 32, "erf_big_bwd": 58, "tanh_bwd": 22}


def gelu_phase() -> tuple[dict, dict]:
    """The GELU pass and its backward pass (erf and tanh forms, bf16 and f32)
    against their plain versions: first the bf16 tables (built once per form
    and direction, not counted as launches) and the ``"lut"`` bodies on all
    65 536 bf16 inputs, against the ``"vec"`` body that built the tables and
    against the plain version (the gradient with three seeded g), 0
    elements apart; then at ViT-B/448's, the train step's and SwinV2-B/448's
    MLP shapes (bf16 through ``"lut"``, 0 elements apart; f32 through
    ``"vec"``, bounded); the scalar body on views off alignment, ragged
    tails and special values; times of the kernel, the ``"vec"`` body in
    bf16, the plain sequence and ``F.gelu`` at each shape, and of the
    backward kernel, its ``"vec"`` body, its plain sequence and
    ``aten.gelu_backward`` at the train step's; then the ViT-B/448 and
    SwinV2-B/448 forwards at batch 32 with the kernel, with the ``"vec"``
    body, with the plain op-by-op sequence and with ``F.gelu`` in its place.
    Returns the two kernels' entries: the forward's (the tanh form at the
    ViT-B/448 shape, the form of the index runs' fast forward) and the
    backward's (the erf form in bf16 at the train step's shape, which
    training runs)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from kobato_eyes_tpu_torch.models import vit as vit_mod
    from kobato_eyes_tpu_torch.models.labels import synthetic_labels
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.ops import gelu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(shape, dtype):
        return (torch.randn(shape, generator=gen, device=dev) * 3).to(dtype)

    def plain(x, approximate):
        return gelu.gelu_tanh_plain(x) if approximate else gelu.gelu_erf_plain(x)

    def plain_backward(x, g, approximate):
        backward = gelu.gelu_tanh_backward_plain if approximate else gelu.gelu_erf_backward_plain
        return backward(x, g)

    def compare(name, x, approximate, expect, g=None):
        """The forward kernel, or with ``g`` the backward kernel, against its
        plain version: the count of differing elements, printed and bounded."""
        ran = gelu.kernel_variant(x, x) if g is None else gelu.kernel_variant(x, g, x)
        check(ran == expect, f"gelu {name}: runs {ran}, expected {expect}")
        if g is None:
            got, want = gelu.gelu_forward(x, approximate=approximate), plain(x, approximate)
        else:
            got = gelu.gelu_backward(x, g, approximate=approximate)
            want = plain_backward(x, g, approximate)
        torch.cuda.synchronize()
        check(got.dtype == x.dtype and got.shape == x.shape, f"gelu {name}: dtype/shape")
        check(bool(torch.isfinite(got).all()), f"gelu {name}: non-finite output")
        gf, w = got.float(), want.float()
        n_diff = int((gf != w).sum())
        err = float((gf - w).abs().max())
        # the plain version's fused multiply-adds go through f64 and round
        # twice: one in ~1e9 can sit one f32 step off, which a later step
        # can carry to a few f32 steps of the input's magnitude (1 + tanh
        # cancels; in the gradient, terms up to |g| (1 + |x|)^3 cancel) or
        # the bf16 rounding to one bf16 step
        step = 2.0**-7 if x.dtype == torch.bfloat16 else 2.0**-21
        xa = x.float().abs()
        scale = torch.maximum(xa, w.abs()) if g is None else w.abs() + g.float().abs() * (1 + xa) ** 3
        within = bool(((gf - w).abs() <= step * scale).all())
        # bf16 results are a function of the bf16 inputs that the tables
        # hold exactly (the all-inputs check above): none may differ
        bound = 0 if x.dtype == torch.bfloat16 else 4 + x.numel() // 10**6
        tol = "one bf16 step each" if x.dtype == torch.bfloat16 else "2^-21 of the terms' magnitude each"
        print(f"gelu{'' if g is None else ' backward'} {name} [{ran}]: {n_diff} of {x.numel()} elements differ "
              f"from the plain version (bound {bound}, {tol}), max_abs_err={err:.3e}")
        check(n_diff <= bound and within, f"gelu {name}: {n_diff} elements differ (bound {bound}) or not within {tol}")
        return err

    def apart(got, want):
        """Elements whose bits differ (NaN to NaN is equal, -0 to +0 is not)."""
        same = (got.view(torch.int16) == want.view(torch.int16)) | (torch.isnan(got) & torch.isnan(want))
        return int((~same).sum())

    # the tables: built here, before any CUDA-graph capture, and not launches
    builds, launched = gelu.table_builds, (gelu.launches, gelu.backward_launches)
    gelu.prepare_tables(dev)
    check((gelu.launches, gelu.backward_launches) == launched, "gelu: building the tables counted launches")
    print(f"gelu tables: {gelu.table_builds - builds} built (forward and gradient, erf and tanh), "
          f"windows {gelu.LUT_WINDOW} (biased bf16 exponents of |x|)")
    # the "lut" bodies on every bf16 input, against the "vec" body (whose
    # functions built the tables) and the plain version; the gradient with
    # g from three seeds. The card's tables beside the ones the plain
    # version gives on the host (informative: they differ only where the
    # host's exp / tanh round apart from the card's)
    every = torch.arange(65536, dtype=torch.int32, device=dev)
    every = ((every + 0x8000) % 0x10000 - 0x8000).to(torch.int16).view(torch.bfloat16)
    for approximate in (True, False):
        form = "tanh" if approximate else "erf"
        check(gelu.kernel_variant(every, every) == "lut", "gelu: all-inputs tensor does not run lut")
        lut = gelu.gelu_forward(every, approximate=approximate)
        body = gelu.gelu_forward(every, approximate=approximate, variant="vec")
        n_body, n_plain = apart(lut, body), apart(lut, plain(every, approximate))
        host_tables = [int(((gelu.lut_table(dev, form, backward=b).long().cpu()
                             ^ gelu.gelu_table_plain(form, backward=b).long()) & (0xFFFFFFFF if b else 0xFFFF))
                           .ne(0).sum()) for b in (False, True)]
        print(f"gelu {form} lut, all 65536 bf16 inputs: {n_body} apart from the vec body, {n_plain} from the "
              f"plain version; table entries apart from the host's plain version: forward {host_tables[0]}, "
              f"gradient {host_tables[1]}")
        check(n_body == 0 and n_plain == 0, f"gelu {form} lut differs on all bf16 inputs: {n_body} / {n_plain}")
        for seed in range(3):
            g = torch.from_numpy(np.random.default_rng(seed).normal(size=65536).astype(np.float32)).to(dev)
            g = g.to(torch.bfloat16)
            lut = gelu.gelu_backward(every, g, approximate=approximate)
            body = gelu.gelu_backward(every, g, approximate=approximate, variant="vec")
            n_body, n_plain = apart(lut, body), apart(lut, plain_backward(every, g, approximate))
            print(f"gelu backward {form} lut, all 65536 bf16 inputs, g of seed {seed}: {n_body} apart from "
                  f"the vec body, {n_plain} from the plain version")
            check(n_body == 0 and n_plain == 0,
                  f"gelu backward {form} lut differs on all bf16 inputs (seed {seed}): {n_body} / {n_plain}")

    errs, bwd_errs = {}, {}
    for shape in (VIT_GELU, TRAIN_GELU) + SWIN_GELU:
        for dtype in (torch.bfloat16, torch.float32):
            x = inputs(shape, dtype)
            g = inputs(shape, dtype)
            body = "lut" if dtype == torch.bfloat16 else "vec"
            for approximate in (True, False):
                form = "tanh" if approximate else "erf"
                name = f"{form} {shape} {str(dtype).split('.')[-1]}"
                if shape != TRAIN_GELU:
                    errs[(shape, dtype, approximate)] = compare(name, x, approximate, body)
                bwd_errs[(shape, dtype, approximate)] = compare(name, x, approximate, body, g)
            del x, g
    # the scalar body and the vec body's tail: a view 2 bytes off a 16-byte
    # boundary, element counts that leave a partial last chunk
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        for approximate in (True, False):
            form = "tanh" if approximate else "erf"
            base, gbase = inputs(1 << 20, dtype), inputs(1 << 20, dtype)
            off, goff = base[1:].view(1023, 1025), gbase[1:].view(1023, 1025)  # start one element in
            check(gelu.kernel_variant(off, off) == "scalar", "gelu: misaligned view runs vec")
            compare(f"{form} misaligned view {dt}", off, approximate, "scalar")
            compare(f"{form} misaligned view {dt}", off, approximate, "scalar", goff)
            compare(f"{form} misaligned gradient {dt}", base[:-1].view(1023, 1025), approximate, "scalar", goff)
            body = "lut" if dtype == torch.bfloat16 else "vec"
            for n in (123_457, 1001, 7):
                x, g = inputs(n, dtype), inputs(n, dtype)
                compare(f"{form} {n} elements {dt}", x, approximate, body)
                compare(f"{form} {n} elements {dt}", x, approximate, body, g)
    special = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, -13.25, 30.0, -30.0, 1e30, -1e30,
                            float("inf"), float("-inf"), float("nan")], device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        for approximate in (True, False):
            s = special.to(dtype)
            ones = torch.ones_like(s)
            for kind, got, want in (
                ("forward", gelu.gelu_forward(s, approximate=approximate), plain(s, approximate)),
                ("backward", gelu.gelu_backward(s, ones, approximate=approximate), plain_backward(s, ones, approximate)),
            ):
                got, want = got.float(), want.float()
                same = bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())
                check(same, f"gelu {kind} special values {dtype} approximate={approximate}: {got} != {want}")
    print("gelu forward and backward special values (0, -0, +-1, +-2, -13.25, +-30, +-1e30, +-inf, nan): "
          "equal to the plain version")

    def kernel_readings(fns_of):
        """The kernel's time for each form, read three times in the order
        tanh, erf, erf, tanh, tanh, erf: {approximate: [readings]}. The
        first readings at a shape can run slow for a while (on an H100 up to
        1.16x, for whichever form came first), though the two forms' "lut"
        forwards are one machine code and read alike in turns."""
        readings = {True: [], False: []}
        for approximate in (True, False, False, True, True, False):
            readings[approximate].append(cuda_graph_ms(fns_of(approximate)))
        return readings

    # times at each shape: kernel (bf16: "lut"; the least of its readings),
    # the "vec" body in bf16 and F.gelu through a CUDA graph over
    # input sets that together exceed the L2 several times, the plain
    # sequence call by call
    rows = {}
    for shape in (VIT_GELU,) + SWIN_GELU:
        for dtype in (torch.bfloat16, torch.float32):
            n = shape[0] * shape[1]
            bytes_moved = 2 * n * torch.tensor([], dtype=dtype).element_size()
            sets = [inputs(shape, dtype) for _ in range(max(2, min(8, -(-400_000_000 // bytes_moved))))]
            readings = kernel_readings(
                lambda ap: [lambda a=a: gelu.gelu_forward(a, approximate=ap) for a in sets] * 2)
            for approximate in (True, False):
                form = "tanh" if approximate else "erf"
                ms = min(readings[approximate])
                body = ""
                if dtype == torch.bfloat16:
                    body_ms = cuda_graph_ms(
                        [lambda a=a: gelu.gelu_forward(a, approximate=approximate, variant="vec") for a in sets] * 2)
                    body = f"vec body {body_ms:.4f} ms, "
                lib_ms = cuda_graph_ms([lambda a=a: F.gelu(a, approximate=form if approximate else "none")
                                        for a in sets] * 2)
                plain_ms = cuda_ms(lambda: plain(sets[0], approximate), iters=2, warmup=1)
                if approximate:
                    ops = GELU_OPS["tanh"] * n
                else:
                    small = int(((sets[0].float().abs() * 0.7071067811865476) < 1).sum())
                    ops = GELU_OPS["erf_small"] * small + GELU_OPS["erf_big"] * (n - small)
                t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
                t_ops = ops / F32_FLOPS_PER_S * 1e3
                bound = max(t_bytes, t_ops)
                print(f"gelu {form} {shape} {str(dtype).split('.')[-1]}: kernel [{gelu.kernel_variant(sets[0])}] "
                      f"{ms:.4f} ms (readings {' / '.join(f'{r:.4f}' for r in readings[approximate])}; "
                      f"{ms / bound:.2f}x the bound, {bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s), "
                      f"{body}F.gelu {lib_ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound:.4f} ms "
                      f"({'bytes' if t_bytes >= t_ops else 'operations'}: {bytes_moved / 1e6:.1f} MB, "
                      f"{ops / 1e9:.2f} GFLOP)")
                rows[(shape, dtype, approximate)] = (ms, plain_ms, lib_ms, t_ops, t_bytes)
            del sets

    # the backward's times at the train step's shape: the kernel, the plain
    # sequence and torch's own gelu_backward (one rounding), as above
    bwd_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        n = TRAIN_GELU[0] * TRAIN_GELU[1]
        bytes_moved = 3 * n * torch.tensor([], dtype=dtype).element_size()
        sets = [(inputs(TRAIN_GELU, dtype), inputs(TRAIN_GELU, dtype))
                for _ in range(max(2, min(8, -(-400_000_000 // bytes_moved))))]
        readings = kernel_readings(
            lambda ap: [lambda a=a, b=b: gelu.gelu_backward(a, b, approximate=ap) for a, b in sets] * 2)
        for approximate in (True, False):
            form = "tanh" if approximate else "erf"
            ms = min(readings[approximate])
            body = ""
            if dtype == torch.bfloat16:
                body_ms = cuda_graph_ms([lambda a=a, b=b: gelu.gelu_backward(a, b, approximate=approximate,
                                                                             variant="vec") for a, b in sets] * 2)
                body = f"vec body {body_ms:.4f} ms, "
            lib_ms = cuda_graph_ms([lambda a=a, b=b: torch.ops.aten.gelu_backward(
                b, a, approximate=form if approximate else "none") for a, b in sets] * 2)
            plain_ms = cuda_ms(lambda: plain_backward(*sets[0], approximate), iters=2, warmup=1)
            if approximate:
                ops = GELU_OPS["tanh_bwd"] * n
            else:
                small = int(((sets[0][0].float().abs() * 0.7071067811865476) < 1).sum())
                ops = GELU_OPS["erf_small_bwd"] * small + GELU_OPS["erf_big_bwd"] * (n - small)
            t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_FLOPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            print(f"gelu backward {form} {TRAIN_GELU} {str(dtype).split('.')[-1]}: kernel "
                  f"[{gelu.kernel_variant(*sets[0])}] {ms:.4f} ms (readings "
                  f"{' / '.join(f'{r:.4f}' for r in readings[approximate])}; {ms / bound:.2f}x the bound, "
                  f"{bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s), {body}"
                  f"aten.gelu_backward {lib_ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound:.4f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'}: {bytes_moved / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} GFLOP)")
            bwd_rows[(dtype, approximate)] = (ms, plain_ms, lib_ms, t_ops, t_bytes)
        del sets

    # the forwards at batch 32: the kernel (this tree), its "vec" body in
    # bf16 (the pass before the tables), the plain op-by-op sequence in its
    # place, and F.gelu in its place
    labels = synthetic_labels(N_LABELS)
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, size=(448, 448, 3), dtype=np.uint8) for _ in range(4)]
    variants = {
        "kernel": gelu.gelu,
        "vec body": lambda x, approximate=False: gelu.gelu_forward(
            x, approximate=approximate, variant="vec" if gelu.kernel_variant(x) == "lut" else None),
        "plain": lambda x, approximate=False: plain(x, approximate),
        "F.gelu": lambda x, approximate=False: F.gelu(x, approximate="tanh" if approximate else "none"),
    }
    kernel_fn = vit_mod.gelu
    for arch in ("vit", "swinv2"):
        fast = WD14Tagger(arch=arch, labels=labels, device="cuda")
        exact = WD14Tagger(arch=arch, labels=labels, device="cuda", fast_math=False,
                           params=fast._model.state_dict())
        b32 = np.concatenate([fast.prepare_batch_from_rgb(imgs)] * (BATCH // len(imgs)))
        line = []
        try:
            for name, fn in variants.items():
                vit_mod.gelu = fn
                for kind, tagger in (("fast", fast), ("exact", exact)):
                    ms = cuda_ms(lambda: tagger.forward_probs(b32), iters=5 if name == "kernel" else 3)
                    line.append(f"{kind} with {name} {ms:.2f} ms")
        finally:
            vit_mod.gelu = kernel_fn
        print(f"{arch}-b448 batch-{BATCH} forward_probs: " + ", ".join(line))
        del fast, exact

    def entry(name, row, err):
        ms, plain_ms, lib_ms, t_ops, t_bytes = row
        return {
            "name": name,
            "route": "cuda",
            "source": "kobato_eyes_tpu_torch/csrc/gelu.cu",
            "replaces": "kobato_eyes_tpu/models/vit.py:225",
            "launches": None,  # filled from the main paths' runs
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": lib_ms,
        }

    return (entry("gelu", rows[(VIT_GELU, torch.bfloat16, True)], max(errs.values())),
            entry("gelu_backward", bwd_rows[(torch.bfloat16, False)], max(bwd_errs.values())))


# ---------------------------------------------------------------------------
# Flash attention (attn_impl="flash"): the forward and its two backward kernels
# ---------------------------------------------------------------------------

FLASH_READINGS = 3  # readings of each kernel and of its library call, in turns


def _flash_products(b: int, t: int, h: int, d: int, n: int) -> float:
    """FLOPs of ``n`` (T x T x D) products over B x H heads."""
    return 2.0 * n * t * t * d * b * h


def flash_attention_phase() -> tuple[dict, dict, dict]:
    """The flash forward, dK/dV and dQ kernels against their plain versions:
    at ViT-B/448 (T 785, H 12, D 64) the forward at B = 32 and B = 1 and the
    forward and backward at the train step's B = 16, in bf16 and f32; D = 48
    and D = 32 at T = 37 and 129 from packed strided views of a larger
    projection (the bf16 backward's ``"wgmma"``), from views whose head
    stride is not a multiple of 8 and from views one element off alignment
    (the ``"fma"`` bodies, which read one element at a time); D = 8 and
    every multiple of 16 up to 128 at T = 37 and 129 packed (bf16 also at T = 785, B = 1, the
    forward alone), where each bf16 call that chooses ``"wgmma"`` holds the ``"fma"`` bodies too
    (the forward's and the backward's), and the backward is fed the chosen forward's ``o``, ``m``
    and ``l``. f32: ``o`` within 2e-5, ``m`` and
    ``l`` within 1e-6 of the largest, each gradient within 1e-5 of its
    largest. bf16: ``o`` and each gradient no further from the f64 plain
    version than twice the bf16 plain version is, plus one bf16 ulp of the
    largest value. Then each kernel's time through a CUDA graph, the least
    of three readings taken in turns with SDPA's forward or its backward
    through autograd (each kernel's two bodies and SDPA's call in turns, with
    TFLOP/s and the forward bodies' registers), beside the bound and the
    plain version's time. Returns the three kernels' entries (each the
    ``"wgmma"`` body's)."""
    import torch
    import torch.nn.functional as F

    from kobato_eyes_tpu_torch.ops import flash_attention as fa
    from kobato_eyes_tpu_torch.tools.trace_ops import short_kernel_name

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain version in IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(12)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ulp(x: float) -> float:  # one bf16 ulp of |x| (8 significant bits)
        return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)

    def held(name, got, plain, exact):
        """bf16: max |kernel - f64| <= 2 max |bf16 plain - f64| + one ulp."""
        k_err = float((got.double() - exact).abs().max())
        p_err = float((plain.double() - exact).abs().max())
        bar = 2 * p_err + ulp(float(exact.abs().max()))
        print(f"flash {name}: max |kernel - f64| {k_err:.3e}, max |bf16 plain - f64| {p_err:.3e} (bar {bar:.3e})")
        check(k_err <= bar, f"flash {name}: {k_err} > {bar}")
        return k_err

    def close(name, got, want, rel):
        """f32: max |kernel - plain| <= rel * max |plain|."""
        err = float((got - want).abs().max())
        bar = rel * float(want.abs().max())
        print(f"flash {name}: max |kernel - plain| {err:.3e} (bar {bar:.3e})")
        check(err <= bar, f"flash {name}: {err} > {bar}")
        return err

    def hold(name, qkv, scale, backward, expect=None):
        """The kernels on ``qkv`` against the plain versions; returns the
        forward's error and (with ``backward``) each gradient's through the
        bodies the wrappers choose (``expect``, where given, for both), which
        ``flash_forward`` and ``flash_backward`` run; the backward is fed
        the chosen forward's o, m and l. A bf16 call that chooses
        ``"wgmma"`` holds the ``"fma"`` bodies at the same inputs too."""
        b, t, _, h, d = qkv.shape
        q, k, v = qkv.unbind(dim=2)
        chosen = fa.forward_variant(qkv.dtype, d, aligned=fa.aligned_for_wgmma(q, k, v))
        check(expect is None or chosen == expect, f"flash {name}: the forward chose {chosen}, not {expect}")
        po, pm, pl = fa.flash_forward_plain(q, k, v, scale)
        bf16 = qkv.dtype == torch.bfloat16
        if bf16:
            q64, k64, v64 = (x.double() for x in (q, k, v))
            eo, em, el = fa.flash_forward_plain(q64, k64, v64, scale)
        errs = []
        for body in [chosen] + (["fma"] if chosen == "wgmma" else []):
            before = dict(fa.forward_variant_launches)
            got = fa.flash_forward(qkv, scale, variant=None if body == chosen else body)
            torch.cuda.synchronize()
            check(fa.forward_variant_launches[body] == before[body] + 1, f"flash {name}: the forward did not run {body}")
            tag = f"{name} {str(qkv.dtype).split('.')[-1]} (B {b}, T {t}, H {h}, D {d}) [fwd {body}]"
            fo, fm, fl = got
            check(fo.dtype == qkv.dtype and fo.shape == (b, t, h, d) and fm.shape == fl.shape == (b, h, t),
                  f"flash {tag}: dtype/shape")
            check(bool(torch.isfinite(fo).all() & torch.isfinite(fm).all() & torch.isfinite(fl).all()),
                  f"flash {tag}: non-finite output")
            close(f"{tag} m", fm, pm, 1e-6)
            close(f"{tag} l", fl, pl, 1e-6)
            if bf16:
                err = held(f"{tag} o", fo, po, eo)
            else:
                err = float((fo - po).abs().max())
                print(f"flash {tag} o: max |kernel - plain| {err:.3e} (tol 2e-5)")
                check(err <= 2e-5, f"flash {tag} o: {err} > 2e-5")
            if body == chosen:
                errs.append(err)
                o, m, l = got
        tag = f"{name} {str(qkv.dtype).split('.')[-1]} (B {b}, T {t}, H {h}, D {d})"
        if backward:
            # dO laid out as qkv's heads are (a narrow view of a wider row where qkv is one)
            do = randn((b, t, h, qkv.stride(-2)), qkv.dtype)[..., :d]
            ran = fa.backward_variant(qkv.dtype, d, aligned=fa.aligned_for_wgmma(q, k, v, do))
            check(expect is None or ran == expect, f"flash {tag}: the backward chose {ran}, not {expect}")
            if bf16:
                plain = fa.flash_backward_plain(q, k, v, po, pm, pl, do, scale)
                exact = fa.flash_backward_plain(q64, k64, v64, eo, em, el, do.double(), scale)
            else:
                plain = fa.flash_backward_plain(q, k, v, o, m, l, do, scale)
            for body in [ran] + (["fma"] if ran == "wgmma" else []):
                before = dict(fa.backward_variant_launches)
                if body == ran:  # the public entry, which chooses
                    grad = fa.flash_backward(qkv, o, m, l, do, scale)
                else:
                    grad = torch.empty_like(qkv)
                    di = fa.row_dot(o, do)
                    fa.flash_backward_dkv(qkv, do, m, l, di, grad, scale, variant=body)
                    fa.flash_backward_dq(qkv, do, m, l, di, grad, scale, variant=body)
                torch.cuda.synchronize()
                check(all(fa.backward_variant_launches[key, body] == before[key, body] + 1 for key in ("dkv", "dq")),
                      f"flash {tag}: the backward did not run {body}")
                btag = f"{tag} backward [{body}]"
                check(bool(torch.isfinite(grad).all()), f"flash {btag}: non-finite gradient")
                if bf16:
                    got = [held(f"{btag} d{x}", grad[:, :, i], plain[i], exact[i]) for i, x in enumerate("qkv")]
                else:
                    got = [close(f"{btag} d{x}", grad[:, :, i], plain[i], 1e-5) for i, x in enumerate("qkv")]
                if body == ran:
                    errs += got
        return errs

    b, t, h, d = VIT_B448["batch"], VIT_B448["tokens"], VIT_B448["heads"], VIT_B448["head_dim"]
    tb = TRAIN_BATCH
    scale = d**-0.5
    main = {dt: randn((b, t, 3, h, d), dt) for dt in (torch.bfloat16, torch.float32)}
    one = {dt: randn((1, t, 3, h, d), dt) for dt in (torch.bfloat16, torch.float32)}
    train = {dt: randn((tb, t, 3, h, d), dt) for dt in (torch.bfloat16, torch.float32)}
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        body = "wgmma" if dt == torch.bfloat16 else "fma"
        errs[("fwd", dt)] = hold("vit-b448", main[dt], scale, backward=False)[0]
        hold("vit-b448", one[dt], scale, backward=False)
        errs[("train", dt)] = hold("vit-b448 train", train[dt], scale, backward=True, expect=body)
        # every D16 of the wgmma bodies (64-, 32- and 16-column blocks: 48 is
        # three of 16, 80 five, 96 three of 32, 112 seven of 16, 128 two of
        # 64; above 64 a 2-stage ring and one block an SM) and 8, zero-padded
        # to 16, around the 64-row tiles
        for hd in (8, 16, 32, 48, 64, 80, 96, 112, 128):
            for t_len in (37, 129):
                hold("packed", randn((2, t_len, 3, 4, hd), dt), hd**-0.5, backward=True, expect=body)
        # D = 36 and 20 from views of 40- and 24-wide projections: aligned, so
        # bf16 takes "wgmma" with the last 16-byte chunk of each row read half
        # and zero-filled
        hold("narrow aligned view", randn((2, 129, 3, 4, 40), dt)[..., :36], 36**-0.5, backward=True, expect=body)
        hold("narrow aligned view", randn((2, 129, 3, 4, 24), dt)[..., :20], 20**-0.5, backward=True, expect=body)
        if dt == torch.bfloat16:  # the forward bodies at every D16 at T = 785 (13 key tiles, the last of 17 keys)
            for hd in (8, 16, 32, 48, 64, 80, 96, 112, 128):
                hold("packed", randn((1, t, 3, 4, hd), dt), hd**-0.5, backward=False, expect=body)
    for dt in (torch.bfloat16, torch.float32):
        for hd in (48, 32):
            for t_len in (37, 129):
                big = randn((3, t_len + 7, 3, 4, hd), dt)  # a strided slice: batch and token strides of the big one
                hold("strided slice", big[1:, 3:3 + t_len], hd**-0.5, backward=True,
                     expect="wgmma" if dt == torch.bfloat16 else "fma")
                wide = randn((2, t_len, 3, 4, hd + 4), dt)  # head stride hd + 4: not a multiple of 8
                hold("narrow view", wide[..., :hd], hd**-0.5, backward=True, expect="fma")
                n = 2 * t_len * 3 * 2 * hd
                flat = randn((n + 1,), dt)  # one element off: 2 (bf16) or 4 (f32) bytes off 16-byte alignment
                view = flat[1:].view(2, t_len, 3, 2, hd)
                check(view.data_ptr() % 16 != 0, "flash: the misaligned view is aligned")
                hold("misaligned view", view, hd**-0.5, backward=True, expect="fma")
    # the f32 kernels once each (the same bodies; the bound is the f32 rate's)
    f32_qkv = train[torch.float32]
    o, m, l = fa.flash_forward(f32_qkv, scale)
    do = randn(o.shape, torch.float32)
    di, grad = fa.row_dot(o, do), torch.empty_like(f32_qkv)
    f32_ms = (cuda_graph_ms([lambda: fa.flash_forward(main[torch.float32], scale)] * 2),
              cuda_graph_ms([lambda: fa.flash_backward_dkv(f32_qkv, do, m, l, di, grad, scale)] * 2),
              cuda_graph_ms([lambda: fa.flash_backward_dq(f32_qkv, do, m, l, di, grad, scale)] * 2))
    del main[torch.float32], one[torch.float32], train[torch.float32], f32_qkv, o, m, l, do, di, grad

    # times: each kernel, then its library call, in turns
    def sdpa_inputs(qkv, grad):
        return [x.transpose(1, 2).detach().requires_grad_(grad) for x in qkv.unbind(dim=2)]  # (B, H, T, D)

    q32, k32, v32 = sdpa_inputs(main[torch.bfloat16], False)
    q1, k1, v1 = sdpa_inputs(one[torch.bfloat16], False)
    qkv16 = train[torch.bfloat16]
    o16, m16, l16 = fa.flash_forward(qkv16, scale)
    do16 = randn(o16.shape, torch.bfloat16)
    di16 = fa.row_dot(o16, do16)
    grad16 = torch.empty_like(qkv16)
    sq, sk, sv = sdpa_inputs(qkv16, True)
    sdo = do16.transpose(1, 2)

    def sdpa_both():
        # forward and backward in one capture: autograd runs a backward on
        # its forward's stream, so the forward is captured too
        return torch.autograd.grad(F.scaled_dot_product_attention(sq, sk, sv, scale=scale), (sq, sk, sv), sdo)

    readings = {key: [] for key in ("fwd32", "fwd32_fma", "sdpa32", "fwd1", "fwd1_fma", "sdpa1", "fwd16",
                                    "fwd16_fma", "sdpa16", "dkv", "dq", "dkv_fma", "dq_fma", "sdpa_both")}
    for _ in range(FLASH_READINGS):
        for body, suffix in (("wgmma", ""), ("fma", "_fma")):
            readings["fwd32" + suffix].append(cuda_graph_ms(
                [lambda: fa.flash_forward(main[torch.bfloat16], scale, variant=body)] * 2))
        readings["sdpa32"].append(cuda_graph_ms(
            [lambda: F.scaled_dot_product_attention(q32, k32, v32, scale=scale)] * 8))
        for body, suffix in (("wgmma", ""), ("fma", "_fma")):
            readings["fwd1" + suffix].append(cuda_graph_ms(
                [lambda: fa.flash_forward(one[torch.bfloat16], scale, variant=body)] * 8))
        readings["sdpa1"].append(cuda_graph_ms(
            [lambda: F.scaled_dot_product_attention(q1, k1, v1, scale=scale)] * 8))
        for body, suffix in (("wgmma", ""), ("fma", "_fma")):
            readings["fwd16" + suffix].append(cuda_graph_ms(
                [lambda: fa.flash_forward(qkv16, scale, variant=body)] * 2))
        readings["sdpa16"].append(cuda_graph_ms(
            [lambda: F.scaled_dot_product_attention(sq, sk, sv, scale=scale)] * 8))
        for body, suffix in (("wgmma", ""), ("fma", "_fma")):
            readings["dkv" + suffix].append(cuda_graph_ms(
                [lambda: fa.flash_backward_dkv(qkv16, do16, m16, l16, di16, grad16, scale, variant=body)] * 2))
            readings["dq" + suffix].append(cuda_graph_ms(
                [lambda: fa.flash_backward_dq(qkv16, do16, m16, l16, di16, grad16, scale, variant=body)] * 2))
        readings["sdpa_both"].append(cuda_graph_ms([sdpa_both] * 4))
    best = {key: min(v) for key, v in readings.items()}
    # SDPA's backward: its forward and backward less its forward, least against least
    best["sdpa_bwd"] = best["sdpa_both"] - best["sdpa16"]
    plain_fwd32 = cuda_ms(lambda: fa.flash_forward_plain(*main[torch.bfloat16].unbind(dim=2), scale),
                          iters=2, warmup=1)
    plain_fwd1 = cuda_graph_ms([lambda: fa.flash_forward_plain(*one[torch.bfloat16].unbind(dim=2), scale)] * 2)
    plain_bwd = cuda_ms(lambda: fa.flash_backward_plain(*qkv16.unbind(dim=2), o16, m16, l16, do16, scale),
                        iters=2, warmup=1)

    elt = 2  # bf16 bytes
    fwd_flops = {bb: _flash_products(bb, t, h, d, 2) for bb in (b, 1, tb)}

    def bound(flops, bytes_moved, rate=BF16_FLOPS_PER_S):
        t_ops, t_bytes = flops / rate * 1e3, bytes_moved / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    def fwd_bytes(bb):  # qkv read, o written, m and l (f32) written
        return bb * t * h * (4 * d * elt + 2 * 4)

    bwd_in = tb * t * h * (4 * d * elt + 3 * 4)  # q, k, v, dO, and m, l, di (f32)
    lines = []
    regs = ptxas_registers("flash_attention.cu")
    for key, bb, lib in (("fwd32", b, "sdpa32"), ("fwd1", 1, "sdpa1"), ("fwd16", tb, "sdpa16")):
        bms, by = bound(fwd_flops[bb], fwd_bytes(bb))
        for body, suffix in (("wgmma", ""), ("fma", "_fma")):
            k_ms = best[key + suffix]
            lines.append(f"bf16 forward [{body}] B={bb}: kernel {k_ms:.4f} ms (readings "
                         f"{' / '.join(f'{r:.4f}' for r in readings[key + suffix])}), sdpa {best[lib]:.4f} ms "
                         f"({k_ms / best[lib]:.2f}x sdpa), bound {bms:.4f} ms ({by}: {fwd_flops[bb] / 1e9:.1f} GFLOP, "
                         f"{fwd_bytes(bb) / 1e6:.1f} MB), {fwd_flops[bb] / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    lines.append("forward registers: " + ", ".join(
        f"{short_kernel_name(name)} {n}" for name, n in regs.items() if "flash_fwd" in name or "attn_wgmma" in name))
    dkv_bound, dkv_by = bound(_flash_products(tb, t, h, d, 4), bwd_in + tb * t * h * 2 * d * elt)
    dq_bound, dq_by = bound(_flash_products(tb, t, h, d, 3), bwd_in + tb * t * h * d * elt)
    five, seven = (_flash_products(tb, t, h, d, n) for n in (5, 7))
    four, three = _flash_products(tb, t, h, d, 4), _flash_products(tb, t, h, d, 3)

    def rate(flops, key):
        return f"{flops / (best[key] * 1e-3) / 1e12:.1f} TFLOP/s"

    for body, suffix in (("wgmma", ""), ("fma", "_fma")):
        lines.append(f"bf16 backward [{body}] B={tb} readings: dK/dV "
                     f"{' / '.join(f'{r:.4f}' for r in readings['dkv' + suffix])} ms, dQ "
                     f"{' / '.join(f'{r:.4f}' for r in readings['dq' + suffix])} ms; least {best['dkv' + suffix]:.4f} "
                     f"({rate(four, 'dkv' + suffix)}) + {best['dq' + suffix]:.4f} ({rate(three, 'dq' + suffix)}) = "
                     f"{best['dkv' + suffix] + best['dq' + suffix]:.4f} ms, "
                     f"{(best['dkv' + suffix] + best['dq' + suffix]) / best['sdpa_bwd']:.2f}x sdpa's backward")
    lines.append(f"bf16 backward B={tb}: dK/dV kernel {best['dkv']:.4f} ms (bound {dkv_bound:.4f} ms, 4 products), "
                 f"dQ kernel {best['dq']:.4f} ms (bound {dq_bound:.4f} ms, 3 products), together "
                 f"{best['dkv'] + best['dq']:.4f} ms; sdpa backward {best['sdpa_bwd']:.4f} ms (forward and backward "
                 f"{' / '.join(f'{r:.4f}' for r in readings['sdpa_both'])} less the forward); bound of the backward "
                 f"{five / BF16_FLOPS_PER_S * 1e3:.4f} ms (five products, {five / 1e9:.1f} GFLOP), "
                 f"{seven / BF16_FLOPS_PER_S * 1e3:.4f} ms as these kernels split it (seven, {seven / 1e9:.1f} GFLOP)")
    lines.append(f"bf16 plain: forward B={b} {plain_fwd32:.4f} ms, B=1 {plain_fwd1:.4f} ms, backward B={tb} "
                 f"{plain_bwd:.4f} ms")
    lines.append(f"f32 kernels (one reading each): forward B={b} {f32_ms[0]:.4f} ms (bound "
                 f"{fwd_flops[b] / F32_FLOPS_PER_S * 1e3:.4f} ms at 67 TFLOP/s), dK/dV B={tb} {f32_ms[1]:.4f} ms "
                 f"(bound {_flash_products(tb, t, h, d, 4) / F32_FLOPS_PER_S * 1e3:.4f}), dQ {f32_ms[2]:.4f} ms "
                 f"(bound {_flash_products(tb, t, h, d, 3) / F32_FLOPS_PER_S * 1e3:.4f})")
    for line in lines:
        print(f"flash attention {line}")
    print(f"flash attention phase {time.perf_counter() - t0:.1f} s")

    def entry(name, replaces, err, ms, plain_ms, bms, by, lib):
        return {
            "name": name,
            "route": "cuda",
            "source": "kobato_eyes_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"kobato_eyes_tpu/models/vit.py:122 (jax/experimental/pallas/ops/tpu/{replaces})",
            "launches": None,  # filled from the whole script's runs
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": lib,
        }

    train_errs = errs[("train", torch.bfloat16)]
    fwd_bound, fwd_by = bound(fwd_flops[b], fwd_bytes(b))
    return (
        entry("flash_forward", "flash_attention.py:758", errs[("fwd", torch.bfloat16)], best["fwd32"],
              plain_fwd32, fwd_bound, fwd_by, best["sdpa32"]),
        entry("flash_backward_dkv", "flash_attention.py:1121", max(train_errs[2:]), best["dkv"], plain_bwd,
              dkv_bound, dkv_by, best["sdpa_bwd"]),
        entry("flash_backward_dq", "flash_attention.py:1456", train_errs[1], best["dq"], plain_bwd,
              dq_bound, dq_by, best["sdpa_bwd"]),
    )


def flash_vit_phase() -> int:
    """The ViT-B/448 forward at batch 32 with ``attn_impl="flash"`` beside the
    exact (einsum) forward on the same seeded weights and normalised images:
    probabilities within 3e-2, 12 flash forward launches, every one the
    ``"wgmma"`` body, and no kernel-1 launch. Returns the flash forward
    launches."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.models.vit import ViT, init_vit_, vit_config
    from kobato_eyes_tpu_torch.ops import attention
    from kobato_eyes_tpu_torch.ops import flash_attention as fa

    cfg = vit_config("base", image_size=448, num_classes=N_LABELS, attn_impl="flash")
    flash = init_vit_(ViT(cfg), torch.Generator().manual_seed(3)).to(DEVICE).eval().requires_grad_(False)
    exact = ViT(vit_config("base", image_size=448, num_classes=N_LABELS))
    exact.load_state_dict(flash.state_dict())
    exact = exact.to(DEVICE).eval().requires_grad_(False)
    size = cfg.image_size
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(BATCH, size, size, 3)).astype(np.float32)).to(DEVICE)
    with torch.no_grad():
        fa.launches = attention.launches = attention.launches_separate = 0
        fa.forward_variant_launches = dict.fromkeys(fa.forward_variant_launches, 0)
        probs = torch.sigmoid(flash(x).float())
        torch.cuda.synchronize()
        launches, kernel1 = fa.launches, attention.launches + attention.launches_separate
        bodies = dict(fa.forward_variant_launches)
        want = torch.sigmoid(exact(x).float())
        err = float((probs - want).abs().max())
        flash_ms = cuda_ms(lambda: flash(x), iters=3, warmup=1)
        exact_ms = cuda_ms(lambda: exact(x), iters=3, warmup=1)
    print(f"flash vit-b448 batch {BATCH} forward: probabilities max |flash - einsum| {err:.3e} (tol 3e-2); "
          f"flash forward launches {launches} (bodies {bodies}), kernel-1 launches {kernel1}; {flash_ms:.2f} ms, "
          f"einsum {exact_ms:.2f} ms (CUDA events, warm, mean of 3)")
    check(bool(torch.isfinite(probs).all()) and tuple(probs.shape) == (BATCH, N_LABELS), "flash vit: probabilities")
    check(err <= 3e-2, f"flash vit: probabilities {err} apart from the einsum forward")
    check(launches == cfg.depth and kernel1 == 0, f"flash vit: {launches} flash, {kernel1} kernel-1 launches")
    check(bodies == {"wgmma": cfg.depth, "fma": 0}, f"flash vit: forward bodies {bodies}, not {cfg.depth} \"wgmma\"")
    del flash, exact, x
    torch.cuda.empty_cache()
    return launches


SIGMOID_LOGITS = (BATCH, N_LABELS)  # the tagger's logits a batch
SIGMOID_SWEEP = 1 << 32  # every f32 bit pattern
SIGMOID_CHUNK = 1 << 27
SIGMOID_BIG = (1024, N_LABELS)  # 67 MB moved: past the launch, past the 50 MB L2
SIGMOID_READINGS = 5


def sigmoid_phase() -> dict:
    """The XLA-rounded sigmoid pass (``ops/xla_math.py``) against its plain
    version on every f32 input (2^32 bit patterns, in chunks), and its exp
    on every binade; then at the tagger's (32, 8192) logits and at (1024,
    8192), 0 elements apart, read through CUDA graphs in turns with
    ``torch.sigmoid`` (five readings each), beside the byte bound."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.ops import xla_math as xm

    dev = torch.device(DEVICE)
    apart = {"vec": 0, "scalar": 0}
    t0 = time.perf_counter()
    for start in range(0, SIGMOID_SWEEP, SIGMOID_CHUNK):
        bits = torch.arange(start, min(start + SIGMOID_CHUNK, SIGMOID_SWEEP), dtype=torch.int64, device=dev)
        x = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(torch.float32)
        want = xm.sigmoid_plain(x).view(torch.int32)
        for variant in ("vec", "scalar"):
            apart[variant] += int((xm.xla_sigmoid_f32(x, variant=variant).view(torch.int32) != want).sum())
        del bits, x, want
    synchronize()
    sweep_s = time.perf_counter() - t0
    print(f"xla sigmoid: every f32 input ({SIGMOID_SWEEP} bit patterns) against the plain version, through the "
          f"vec and the scalar body: {apart['vec']} / {apart['scalar']} apart ({sweep_s:.1f} s)")
    check(apart == {"vec": 0, "scalar": 0}, f"xla sigmoid: inputs differ from the plain version: {apart}")

    rng = np.random.default_rng(21)
    mant = np.concatenate([np.array([0, 1, (1 << 22), (1 << 23) - 1], np.uint32),
                           rng.integers(0, 1 << 23, size=4096).astype(np.uint32)])
    pats = [(np.uint32(s << 31) | np.uint32(e << 23) | mant) for s in (0, 1) for e in range(256)]
    x = torch.from_numpy(np.concatenate(pats).view(np.float32)).to(dev)
    exp_apart = sum(int((xm.xla_exp_f32(x, variant=v).view(torch.int32) != xm.exp_plain(x).view(torch.int32)).sum())
                    for v in ("vec", "scalar"))
    print(f"xla exp: {x.numel()} inputs over every f32 binade of both signs, both bodies: {exp_apart} apart")
    check(exp_apart == 0, f"xla exp: {exp_apart} inputs differ from the plain version")

    sets = [torch.from_numpy((np.random.default_rng(22 + i).normal(size=SIGMOID_LOGITS) * 4).astype(np.float32)).to(dev)
            for i in range(4)]
    apart = max(int((xm.xla_sigmoid_f32(t).view(torch.int32) != xm.sigmoid_plain(t).view(torch.int32)).sum())
                for t in sets)
    err = max(float((xm.xla_sigmoid_f32(t) - xm.sigmoid_plain(t)).abs().max()) for t in sets)
    check(apart == 0, f"xla sigmoid at {SIGMOID_LOGITS}: {apart} elements apart")
    plain_ms = cuda_ms(lambda: xm.sigmoid_plain(sets[0]), iters=20)
    big = [torch.from_numpy((np.random.default_rng(26 + i).normal(size=SIGMOID_BIG) * 4).astype(np.float32)).to(dev)
           for i in range(2)]
    check(torch.equal(xm.xla_sigmoid_f32(big[0]).view(torch.int32), xm.sigmoid_plain(big[0]).view(torch.int32)),
          f"xla sigmoid at {SIGMOID_BIG}: elements apart")
    readings = {}
    for shape, fns_of in ((SIGMOID_LOGITS, lambda f: [lambda t=sets[i % 4]: f(t) for i in range(64)]),
                          (SIGMOID_BIG, lambda f: [lambda t=big[i % 2]: f(t) for i in range(8)])):
        # the kernel (the body its size picks), the other body and torch.sigmoid in turns, five times each
        n = shape[0] * shape[1]
        props = torch.cuda.get_device_properties(dev)
        chosen = "scalar" if n <= props.multi_processor_count * props.max_threads_per_multi_processor else "vec"
        other = {"vec": "scalar", "scalar": "vec"}[chosen]
        kern, alt, lib = [], [], []
        for _ in range(SIGMOID_READINGS):
            kern.append(cuda_graph_ms(fns_of(xm.xla_sigmoid_f32), replays=20))
            alt.append(cuda_graph_ms(fns_of(lambda t: xm.xla_sigmoid_f32(t, variant=other)), replays=20))
            lib.append(cuda_graph_ms(fns_of(torch.sigmoid), replays=20))
        t_bytes, t_ops = 2 * n * 4 / HBM_BYTES_PER_S * 1e3, 40.0 * n / F32_FLOPS_PER_S * 1e3  # ~40 f32 operations an element
        bound = max(t_bytes, t_ops)
        readings[shape] = (min(kern), min(lib), bound, "bytes" if t_bytes >= t_ops else "operations")
        us = lambda ts: " ".join(f"{t * 1e3:.3f}" for t in ts)  # noqa: E731
        print(f"xla sigmoid {shape} f32 through CUDA graphs, in turns (us): kernel ({chosen} body) {us(kern)}; "
              f"{other} body {us(alt)}; torch.sigmoid {us(lib)}; least {min(kern) * 1e3:.3f} / {min(alt) * 1e3:.3f} / "
              f"{min(lib) * 1e3:.3f}, the kernel {min(kern) / min(lib):.3f}x torch.sigmoid; bound {bound * 1e3:.3f} us "
              f"({2 * n * 4 / 1e6:.2f} MB moved), the kernel at {bound / min(kern):.1%} of it")
    ms, lib_ms, bound, bound_by = readings[SIGMOID_LOGITS]
    rule = (all(k <= 1.05 * t for k, t, _, _ in readings.values())
            and readings[SIGMOID_BIG][2] >= 0.5 * readings[SIGMOID_BIG][0])
    print(f"xla sigmoid: within 5% of torch.sigmoid at both shapes and at >= 50% of its bound at {SIGMOID_BIG}: "
          f"{'yes' if rule else 'no'}; plain {plain_ms:.4f} ms at {SIGMOID_LOGITS}")
    del big
    return {
        "name": "xla_sigmoid",
        "route": "cuda",
        "source": "kobato_eyes_tpu_torch/csrc/xla_sigmoid.cu",
        "replaces": "kobato_eyes_tpu/models/postprocess.py:52",
        "launches": None,  # filled from the main paths' runs
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": lib_ms,
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

    from kobato_eyes_tpu_torch.bench import synth_hashes
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
    db = data / "db" / "catalog.sqlite3"
    name, n = _catalog_top_tag(db)
    n_rows = _sql_count(db, "SELECT COUNT(*) FROM file_tags")
    hits = [line for line in run_cli(base + ["search", "--backend", "sql", name]).splitlines() if line.strip()]
    print(f"search --backend sql {name!r}: {len(hits)} results (tag on {n} files; {n_rows} file_tags rows)")
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


def slice_phase(work: Path, lib: Path, labels: Path, cfg: Path) -> tuple[int, int, int, int]:
    """ViT index + search through the CLI; returns the attention launches of
    the index run through the packed and the separate q, k, v entries, its
    GELU launches and its sigmoid launches."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.ops import attention, gelu, xla_math

    data = work / "data"
    base = ["--config", str(cfg), "--data-dir", str(data), "--device", "cuda"]
    attention.launches = attention.launches_separate = 0
    gelu.launches = xla_math.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["index"])
    wall = time.perf_counter() - t0
    launches, separate, gelu_launches = attention.launches, attention.launches_separate, gelu.launches
    sigmoid_launches = xla_math.launches
    stats = json.loads(out.strip().splitlines()[-1])
    print_index_stats("vit-b448", stats, wall,
                      f"attention_launches={launches} separate_qkv={separate} gelu_launches={gelu_launches} "
                      f"sigmoid_launches={sigmoid_launches}")
    check(sigmoid_launches == N_IMAGES // BATCH, f"sigmoid launches {sigmoid_launches} != {N_IMAGES // BATCH}")
    depth = 12  # ViT-B: one attention and one GELU launch per layer per batch
    check(launches == depth * (N_IMAGES // BATCH),
          f"attention launches {launches} != {depth * (N_IMAGES // BATCH)}")
    check(gelu_launches == depth * (N_IMAGES // BATCH),
          f"gelu launches {gelu_launches} != {depth * (N_IMAGES // BATCH)}")
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
    return launches, separate, gelu_launches, sigmoid_launches


def swin_phase(work: Path, lib: Path, labels: Path, cfg: Path) -> tuple[int, int, int, int, int]:
    """SwinV2-B/448: index through ``run_index_once``, search through the CLI,
    fast / exact / residual-LN forwards, then ``validate-checkpoint`` through
    the CLI on the index tagger's weights. Returns the window-kernel and the
    separate-q, k, v attention launches of the index run, the LN-kernel
    launches of the residual-LN batch and the index run's GELU and sigmoid
    launches."""
    import dataclasses

    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.core.config.service import load_settings
    from kobato_eyes_tpu_torch.core.pipeline import run_index_once
    from kobato_eyes_tpu_torch.models.labels import load_labels
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.ops import attention, gelu, layernorm_residual, window_attention, xla_math
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
    gelu.launches = xla_math.launches = 0
    t0 = time.perf_counter()
    stats = run_index_once(data / "db" / "catalog.sqlite3", load_settings(cfg), fast).__dict__
    wall = time.perf_counter() - t0
    win_launches, ln_launches = window_attention.launches, layernorm_residual.launches
    separate, gelu_launches, sigmoid_launches = attention.launches_separate, gelu.launches, xla_math.launches
    print_index_stats("swinv2-b448", stats, wall,
                      f"window_launches={win_launches} ln_launches={ln_launches} separate_qkv={separate} "
                      f"gelu_launches={gelu_launches} sigmoid_launches={sigmoid_launches}")
    check(sigmoid_launches == N_IMAGES // BATCH, f"sigmoid launches {sigmoid_launches} != {N_IMAGES // BATCH}")
    depth = sum(SWIN_B448_DEPTHS)  # one window-kernel and one GELU launch per block per batch
    check(win_launches == depth * (N_IMAGES // BATCH),
          f"window launches {win_launches} != {depth * (N_IMAGES // BATCH)}")
    check(gelu_launches == depth * (N_IMAGES // BATCH),
          f"gelu launches {gelu_launches} != {depth * (N_IMAGES // BATCH)}")
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
    return win_launches, separate, ln_launches, gelu_launches, sigmoid_launches


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
    """Device time a call of ``fn`` by ``torch.profiler``: the sum of its
    device events (kernels, copies, memsets), beside ``wall_ms``, the
    CUDA-event time of a call: their difference is the device's idle share,
    the host's enqueue time. Host events carry their kernels' time as well
    (an aten op's self device time), so the sum over every event, which the
    line also prints, counts each kernel twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            synchronize()
        timed = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
        # "Command Buffer Full" marks the host waiting on a full launch queue
        device = [e for e in timed if e.device_type == DeviceType.CUDA and e.key != "Command Buffer Full"]
    except Exception as exc:  # noqa: BLE001 - a diagnostic: say why it is missing
        return f"not measured ({type(exc).__name__}: {exc})"
    busy = sum(e.self_device_time_total for e in device) / runs / 1e3
    if busy <= 0:
        return "not measured (the profiler recorded no device time)"
    ops = sum(e.count for e in device) / runs
    every = sum(e.self_device_time_total for e in timed) / runs / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:3]
    return (f"{busy:.3f} ms of device events a call ({ops:.0f} kernels, copies and memsets), idle share "
            f"{max(0.0, 1 - busy / wall_ms):.3f} of the {wall_ms:.3f} ms (every event with device time, "
            f"host ops too: {every:.3f} ms); most time in "
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


# ---------------------------------------------------------------------------
# Upkeep: real weights through the entry points, refresh, retag, watch, host CLI
# ---------------------------------------------------------------------------


def _catalog_tags(db: Path) -> dict[str, list[tuple[str, float]]]:
    """path -> [(tag, score), ...] of a catalog, tags sorted by name."""
    from kobato_eyes_tpu_torch.db.connection import bootstrap

    conn = bootstrap(db)
    try:
        rows = conn.execute("SELECT f.path, t.name, ft.score FROM file_tags ft JOIN files f ON f.id = ft.file_id "
                            "JOIN tags t ON t.id = ft.tag_id ORDER BY f.path, t.name").fetchall()
    finally:
        conn.close()
    out: dict[str, list[tuple[str, float]]] = {}
    for path, name, score in rows:
        out.setdefault(path, []).append((name, score))
    return out


def _sql_count(db: Path, query: str, args: tuple = ()) -> int:
    from kobato_eyes_tpu_torch.db.connection import bootstrap

    conn = bootstrap(db)
    try:
        return int(conn.execute(query, args).fetchone()[0])
    finally:
        conn.close()


def _fold_some(state_np: dict, blocks: int = 4) -> tuple[dict, list]:
    """The first ``blocks`` attention output projections renamed
    ``onnx::MatMul_<n>`` and transposed, as a constant-folding exporter
    writes them, numbered against module order, with the MatMul -> Add nodes
    that pair each with its named bias."""
    import numpy as np

    folded = dict(state_np)
    nodes = []
    for i in range(blocks):
        n = 900 - 7 * i  # block 0 gets the highest number: order alone would pair them wrong
        folded[f"onnx::MatMul_{n}"] = np.ascontiguousarray(folded.pop(f"blocks.{i}.attn.proj.weight").T)
        nodes += [("MatMul", (f"x{i}", f"onnx::MatMul_{n}"), (f"mm{i}",)),
                  ("Add", (f"mm{i}", f"blocks.{i}.attn.proj.bias"), (f"y{i}",))]
    return folded, nodes


def upkeep_phase(work: Path, lib: Path, labels: Path, cfg: Path) -> tuple[int, int, int]:
    """Real weights through the normal entry points, then catalog upkeep, on
    the card: ``import-weights`` of the seeded ViT-B/448 from a
    ``.safetensors`` and an ``.onnx`` file (constant-folded names among its
    initializers), ``inspect``; ``index`` with ``tagger.model_path`` naming
    the checkpoint against the ViT run's catalog; a SwinV2-B/448 checkpoint
    against the tagger holding its weights; the ``bf16_params`` forward;
    ``refresh``, ``retag --ids`` / ``--force``, the watcher (batch-of-one
    tag jobs on worker threads) and the host commands. Returns the
    head-resident attention launches of the index, refresh, retag and watch
    steps, the window launches of the SwinV2 step and the separate-q, k, v
    attention launches of all of them."""
    import numpy as np
    import torch
    from PIL import Image
    from safetensors.torch import save_file

    from kobato_eyes_tpu_torch.core.config.service import load_settings, save_settings
    from kobato_eyes_tpu_torch.core.watcher import ProcessingPipeline
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.models.onnx_import import write_onnx_initializers
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger, load_checkpoint
    from kobato_eyes_tpu_torch.ops import attention, phash, window_attention
    from kobato_eyes_tpu_torch.sig.signatures import _decode_one
    from kobato_eyes_tpu_torch.utils.bits import U64_MASK
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

    t_phase = time.perf_counter()
    depth = 12
    counted = {"attention": 0, "window": 0, "separate": 0}

    def counts_reset() -> None:
        attention.launches = attention.launches_separate = window_attention.launches = 0

    def counts_read() -> tuple[int, int]:
        counted["attention"] += attention.launches
        counted["window"] += window_attention.launches
        counted["separate"] += attention.launches_separate
        return attention.launches, window_attention.launches

    # 1. import: the seeded ViT-B/16 @ 448 (seed 0, the ViT run's weights) as
    # a .safetensors and an initializer-only .onnx with folded names
    t0 = time.perf_counter()
    state = WD14Tagger(labels_path=labels, device="cpu")._model.state_dict()
    st_path, onnx_path = work / "vit_b448.safetensors", work / "vit_b448.onnx"
    save_file({k: v.contiguous() for k, v in state.items()}, str(st_path))
    folded, nodes = _fold_some({k: v.numpy() for k, v in state.items()})
    write_onnx_initializers(onnx_path, folded, nodes=nodes)
    print(f"upkeep: seeded vit-b448 weights ({sum(v.numel() for v in state.values()) / 1e6:.1f}M) as "
          f".safetensors ({st_path.stat().st_size / 1e6:.0f} MB) and .onnx ({len(folded)} initializers, 4 "
          f"folded) in {time.perf_counter() - t0:.1f} s")
    data = work / "data_upkeep"
    base_cfg = ["--config", str(cfg), "--data-dir", str(data), "--device", DEVICE]
    ckpts = {}
    for name, src in (("safetensors", st_path), ("onnx", onnx_path)):
        out_dir = work / f"ckpt_vit_{name}"
        t0 = time.perf_counter()
        out = json.loads(run_cli(base_cfg + ["import-weights", str(src), str(out_dir), "--arch", "vit"]))
        check(out == {"arch": "vit", "preset": "base", "out": str(out_dir)}, f"import-weights {name}: {out}")
        loaded, meta = load_checkpoint(out_dir)
        same = loaded.keys() == state.keys() and all(torch.equal(loaded[k], state[k]) for k in state)
        print(f"upkeep: import-weights --arch vit {src.name} -> {out_dir.name} in {time.perf_counter() - t0:.1f} s; "
              f"{len(loaded)} tensors equal to the source bit for bit: {same}; source sha256 "
              f"{meta['source']['sha256'][:12]}")
        check(same, f"import-weights {name}: the checkpoint's state != the source state")
        ckpts[name] = out_dir
    out = run_cli(base_cfg + ["inspect", "--checkpoint", str(ckpts["safetensors"])])
    check(f"labels: {N_LABELS} (" in out and f"checkpoint: {ckpts['safetensors']}" in out, f"inspect dir: {out}")
    out = run_cli(base_cfg + ["inspect", "--checkpoint", str(onnx_path)])
    check(f"onnx weights: {len(folded)} initializers" in out, f"inspect onnx: {out}")
    print(f"upkeep: inspect: {N_LABELS} labels (family wd14) beside the checkpoint; the .onnx "
          f"{len(folded)} initializers")

    # 2. ket index with tagger.model_path = the checkpoint: the ViT run's
    # catalog, row for row (same weights, batches, device and kernels)
    settings = load_settings(cfg)
    settings.tagger.model_path = ckpts["safetensors"]
    cfg_ck = work / "settings_upkeep.yaml"
    save_settings(settings, cfg_ck)
    base = ["--config", str(cfg_ck), "--data-dir", str(data), "--device", DEVICE]
    counts_reset()
    t0 = time.perf_counter()
    stats = json.loads(run_cli(base + ["index"]).strip().splitlines()[-1])
    wall = time.perf_counter() - t0
    launches, _ = counts_read()
    print_index_stats("upkeep vit-b448 from its checkpoint", stats, wall, f"attention_launches={launches}")
    check(launches == depth * (N_IMAGES // BATCH), f"attention launches {launches} != {depth * (N_IMAGES // BATCH)}")
    db = data / "db" / "catalog.sqlite3"
    got, want = _catalog_tags(db), _catalog_tags(work / "data" / "db" / "catalog.sqlite3")
    check(got.keys() == want.keys(), "the checkpoint run tagged other files than the ViT run")
    tag_sets = sum(1 for p in want if [n for n, _ in got[p]] != [n for n, _ in want[p]])
    common = [(a[1], b[1]) for p in want for a, b in zip(got[p], want[p]) if a[0] == b[0]]
    max_d = max((abs(a - b) for a, b in common), default=0.0)
    print(f"upkeep: checkpoint index vs the ViT run's catalog: {sum(len(v) for v in got.values())} file_tags rows, "
          f"files whose tag set differs {tag_sets}, scores bit-equal {got == want}, max |d score| {max_d:.3e}")
    check(got == want, f"checkpoint index != the ViT run's catalog ({tag_sets} tag sets differ, max {max_d})")

    # 3. SwinV2-B/448: import-weights --arch swinv2, then the checkpoint_path=
    # tagger against the params= tagger on one batch of 32
    t0 = time.perf_counter()
    swin_state = WD14Tagger(arch="swinv2", labels_path=labels, device="cpu")._model.state_dict()
    swin_src = work / "swinv2_b448.safetensors"
    save_file({k: v.contiguous() for k, v in swin_state.items()}, str(swin_src))
    swin_ck = work / "ckpt_swinv2"
    run_cli(base_cfg + ["import-weights", str(swin_src), str(swin_ck), "--arch", "swinv2"])
    from_ck = WD14Tagger(arch="swinv2", labels_path=labels, checkpoint_path=swin_ck, device=DEVICE)
    from_params = WD14Tagger(arch="swinv2", labels_path=labels, params=swin_state, device=DEVICE)
    imgs = [load_rgb_array(p) for p in sorted(lib.iterdir())[:BATCH]]
    b32 = from_ck.prepare_batch_from_rgb(imgs)
    p_params = from_params.forward_probs(b32)
    counts_reset()
    p_ck = from_ck.forward_probs(b32)
    synchronize()
    _, win = counts_read()
    print(f"upkeep: swinv2-b448 import-weights + checkpoint_path= tagger in {time.perf_counter() - t0:.1f} s; "
          f"batch {BATCH} probabilities equal to the params= tagger's bit for bit: {torch.equal(p_ck, p_params)}; "
          f"window launches {win}")
    check(torch.equal(p_ck, p_params), "swinv2 checkpoint_path= probabilities != params= probabilities")
    check(win == sum(SWIN_B448_DEPTHS), f"window launches {win} != {sum(SWIN_B448_DEPTHS)}")
    del from_ck, from_params, swin_state, p_ck, p_params

    # 4. bf16_params: the ViT-B/448 fast forward at batch 32 with the weights
    # stored in bf16 once, beside the f32-weight forward of the same call
    from kobato_eyes_tpu_torch.cli import _resolve_tagger

    vit = _resolve_tagger(settings, DEVICE)  # the CLI's own tagger: the checkpoint, the settings' thresholds
    vit_bf16 = WD14Tagger(labels_path=labels, checkpoint_path=ckpts["onnx"], bf16_params=True, device=DEVICE)
    check({p.dtype for p in vit_bf16._model.parameters()} == {torch.bfloat16}, "bf16_params: f32 parameters left")
    vb32 = torch.from_numpy(vit.prepare_batch_from_rgb(imgs)).to(DEVICE)
    d_bf16 = float((vit.forward_probs(vb32) - vit_bf16.forward_probs(vb32)).abs().max())
    f32_ms = cuda_ms(lambda: vit.forward_probs(vb32), iters=5)
    bf16_ms = cuda_ms(lambda: vit_bf16.forward_probs(vb32), iters=5)
    print(f"upkeep: vit-b448 batch-{BATCH} fast forward, bf16_params vs f32 weights: max |dp| {d_bf16:.3e} "
          f"(tol 0.02); {bf16_ms:.2f} ms against {f32_ms:.2f} ms (CUDA events, warm, mean of 5)")
    print(f"upkeep: f32 weights, device busy by torch.profiler: {_profiled_busy(lambda: vit.forward_probs(vb32), f32_ms)}")
    print(f"upkeep: bf16_params, device busy by torch.profiler: "
          f"{_profiled_busy(lambda: vit_bf16.forward_probs(vb32), bf16_ms)}")
    check(d_bf16 <= 0.02, f"bf16_params deviation {d_bf16} > 0.02")
    del vit_bf16, vb32

    # 5. ket refresh: 16 new files, 8 deleted, 8 rewritten in the library
    top, _ = _catalog_top_tag(db)
    run_cli(base + ["search", top])  # an epoch snapshot the refresh must make stale
    files = sorted(lib.iterdir())
    rng = np.random.default_rng(21)
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, size=(300, 260, 3), dtype=np.uint8)).save(lib / f"new_{i:02d}.png")
    for path in files[:8]:
        path.unlink()
    rewritten = files[8:16]
    before = {p: _file_row(db, p) for p in rewritten}
    for path in rewritten:
        Image.fromarray(rng.integers(0, 256, size=(200, 240, 3), dtype=np.uint8)).save(path)
    counts_reset()
    stats = json.loads(run_cli(base + ["refresh", str(lib)]).strip().splitlines()[-1])
    launches, _ = counts_read()
    print(f"upkeep: refresh: tagged={stats['tagged']} missing={stats['missing']} tag_failed={stats['tag_failed']} "
          f"elapsed_sec={stats['elapsed_sec']:.3f} attention_launches={launches}")
    # refresh queues what is new or untagged under the root (the reference's
    # manual refresh): a rewritten file keeps its row until `ket index`
    check(stats["tagged"] == 16 and stats["missing"] == 8 and stats["tag_failed"] == 0, f"refresh stats {stats}")
    check(launches == depth, f"refresh attention launches {launches} != {depth}")
    check(all(_file_row(db, p) == before[p] for p in rewritten), "refresh touched a rewritten file's row")
    device = _search_lines(run_cli(base + ["search", top]))
    sql = _search_lines(run_cli(base + ["search", "--backend", "sql", top]))
    check(device == sql and device, f"search {top!r} after refresh: device != sql")
    for path in files[16:20]:
        path.unlink()
    n_rows = _sql_count(db, "SELECT COUNT(*) FROM files")
    counts_reset()
    stats = json.loads(run_cli(base + ["refresh", "--hard-delete", str(lib)]).strip().splitlines()[-1])
    launches, _ = counts_read()
    check(stats["missing"] == 4 and stats["tagged"] == 0 and launches == 0, f"refresh --hard-delete {stats}")
    check(_sql_count(db, "SELECT COUNT(*) FROM files") == n_rows - 4, "refresh --hard-delete left the rows")
    print(f"upkeep: search {top!r} after the refresh: {len(device)} lines, device == sql; refresh --hard-delete: "
          f"4 rows removed ({n_rows} -> {n_rows - 4})")

    # 6. ket retag --ids on 5 files: the rows come back equal; --force clears
    picks = [(_file_row(db, p)[0], str(p)) for p in files[20:25]]  # neither deleted nor rewritten
    tags_before = _catalog_tags(db)
    counts_reset()
    stats = json.loads(run_cli(base + ["retag", "--ids", *(str(i) for i, _ in picks)]))
    launches, _ = counts_read()
    tags_after = _catalog_tags(db)
    check(stats["tagged"] == 5 and stats["tag_failed"] == 0, f"retag --ids stats {stats}")
    check(launches == depth, f"retag --ids attention launches {launches} != {depth}")
    # batch 5 against the index run's batch 32: the GEMMs may take other
    # kernels (bit-equal on the H100 so far), so the rows are held within the
    # tolerance, a tag kept by one run only at its gate or the cap's edge
    equal, max_d, flips = _rows_agree(tags_before, tags_after, [p for _, p in picks], vit, tol=0.02)
    print(f"upkeep: retag --ids rows against the index run's: {equal} of 5 files bit-equal, max |d score| "
          f"{max_d:.3e} (tol 0.02), tags kept by one run only, by distance to their gate or the cap edge {flips}")
    check(max_d <= 0.02 and all(abs(d) <= 0.02 for _, d in flips), "retag --ids moved its rows")
    n_rows = _sql_count(db, "SELECT COUNT(*) FROM files")
    cleared = json.loads(run_cli(base + ["retag", "--force"]))["cleared"]
    check(cleared == n_rows and _sql_count(db, "SELECT COUNT(*) FROM files WHERE tagger_sig IS NOT NULL") == 0,
          f"retag --force cleared {cleared} of {n_rows}")
    print(f"upkeep: retag --ids of 5 files: attention_launches={launches}; retag --force cleared {cleared}")

    # 7. the watcher: batch-of-one tag jobs on worker threads, polling a
    # fresh folder into which 4 images are dropped
    watched = work / "watched"
    watched.mkdir()
    wdb = work / "data_watch" / "catalog.sqlite3"
    wdb.parent.mkdir()
    bootstrap(wdb).close()
    pipe = ProcessingPipeline(wdb, vit, device=DEVICE)
    counts_reset()
    t0 = time.perf_counter()
    pipe.start_polling([watched], interval=0.05)
    try:
        dropped = []
        for i, src in enumerate(sorted(lib.glob("img_*.png"))[:4]):
            dropped.append(watched / f"drop_{i}.png")
            shutil.copyfile(src, dropped[-1])
        deadline = time.monotonic() + 60
        done = 0
        while time.monotonic() < deadline and done < 4:
            done = _sql_count(wdb, "SELECT COUNT(*) FROM files WHERE tagger_sig IS NOT NULL")
            time.sleep(0.05)
    finally:
        pipe.stop()
    wall = time.perf_counter() - t0
    launches, _ = counts_read()
    print(f"upkeep: watch: {done} of 4 dropped files tagged in {wall:.2f} s, attention_launches={launches} (B=1)")
    check(done == 4, f"watch tagged {done} of 4 within 60 s")
    check(launches == 4 * depth, f"watch attention launches {launches} != {4 * depth}")
    conn = bootstrap(wdb)
    try:
        sig_rows = conn.execute("SELECT f.path, s.phash_u64, s.dhash_u64 FROM files f "
                                "JOIN signatures s ON s.file_id = f.id").fetchall()
    finally:
        conn.close()
    bad = [p for p, ph, dh in sig_rows
           if (ph & U64_MASK, dh & U64_MASK) != tuple(f(g) for f, g in zip((phash.phash_np, phash.dhash_np),
                                                                           _decode_one(p)))]
    check(len(sig_rows) == 4 and not bad, f"watch signature rows {len(sig_rows)}, unequal to the specs {bad}")
    arrs = [load_rgb_array(p) for p in dropped]
    p4 = vit.forward_probs(vit.prepare_batch_from_rgb(arrs))
    p1 = torch.cat([vit.forward_probs(vit.prepare_batch_from_rgb([a])) for a in arrs])
    d_b1 = float((p4 - p1).abs().max())
    batch_rows = {str(p): sorted((t.name, t.score) for t in r.tags) for p, r in zip(dropped, vit.infer_batch(arrs))}
    equal, max_d, flips = _rows_agree(batch_rows, _catalog_tags(wdb), [str(p) for p in dropped], vit, tol=0.02)
    print(f"upkeep: watch (B=1) vs a batch-of-4 run of the same tagger: max |dp| {d_b1:.3e} over {p4.numel()} "
          f"probabilities (tol 0.02); catalog rows {equal} of 4 files equal, max |d score| {max_d:.3e}, tags "
          f"kept by one run only {flips}; pHash/dHash equal to the specs")
    check(d_b1 <= 0.02 and all(abs(d) <= 0.02 for _, d in flips), f"batch-of-one vs batch-of-4: {d_b1}, {flips}")
    del vit

    # 8. host commands against what SQL says; reset last
    from kobato_eyes_tpu_torch.db.repository import load_tag_thresholds, normalize_thresholds

    conn = bootstrap(db)
    try:
        gate = float(normalize_thresholds(load_tag_thresholds(conn)).get(0, 0.0))
    finally:
        conn.close()
    n_rows_top = _sql_count(db, "SELECT COUNT(*) FROM file_tags ft JOIN tags t ON t.id = ft.tag_id "
                                "WHERE t.name = ?", (top,))
    n_top = _sql_count(db, "SELECT COUNT(DISTINCT ft.file_id) FROM file_tags ft JOIN tags t ON t.id = ft.tag_id "
                           "WHERE t.name = ? AND ft.score >= ?", (top, gate))
    line = next(ln for ln in run_cli(base + ["stats", "--limit", "1000"]).splitlines() if ln.endswith(f"] {top}"))
    check(int(line.split()[0]) == n_top, f"stats {line!r}: SQL counts {n_top}")
    comp = [ln.split("\t") for ln in run_cli(base + ["complete", top, "--limit", "1000"]).splitlines()]
    check([top, "0", str(n_rows_top)] in comp, f"complete {top}: SQL counts {n_rows_top}")
    thr = json.loads(run_cli(base + ["thresholds", "--set", "0=0.5"]))
    check(thr == {"0": 0.5}, f"thresholds --set: {thr}")
    fid, fpath = picks[0]
    check(json.loads(run_cli(base + ["trash", "--put", str(fid)])) == {"trashed": [fid], "failed": []}, "trash --put")
    check(not Path(fpath).exists() and _sql_count(db, "SELECT is_present FROM files WHERE id = ?", (fid,)) == 0,
          "trash --put left the file or its row present")
    check(json.loads(run_cli(base + ["trash", "--restore", str(fid)])) == {"restored": [fid], "remaining": 0},
          "trash --restore")
    check(Path(fpath).exists() and _sql_count(db, "SELECT is_present FROM files WHERE id = ?", (fid,)) == 1,
          "trash --restore left the file away or its row absent")
    check(json.loads(run_cli(base + ["config"]))["tagger"]["model_path"] == str(ckpts["safetensors"]), "config")
    backups = json.loads(run_cli(base + ["reset", "--yes"]))["backups"]
    check(backups and all(Path(b).exists() for b in backups) and not db.exists(), f"reset backups {backups}")
    check(run_cli(base + ["stats"]) == "" and _sql_count(db, "SELECT COUNT(*) FROM files") == 0,
          "the catalog is not empty after reset")
    print(f"upkeep: stats / complete {top!r} = {n_top} / {n_rows_top} as SQL counts; thresholds --set; trash --put / "
          f"--restore of file {fid}; config; reset --yes -> {len(backups)} backups, an empty catalog")
    print(f"upkeep phase {time.perf_counter() - t_phase:.1f} s")
    return counted["attention"], counted["window"], counted["separate"]


# ---------------------------------------------------------------------------
# Training and serving: ket train, the query server
# ---------------------------------------------------------------------------

TRAIN_BATCH = 16
TRAIN_SIZE = 448
# the train step's MLP activation (ViT-B/448, batch 16): the GELU backward's shape
TRAIN_GELU = (TRAIN_BATCH * 785, 3072)


def train_phase(work: Path, lib: Path) -> tuple[int, int, int]:
    """``ket train --device cuda`` on the ViT index run's catalog: ViT-B/16 @
    448, batch 16, the catalog's tags as the vocabulary, one epoch (16
    steps). The loss must be finite and fall, no attention kernel may run
    (it has no backward), the checkpoint and labels CSV must load into
    ``TorchTagger``, and a fast-math ``index`` of the library from that
    checkpoint must launch kernel 1 twelve times a batch with no failed tag.
    Then the step's time (CUDA events, warm, mean of 5), its MFU and its peak
    memory. Returns the GELU launches of the training and of that index run,
    the GELU backward launches of the training (12 a step) and the kernel-1
    launches of the index run."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.core.config.schema import PipelineSettings, Settings, TaggerSettings
    from kobato_eyes_tpu_torch.core.config.service import save_settings
    from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec
    from kobato_eyes_tpu_torch.models.tagger import TorchTagger
    from kobato_eyes_tpu_torch.models.train import TrainConfig, make_train_step
    from kobato_eyes_tpu_torch.models.vit import vit_config, vit_forward_flops
    from kobato_eyes_tpu_torch.ops import attention, gelu
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

    t_phase = time.perf_counter()
    out = work / "finetuned"
    attention.launches = attention.launches_separate = 0
    gelu.launches = gelu.backward_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = json.loads(run_cli(["--data-dir", str(work / "data"), "--device", DEVICE, "train", "--preset", "base",
                              "--image-size", str(TRAIN_SIZE), "--epochs", "1", "--batch-size", str(TRAIN_BATCH),
                              "--out", str(out)]).strip().splitlines()[-1])
    wall = time.perf_counter() - t0
    train_attn = attention.launches + attention.launches_separate
    train_gelu, train_gelu_backward = gelu.launches, gelu.backward_launches
    peak_cli = torch.cuda.max_memory_allocated()
    steps = N_IMAGES // TRAIN_BATCH
    print(f"ket train vit-b448: files={res['files']} labels={res['labels']} steps={res['steps']} "
          f"first_loss={res['first_loss']:.6f} final_loss={res['final_loss']:.6f} elapsed_sec={res['elapsed_sec']} "
          f"wall={wall:.1f} s; attention launches {train_attn}, gelu launches {train_gelu}, "
          f"gelu backward launches {train_gelu_backward}, "
          f"peak memory {peak_cli / 2**30:.2f} GiB")
    check(res["files"] == N_IMAGES and res["steps"] == steps, f"train: {res['files']} files, {res['steps']} steps")
    check(np.isfinite(res["first_loss"]) and np.isfinite(res["final_loss"]), "train: non-finite loss")
    check(res["final_loss"] < res["first_loss"], "train: the loss did not fall")
    check(train_attn == 0, f"train: {train_attn} attention-kernel launches (no backward)")
    check(train_gelu == 12 * steps, f"train: gelu launches {train_gelu} != {12 * steps}")
    check(train_gelu_backward == 12 * steps, f"train: gelu backward launches {train_gelu_backward} != {12 * steps}")

    # the checkpoint and labels CSV load into the tagger (fast math on CUDA)
    tagger = TorchTagger(checkpoint_path=res["checkpoint"], labels_path=res["labels_csv"], device=DEVICE)
    check(tagger.cfg.attn_impl == "pallas" and tagger.cfg.num_classes == res["labels"], "fine-tuned tagger")
    imgs = [load_rgb_array(p) for p in sorted(lib.iterdir())[:4]]
    probs = tagger.forward_probs(tagger.prepare_batch_from_rgb(imgs))
    torch.cuda.synchronize()
    check(tuple(probs.shape) == (4, res["labels"]) and bool(torch.isfinite(probs).all()),
          "fine-tuned tagger: probabilities")
    del tagger

    # an index run of the library from the fine-tuned checkpoint
    settings = Settings(
        pipeline=PipelineSettings(roots=[lib], batch_size=BATCH, inline_signatures=False),
        tagger=TaggerSettings(name="wd14", labels_path=Path(res["labels_csv"]), model_path=Path(res["checkpoint"])),
    )
    cfg = work / "settings_finetuned.yaml"
    save_settings(settings, cfg)
    attention.launches = attention.launches_separate = 0
    gelu.launches = 0
    t0 = time.perf_counter()
    stats = json.loads(run_cli(["--config", str(cfg), "--data-dir", str(work / "data_finetuned"),
                                "--device", DEVICE, "index"]).strip().splitlines()[-1])
    index_attn, index_gelu = attention.launches, gelu.launches
    print_index_stats("vit-b448 from the fine-tuned checkpoint", stats, time.perf_counter() - t0,
                      f"attention_launches={index_attn} gelu_launches={index_gelu}")
    check(index_attn == 12 * (N_IMAGES // BATCH), f"index from the checkpoint: {index_attn} attention launches")
    check(index_gelu == 12 * (N_IMAGES // BATCH), f"index from the checkpoint: {index_gelu} gelu launches")

    # the step alone: ViT-B/448 at batch 16 over the catalog's vocabulary
    vcfg = vit_config("base", image_size=TRAIN_SIZE, num_classes=res["labels"])
    step, _ = make_train_step(vcfg, PreprocessSpec(mode="wd14", size=TRAIN_SIZE), TrainConfig(), device=DEVICE)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, size=(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8)).to(DEVICE)
    y = torch.from_numpy((rng.random((TRAIN_BATCH, res["labels"])) < 0.05).astype(np.float32)).to(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(x, y), iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    flops = 3.0 * vit_forward_flops(vcfg, TRAIN_BATCH)
    print(f"train step vit-b448 batch {TRAIN_BATCH}, {res['labels']} labels: {step_ms:.2f} ms (CUDA events, warm, "
          f"mean of 5), {flops / 1e12:.2f} TFLOP (3 x forward), MFU {flops / (step_ms * 1e-3) / BF16_FLOPS_PER_S:.4f} "
          f"against {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16; max_memory_allocated {peak / 2**30:.2f} GiB")
    # where a step's time goes: forward + loss, backward, the AdamW update
    # (CUDA events between the three, mean of 5), and the GELU backward
    # alone at the step's MLP shape, once for each of the 12 layers: the
    # kernel, and its plain version
    h = torch.randn(TRAIN_GELU, device=DEVICE).to(torch.bfloat16)
    gelu_bwd_ms = 12 * cuda_ms(lambda: gelu.gelu_backward(h, h, approximate=False), iters=10)
    plain_bwd_ms = 12 * cuda_ms(lambda: gelu.gelu_erf_backward_plain(h, h), iters=3, warmup=1)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(5)]
    for ev in marks:
        ev[0].record()
        step.optimizer.zero_grad(set_to_none=True)
        loss = step.loss(x, y)
        ev[1].record()
        loss.backward()
        ev[2].record()
        step.optimizer.step()
        ev[3].record()
    torch.cuda.synchronize()
    split = [sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / len(marks) for i in range(3)]
    check(TRAIN_GELU == (TRAIN_BATCH * (vcfg.num_patches + 1), vcfg.mlp_dim), "the train step's MLP shape")
    print(f"train step split: forward + loss {split[0]:.2f} ms, backward {split[1]:.2f} ms, AdamW {split[2]:.2f} ms; "
          f"the erf-GELU backward at {TRAIN_GELU} bf16, 12 layers: kernel {gelu_bwd_ms:.2f} ms, "
          f"plain {plain_bwd_ms:.2f} ms; phase {time.perf_counter() - t_phase:.1f} s")
    del step, x, y, h
    return train_gelu + index_gelu, train_gelu_backward, index_attn


FLASH_TRAIN_STEPS = 3


def flash_train_phase() -> tuple[int, int, int]:
    """3 train steps at ViT-B/16 @ 448, batch 16, 8192 labels with
    ``attn_impl="flash"`` beside the einsum step from the same seeded
    weights on the same seeded batches: losses within 1e-3 relative,
    step-1 gradient norms per tensor within 0.99-1.01 of the einsum step's;
    each tensor's step-1 gradient no further (max |dg| / max |g|) from an
    f32 einsum step's than twice the bf16 einsum step's worst tensor is,
    and within 3e-2 of the bf16 einsum step's; exactly 12 forward, 12 dK/dV
    and 12 dQ launches a step, every launch the ``"wgmma"`` body.
    Then both steps' ms (CUDA events, warm, mean of 5) and peak memory.
    Returns the three kernels' launches."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec
    from kobato_eyes_tpu_torch.models.train import TrainConfig, _init_model, make_train_step
    from kobato_eyes_tpu_torch.models.vit import ViT, vit_config
    from kobato_eyes_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    spec = PreprocessSpec(mode="wd14", size=TRAIN_SIZE)
    ecfg = vit_config("base", image_size=TRAIN_SIZE, num_classes=N_LABELS)
    fcfg = vit_config("base", image_size=TRAIN_SIZE, num_classes=N_LABELS, attn_impl="flash")
    einsum_model = _init_model(ecfg)
    flash_model = ViT(fcfg)
    flash_model.load_state_dict(einsum_model.state_dict())
    flash, _ = make_train_step(fcfg, spec, TrainConfig(), model=flash_model, device=DEVICE)
    einsum, _ = make_train_step(ecfg, spec, TrainConfig(), model=einsum_model, device=DEVICE)
    rng = np.random.default_rng(72)
    batches = [(torch.from_numpy(rng.integers(0, 256, size=(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                                             dtype=np.uint8)).to(DEVICE),
                torch.from_numpy((rng.random((TRAIN_BATCH, N_LABELS)) < 0.05).astype(np.float32)).to(DEVICE))
               for _ in range(FLASH_TRAIN_STEPS)]
    # the f32 einsum step's gradients on the first batch: what both bf16 steps approximate
    rcfg = vit_config("base", image_size=TRAIN_SIZE, num_classes=N_LABELS, dtype=torch.float32)
    ref_model = ViT(rcfg)
    ref_model.load_state_dict(einsum_model.state_dict())
    ref, _ = make_train_step(rcfg, spec, TrainConfig(), model=ref_model, device=DEVICE)
    ref.loss(*batches[0]).backward()
    ref_grads = {k: p.grad.float().clone() for k, p in ref.model.named_parameters()}
    del ref, ref_model
    torch.cuda.empty_cache()

    fa.launches = fa.backward_dkv_launches = fa.backward_dq_launches = 0
    fa.forward_variant_launches = dict.fromkeys(fa.forward_variant_launches, 0)
    fa.backward_variant_launches = dict.fromkeys(fa.backward_variant_launches, 0)
    losses, grads = [], None
    for x, y in batches:
        losses.append(float(flash(x, y)))
        if grads is None:
            grads = {k: p.grad.float().clone() for k, p in flash.model.named_parameters()}
    counts = (fa.launches, fa.backward_dkv_launches, fa.backward_dq_launches)
    by_variant = dict(fa.backward_variant_launches)
    fwd_bodies = dict(fa.forward_variant_launches)
    expect = FLASH_TRAIN_STEPS * fcfg.depth
    check(fwd_bodies == {"wgmma": expect, "fma": 0},
          f"flash train: the forward's bodies {fwd_bodies}, not {expect} \"wgmma\" launches")
    check(counts == (expect,) * 3, f"flash train: launches (forward, dK/dV, dQ) {counts} != {expect} each")
    check(by_variant == {("dkv", "wgmma"): expect, ("dq", "wgmma"): expect, ("dkv", "fma"): 0, ("dq", "fma"): 0},
          f"flash train: the backward's bodies {by_variant}, not {expect} \"wgmma\" launches of each kernel")
    one_losses, one_grads = [], None
    for x, y in batches:
        one_losses.append(float(einsum(x, y)))
        if one_grads is None:
            one_grads = {k: p.grad.float().clone() for k, p in einsum.model.named_parameters()}
    check(all(np.isfinite(losses)), f"flash train: losses {losses}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
    ratios, dg = {}, {}
    for name, want in one_grads.items():
        got = grads[name]
        ratios[name] = float(got.norm() / want.norm())
        dg[name] = float((got - want).abs().max() / want.abs().max())
    worst_ratio = max(ratios, key=lambda k: abs(ratios[k] - 1.0))
    worst_dg = max(dg, key=dg.get)

    def off_f32(g):  # each tensor's max |g - g_f32| / max |g_f32|
        return {k: float((g[k] - r).abs().max() / r.abs().max()) for k, r in ref_grads.items()}

    flash_off, einsum_off = off_f32(grads), off_f32(one_grads)
    for name, off in (("flash", flash_off), ("einsum", einsum_off)):
        worst = sorted(off, key=off.get, reverse=True)[:4]
        print(f"flash train: {name} bf16 step-1 gradients against the f32 einsum step's, max |dg| / max |g|: "
              + ", ".join(f"{k} {off[k]:.3e}" for k in worst)
              + f"; {worst_dg}: flash {flash_off[worst_dg]:.3e}, einsum {einsum_off[worst_dg]:.3e}")
    print(f"flash train vit-b448 batch {TRAIN_BATCH}: losses {' '.join(f'{v:.6f}' for v in losses)} vs einsum "
          f"{' '.join(f'{v:.6f}' for v in one_losses)} (max rel {rel:.3e}, tol 1e-3); step-1 gradient norm ratio "
          f"{min(ratios.values()):.5f}..{max(ratios.values()):.5f} (worst {worst_ratio}), max |dg| / max |g| "
          f"{dg[worst_dg]:.3e} ({worst_dg}, tol 3e-2); launches a step: forward {counts[0] // FLASH_TRAIN_STEPS}, "
          f"dK/dV {counts[1] // FLASH_TRAIN_STEPS}, dQ {counts[2] // FLASH_TRAIN_STEPS} (bodies: forward "
          f"{fwd_bodies}, backward {by_variant})")
    check(rel <= 1e-3, f"flash train: losses {rel} apart from the einsum step (relative)")
    check(all(0.99 <= v <= 1.01 for v in ratios.values()),
          f"flash train: gradient norm ratio {ratios[worst_ratio]} ({worst_ratio})")
    # two bf16 roundings of one step: the flash path rounds dS to bf16 before
    # dQ and dK, as the JAX kernels do, where the einsum path keeps it in
    # f32; each is held to the f32 step, the flash step within twice the
    # einsum step's worst tensor, and to each other at PR 11's bar
    worst_flash = max(flash_off, key=flash_off.get)
    einsum_worst = max(einsum_off.values())
    check(flash_off[worst_flash] <= 2 * einsum_worst, f"flash train: gradient {worst_flash} "
          f"{flash_off[worst_flash]} from the f32 step's, past twice the einsum step's {einsum_worst}")
    check(dg[worst_dg] <= 3e-2, f"flash train: gradient {worst_dg} {dg[worst_dg]} apart from the einsum step's")

    x, y = batches[0]
    del grads, one_grads
    times = {}
    for name, step in (("flash", flash), ("einsum", einsum), ("einsum", einsum), ("flash", flash)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(x, y), iters=5, warmup=2)
        times.setdefault(name, []).append((ms, torch.cuda.max_memory_allocated()))
    flash_ms, flash_peak = min(times["flash"])
    einsum_ms, einsum_peak = min(times["einsum"])
    print(f"flash train step vit-b448 batch {TRAIN_BATCH}: flash {flash_ms:.2f} ms, einsum {einsum_ms:.2f} ms "
          f"(CUDA events, warm, mean of 5, the least of two readings in turns: flash "
          f"{' / '.join(f'{ms:.2f}' for ms, _ in times['flash'])}, einsum "
          f"{' / '.join(f'{ms:.2f}' for ms, _ in times['einsum'])}); max_memory_allocated flash "
          f"{flash_peak / 2**30:.2f} GiB, einsum {einsum_peak / 2**30:.2f} GiB (both steps resident); "
          f"phase {time.perf_counter() - t0:.1f} s")
    del flash, einsum, batches
    torch.cuda.empty_cache()
    return counts


def _http(base: str, route: str, payload=None) -> tuple[int, str, bytes]:
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + route, data=data, method="GET" if payload is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type"), exc.read()


def _http_json(base: str, route: str, payload=None) -> dict:
    status, ctype, body = _http(base, route, payload)
    check(status == 200 and ctype == "application/json", f"{route}: HTTP {status} {body[:200]!r}")
    return json.loads(body)


class _Served:
    """The port's server on 127.0.0.1, a free port, in a thread of this process."""

    def __init__(self, db: Path, data_root: Path | None = None):
        import threading

        from kobato_eyes_tpu_torch.services.server import make_server

        self.httpd, self.core = make_server(db, "127.0.0.1", 0, data_root=data_root, device=DEVICE)
        self.base = "http://%s:%d" % self.httpd.server_address[:2]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


def serve_phase(work: Path) -> int:
    """The port's server in this process on ``127.0.0.1:0``: on the 20 000-file
    catalog, ``/search`` against the SQL backend over the parity queries, a
    POST batch against the singles, ``/search`` latency by the host clock
    beside the in-process search; on the dup CLI phase's catalog,
    ``/dup?audit=1`` against ``ket dup --audit --export``'s clusters and the
    audit it summarizes; on the ANN phase's catalog, ``/similar`` against
    ``find_similar``; then ``/delta`` and ``/reload`` after files are added,
    ``/trash``, ``/file`` and ``/thumb``. Returns the kernel-5 launches of the
    ``/dup?audit=1`` request."""
    import csv
    import urllib.parse

    import numpy as np
    from PIL import Image

    from kobato_eyes_tpu_torch.core.pipeline.embed_stage import load_embedding, load_embeddings
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import (
        TaggingItem, iter_files_for_dup, load_tag_thresholds, set_tag_threshold, upsert_file, write_tagging_batch,
    )
    from kobato_eyes_tpu_torch.dup.audit import audit_clusters, summarize
    from kobato_eyes_tpu_torch.dup.engine import TpuDuplicateScanner
    from kobato_eyes_tpu_torch.dup.types import DuplicateFileMeta, DuplicateScanConfig
    from kobato_eyes_tpu_torch.index.flat import FlatIndex, find_similar
    from kobato_eyes_tpu_torch.ops import pairwise_hamming
    from kobato_eyes_tpu_torch.query import engine

    t_phase = time.perf_counter()
    # 1. /search on the 20 000-file catalog; a general threshold f32 holds
    # exactly, so that f32 and f64 comparisons agree
    db = work / "parity" / "catalog.sqlite3"
    conn = bootstrap(db)
    set_tag_threshold(conn, 0, 0.375)
    conn.commit()
    t0 = time.perf_counter()
    served = _Served(db)
    print(f"serve: 20 000-file catalog warm (epoch build) in {time.perf_counter() - t0:.2f} s")
    try:
        thr = load_tag_thresholds(conn)
        check(served.core._thresholds == thr, "serve: thresholds")
        queries = _parity_queries()
        hits = 0
        for i, query in enumerate(queries):
            order_by = ORDERINGS[i % 4]
            limit, offset = ((1000, 0), (50, 7), (200, 0))[i % 3]
            route = (f"/search?q={urllib.parse.quote(query)}&order={order_by}&limit={limit}&offset={offset}")
            got = _http_json(served.base, route)["results"]
            sql = _sql_rows(conn, query, thr, order_by, limit, offset)
            check([(r["file_id"], r["path"]) for r in got] == [(r.file_id, r.path) for r in sql],
                  f"serve /search {query!r} {order_by}: rows differ from the SQL backend's")
            if order_by == "relevance":
                check(all(abs(r["relevance"] - s.relevance) <= 1e-9 for r, s in zip(got, sql)),
                      f"serve /search {query!r}: relevance differs from the SQL backend's")
            hits += len(got)
        batch = _http_json(served.base, "/search", {"queries": queries, "limit": 100, "offset": 3})["batches"]
        singles = [_http_json(served.base, f"/search?q={urllib.parse.quote(q)}&limit=100&offset=3")["results"]
                   for q in queries]
        check([b["results"] for b in batch] == singles and [b["query"] for b in batch] == queries,
              "serve: POST /search batch != the singles")
        print(f"serve /search: {len(queries)} queries equal the SQL backend row for row ({hits} rows); "
              f"the POST batch of {len(queries)} equals the singles")
        q = "tag_0000 OR tag_0001"
        route = f"/search?q={urllib.parse.quote(q)}&limit=50"
        http_ms = []
        for _ in range(50):
            t0 = time.perf_counter()
            _http_json(served.base, route)
            http_ms.append((time.perf_counter() - t0) * 1e3)
        epoch = served.core._manager.current
        local_ms = []
        for _ in range(50):
            t0 = time.perf_counter()
            engine.search_epoch(epoch, q, thresholds=thr, limit=50)
            local_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"serve /search {q!r} limit 50 at 20 000 files: HTTP p50 {np.percentile(http_ms, 50):.3f} ms "
              f"(p90 {np.percentile(http_ms, 90):.3f}), in-process search_epoch p50 {np.percentile(local_ms, 50):.3f} "
              f"ms (p90 {np.percentile(local_ms, 90):.3f}), host clock, 50 requests each")
    finally:
        served.close()
        conn.close()

    # 2. /dup?audit=1 on the dup CLI phase's catalog against ket dup --audit
    data = work / "dup_data"
    cfg = work / "dup_settings.yaml"
    export = work / "dup_export.csv"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        run_cli(["--config", str(cfg), "--data-dir", str(data), "--device", DEVICE, "dup", "--audit",
                 "--export", str(export)])
    cli_clusters: dict[int, list] = {}
    with export.open(newline="", encoding="utf-8") as fh:
        for row in csv.DictReader(fh):
            cli_clusters.setdefault(int(row["cluster"]), []).append((int(row["file_id"]), int(row["hamming"])))
    cli_summary = [line for line in err.getvalue().splitlines() if line.startswith(("audit:", "diameter:"))]
    db = data / "db" / "catalog.sqlite3"
    served = _Served(db, data_root=data)
    try:
        pairwise_hamming.launches = 0
        dup = _http_json(served.base, "/dup?audit=1&limit=100000")
        k5 = pairwise_hamming.launches
        got_clusters = [[(m["file_id"], m["hamming"]) for m in c["members"]] for c in dup["clusters"]]
        check(got_clusters == [cli_clusters[k] for k in sorted(cli_clusters)],
              "serve /dup clusters != ket dup --audit --export")
        conn = bootstrap(db)
        metas = [DuplicateFileMeta(file_id=int(r["id"]), path=Path(r["path"]), size=r["size"], width=r["width"],
                                   height=r["height"], phash=r["phash_u64"])
                 for r in iter_files_for_dup(conn) if r["phash_u64"] is not None]
        conn.close()
        want = audit_clusters(TpuDuplicateScanner(DuplicateScanConfig(), device=DEVICE).build_clusters(metas),
                              device=DEVICE)
        want_json = [{"keeper_id": s.keeper_id, "size": s.size, "diameter": s.diameter,
                      "mean_distance": round(s.mean_distance, 3), "keeper_max": s.keeper_max} for s in want]
        check(dup["audit"] == want_json, "serve /dup audit != audit_clusters of the CLI's clusters")
        check(summarize(want).splitlines()[:2] == cli_summary, "ket dup --audit summary != the audit")
        check(k5 > 0, "serve /dup?audit=1 launched no pairwise_hamming kernel")
        print(f"serve /dup?audit=1: {dup['total_clusters']} clusters and their audit equal ket dup --audit's "
              f"({cli_summary[0]}); pairwise_hamming launches {k5}; {dup['elapsed_ms']} ms in the server")
        refined = _http_json(served.base, "/dup?audit=1&refine=1")
        print(f"serve /dup?audit=1&refine=1: {refined['refined_clusters']} of {refined['total_clusters']} "
              f"clusters kept, {len(refined.get('audit', []))} audited")

        # 4. /delta and /reload after files are added, /trash, /file, /thumb
        health = _http_json(served.base, "/healthz")
        lib = work / "dup_library"
        sources = sorted(lib.glob("*.png"))[:3]
        new_paths = []
        for k, src in enumerate(sources):
            dst = lib / f"served_new_{k}.png"
            shutil.copyfile(src, dst)
            new_paths.append(dst)
        conn = bootstrap(db)
        new_ids = [upsert_file(conn, path=str(p), size=p.stat().st_size, mtime=p.stat().st_mtime)
                   for p in new_paths]
        write_tagging_batch(conn, [TaggingItem(file_id=f, tags=[("served_new", 0.875, 0)], tagger_sig="serve")
                                   for f in new_ids])
        conn.commit()
        conn.close()
        delta = _http_json(served.base, "/delta", {"changed_file_ids": new_ids})
        check(delta["epoch"] == health["epoch"] + 1 and delta["files"] == health["files"] + 3, f"/delta {delta}")
        found = {r["file_id"] for r in _http_json(served.base, "/search?q=served_new")["results"]}
        check(found == set(new_ids), f"/search after /delta: {found} != {new_ids}")
        reload = _http_json(served.base, "/reload", {})
        check(reload["epoch"] == delta["epoch"] + 1 and reload["files"] == delta["files"], f"/reload {reload}")
        trash = _http_json(served.base, "/trash", {"file_ids": [new_ids[0]]})
        check(trash["trashed"] == [new_ids[0]] and not new_paths[0].exists(), f"/trash {trash}")
        _http_json(served.base, "/reload", {})
        found = {r["file_id"] for r in _http_json(served.base, "/search?q=served_new")["results"]}
        check(found == set(new_ids[1:]), f"/search after /trash and /reload: {found}")
        info = _http_json(served.base, f"/file?id={new_ids[1]}")
        check(info["path"] == str(new_paths[1]) and [t["name"] for t in info["tags"]] == ["served_new"],
              f"/file {info}")
        status, ctype, body = _http(served.base, f"/thumb?id={new_ids[1]}&size=128")
        check(status == 200 and ctype == "image/webp" and len(body) > 0, f"/thumb: {status} {ctype}")
        thumb = Image.open(io.BytesIO(body))
        check(max(thumb.size) <= 128, f"/thumb size {thumb.size}")
        print(f"serve: /delta (+3 files) epoch {delta['epoch']}, /reload epoch {reload['epoch']}, /trash moved "
              f"1 file out of the next /search, /file and /thumb ({thumb.size[0]}x{thumb.size[1]} webp) answer")
    finally:
        served.close()

    # 3. /similar on the ANN phase's catalog against find_similar
    db = work / "data_ann" / "db" / "catalog.sqlite3"
    conn = bootstrap(db)
    ids, vecs = load_embeddings(conn)
    flat = FlatIndex(vecs, ids, device=DEVICE)
    served = _Served(db)
    try:
        for fid in [int(i) for i in ids[:: max(1, len(ids) // 5)][:5]]:
            got = _http_json(served.base, f"/similar?id={fid}&k=10")["results"]
            want = find_similar(flat, load_embedding(conn, fid), exclude_id=fid, k=10)
            check([(r["file_id"], r["score"]) for r in got] == [(f, round(s, 4)) for f, s in want],
                  f"serve /similar?id={fid} != find_similar")
        print(f"serve /similar: 5 files' 10 neighbours equal find_similar over {len(ids)} stored embeddings; "
              f"serve phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        served.close()
        conn.close()
    return k5


def _rows_agree(want: dict, got: dict, paths, tagger, tol: float) -> tuple[int, float, list]:
    """Two runs' tag rows of ``paths``: how many files agree bit for bit, the
    largest score difference of a tag both kept, and each tag one run kept
    and the other did not, with its score's distance from the nearer edge:
    its gate, or the lowest score the other run kept (the per-image cap of
    ``topk_cap`` tags binds on random weights)."""
    equal, max_d, flips = 0, 0.0, []
    for path in paths:
        a, b = dict(want[path]), dict(got[path])
        equal += int(sorted(a.items()) == sorted(b.items()))
        max_d = max([max_d] + [abs(a[n] - b[n]) for n in a.keys() & b.keys()])
        for name in a.keys() ^ b.keys():
            score, other = (a[name], b) if name in a else (b[name], a)
            gate = float(tagger._thr_vec_np[tagger._name_to_idx[name]])
            edge = min(other.values(), default=gate)
            flips.append((name, round(min(score - gate, abs(score - edge), key=abs), 6)))
    return equal, max_d, flips


def _catalog_top_tag(db: Path) -> tuple[str, int]:
    """The general tag an index run assigned most often, and to how many files."""
    from kobato_eyes_tpu_torch.db.connection import bootstrap

    conn = bootstrap(db)
    try:
        row = conn.execute("SELECT t.name, COUNT(*) FROM file_tags ft JOIN tags t ON t.id = ft.tag_id "
                           "WHERE t.category = 0 GROUP BY t.id ORDER BY COUNT(*) DESC, t.name LIMIT 1").fetchone()
    finally:
        conn.close()
    check(row is not None, "index run wrote no general tags")
    return row[0], int(row[1])


def _file_row(db: Path, path: Path) -> tuple:
    from kobato_eyes_tpu_torch.db.connection import bootstrap

    conn = bootstrap(db)
    try:
        return tuple(conn.execute("SELECT id, size, mtime, sha256, tagger_sig FROM files WHERE path = ?",
                                  (str(path),)).fetchone())
    finally:
        conn.close()



# ---------------------------------------------------------------------------
# Multi-device: every sharded path against the single-device path
# ---------------------------------------------------------------------------

MD_ENTRIES = 4  # mesh entries: the cards when there are several, else one card repeated
MD_ANN_N = 100_000
MD_QUERY_FILES = 20_000


def md_devices() -> list[str]:
    """Four mesh entries: distinct cards where there are several (round
    robin), else ``cuda:0`` four times (four shards, separate tensors)."""
    import torch

    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(MD_ENTRIES)]


def _md_tagger_phase(devices: list[str]) -> tuple[int, int, int]:
    """ViT-B/448 (8192 labels, seeded weights, the fast forward) at data=4
    and at data=2, model=2 against the single-device tagger on the same 32
    images: probabilities within the JAX test's 3e-2; every shard's tensors
    on its entry. Returns the kernel-1, GELU and sigmoid launches of the two
    sharded forwards."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.models.labels import synthetic_labels
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.ops import attention, gelu, xla_math
    from kobato_eyes_tpu_torch.parallel.mesh import make_mesh

    labels = synthetic_labels(N_LABELS)
    single = WD14Tagger(labels=labels, device=DEVICE)
    state = single._model.state_dict()
    rng = np.random.default_rng(51)
    batch = single.prepare_batch_from_rgb([rng.integers(0, 256, size=(448, 448, 3), dtype=np.uint8)
                                           for _ in range(BATCH)])
    want = single.forward_probs(batch)
    single_ms = cuda_ms(lambda: single.forward_probs(batch), iters=3)
    depth = single.cfg.depth
    totals = [0, 0, 0]
    for data, model in ((4, 1), (2, 2)):
        mesh = make_mesh(data=data, model=model, devices=devices)
        tagger = WD14Tagger(labels=labels, mesh=mesh, params=state)
        fwd = tagger._mesh_forward
        for r, row in enumerate(fwd.rows):
            for m, shard in enumerate(row):
                check(all(p.device == mesh.devices[r, m] for p in shard.parameters()),
                      f"tagger shard ({r}, {m}) off its entry {mesh.devices[r, m]}")
        check(fwd.split == ((1, 1, 1) if model == 1 else (2, 2, 2)), f"split {fwd.split} at {data}x{model}")
        attention.launches = gelu.launches = xla_math.launches = 0
        got = tagger.forward_probs(batch)
        synchronize()
        counts = (attention.launches, gelu.launches, xla_math.launches)
        expect = (data * model * depth if model > 1 else data * depth,) * 2 + (1,)
        check(counts == expect, f"tagger {data}x{model}: launches (attention, gelu, sigmoid) {counts} != {expect}")
        totals = [a + b for a, b in zip(totals, counts)]
        check(tuple(got.shape) == (BATCH, N_LABELS) and bool(torch.isfinite(got).all()), "sharded probs")
        dev = float((got - want).abs().max())
        ms = cuda_ms(lambda: tagger.forward_probs(batch), iters=3)
        results = tagger.infer_batch_prepared(batch)
        print(f"multidevice tagger vit-b448 data={data} model={model} on {devices}: max |dp| vs one device "
              f"{dev:.3e} (tol 3e-2), kernel-1 launches {counts[0]} (rows x model shards x {depth} layers), "
              f"gelu {counts[1]}, sigmoid {counts[2]}; forward {ms:.2f} ms vs one device {single_ms:.2f} ms; "
              f"{len(results)} results")
        check(dev <= 3e-2, f"tagger {data}x{model}: probabilities {dev} apart from one device")
        check(len(results) == BATCH, "sharded infer_batch_prepared")
        del tagger, fwd
    del single
    torch.cuda.empty_cache()
    return tuple(totals)


MD_TRAIN_STEPS = 3


def _md_train_phase(devices: list[str]) -> tuple[int, int]:
    """The sharded train step (``make_train_step(..., mesh=)``): ViT-B/16 @
    448, 8192 labels, ``train_phase``'s bf16 activations, from the trainer's
    seed-0 weights, batch 16 at data 2 x model 2 on the four entries, 3 steps
    on seeded images and multi-hot labels at 5%, beside the one-device step
    from the same weights on the same batches. Each loss finite and within
    1e-2 relative of one device's; after step 1 each tensor's gathered
    gradient norm within 0.98-1.02 of one device's (a sum over the rows taken
    for their mean reads 2) and max |dg| <= 3e-2 max |g|; after 3 steps max
    |dw| <= 6 lr (an Adam step moves a weight by about lr). Then both steps'
    ms (CUDA events, warm, mean of 5) and peak memory. Returns the sharded
    steps' GELU forward and backward launches (rows x shards x 12 layers a
    step each way)."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec
    from kobato_eyes_tpu_torch.models.train import TrainConfig, _init_model, make_train_step
    from kobato_eyes_tpu_torch.models.vit import vit_config
    from kobato_eyes_tpu_torch.ops import gelu
    from kobato_eyes_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    vcfg = vit_config("base", image_size=TRAIN_SIZE, num_classes=N_LABELS)
    spec = PreprocessSpec(mode="wd14", size=TRAIN_SIZE)
    train_cfg = TrainConfig()
    model = _init_model(vcfg)
    mesh = make_mesh(data=2, model=2, devices=devices)
    sharded, _ = make_train_step(vcfg, spec, train_cfg, model=model, mesh=mesh)  # placed copies of the weights
    single, _ = make_train_step(vcfg, spec, train_cfg, model=model, device=DEVICE)
    fwd = sharded.forward
    check(fwd.split == (2, 2, 2), f"sharded train split {fwd.split}")
    for r, row in enumerate(fwd.rows):
        for m, shard in enumerate(row):
            check(all(p.device == mesh.devices[r, m] for p in shard.parameters()),
                  f"train shard ({r}, {m}) off its entry {mesh.devices[r, m]}")
    rng = np.random.default_rng(71)
    batches = [(torch.from_numpy(rng.integers(0, 256, size=(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                                             dtype=np.uint8)).to(DEVICE),
                torch.from_numpy((rng.random((TRAIN_BATCH, N_LABELS)) < 0.05).astype(np.float32)).to(DEVICE))
               for _ in range(MD_TRAIN_STEPS)]

    gelu.launches = gelu.backward_launches = 0
    losses, grads = [], None
    for x, y in batches:
        losses.append(float(sharded(x, y)))
        if grads is None:
            grads = {k: v.float().clone() for k, v in sharded.gradients().items()}
    counts = (gelu.launches, gelu.backward_launches)
    expect = MD_TRAIN_STEPS * 2 * 2 * vcfg.depth
    check(counts == (expect, expect), f"sharded train: gelu launches (forward, backward) {counts} != {expect}")
    one_losses, one_grads = [], None
    for x, y in batches:
        one_losses.append(float(single(x, y)))
        if one_grads is None:
            one_grads = {k: p.grad.float().clone() for k, p in single.model.named_parameters()}

    check(all(np.isfinite(losses)), f"sharded train: losses {losses}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
    ratios, dg = {}, {}
    for name, want in one_grads.items():
        got = grads[name]
        ratios[name] = float(got.norm() / want.norm())
        dg[name] = float((got - want).abs().max() / want.abs().max())
    state, one_state = sharded.state_dict(), single.model.state_dict()
    dw = max(float((state[k].float() - v.float()).abs().max()) for k, v in one_state.items())
    worst_ratio = max(ratios, key=lambda k: abs(ratios[k] - 1.0))
    worst_dg = max(dg, key=dg.get)
    print(f"multidevice train vit-b448 batch {TRAIN_BATCH} data=2 model=2 on {devices}: losses "
          f"{' '.join(f'{v:.6f}' for v in losses)} vs one device {' '.join(f'{v:.6f}' for v in one_losses)} "
          f"(max rel {rel:.3e}, tol 1e-2); step-1 gradient norm ratio {min(ratios.values()):.5f}.."
          f"{max(ratios.values()):.5f} (worst {worst_ratio}), max |dg| / max |g| {dg[worst_dg]:.3e} ({worst_dg}, "
          f"tol 3e-2); after {MD_TRAIN_STEPS} steps max |dw| {dw:.3e} (tol {6 * train_cfg.learning_rate:.1e}); "
          f"gelu launches {counts[0]}, gelu backward {counts[1]}")
    check(rel <= 1e-2, f"sharded train: losses {rel} apart from one device (relative)")
    check(all(0.98 <= v <= 1.02 for v in ratios.values()), f"sharded train: gradient norm ratio {ratios[worst_ratio]} "
          f"({worst_ratio})")
    check(dg[worst_dg] <= 3e-2, f"sharded train: gradient {worst_dg} {dg[worst_dg]} apart")
    check(dw <= 6 * train_cfg.learning_rate, f"sharded train: weights {dw} apart after {MD_TRAIN_STEPS} steps")

    x, y = batches[0]
    torch.cuda.reset_peak_memory_stats()
    sharded_ms = cuda_ms(lambda: sharded(x, y), iters=5, warmup=2)
    sharded_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    single_ms = cuda_ms(lambda: single(x, y), iters=5, warmup=2)
    single_peak = torch.cuda.max_memory_allocated()
    print(f"multidevice train step vit-b448 batch {TRAIN_BATCH}: data=2 model=2 {sharded_ms:.2f} ms, one device "
          f"{single_ms:.2f} ms (CUDA events, warm, mean of 5); max_memory_allocated {sharded_peak / 2**30:.2f} / "
          f"{single_peak / 2**30:.2f} GiB (both steps resident); phase {time.perf_counter() - t0:.1f} s")
    del sharded, single, fwd, batches, grads, one_grads, state, one_state
    torch.cuda.empty_cache()
    return counts


def _md_dryrun_phase(devices: list[str]) -> tuple[int, int, int, int]:
    """``parallel.dryrun.dryrun_multichip`` over the four entries: its five
    checks (train, scan, query, ann, infer) at the JAX dry run's shapes.
    Returns its kernel-1, GELU, sigmoid and GELU backward launches: the
    train step's 2 rows x 2 shards x 2 layers each way; the infer check's
    exact forwards (the tiny preset's 48-wide heads take no kernel 1), one
    on one device (4 layers) and two sharded (2 x 2 x 4), a sigmoid each."""
    from kobato_eyes_tpu_torch.ops import attention, gelu, xla_math
    from kobato_eyes_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    attention.launches = gelu.launches = xla_math.launches = gelu.backward_launches = 0
    loss = dryrun_multichip(MD_ENTRIES, devices=devices)
    synchronize()
    counts = (attention.launches, gelu.launches, xla_math.launches, gelu.backward_launches)
    print(f"multidevice dry run over {devices}: train loss {loss:.6f}; launches (attention, gelu, sigmoid, "
          f"gelu backward) {counts}; {time.perf_counter() - t0:.1f} s")
    expect = (0, 2 * 2 * 2 + 4 + 2 * (2 * 2 * 4), 3, 2 * 2 * 2)
    check(counts == expect, f"dry run launches {counts} != {expect}")
    return counts


def _md_dup_phase(mesh) -> None:
    """The 70k dup population through the mesh-sharded scan against the
    single-device engine's host and device routes: clusters identical."""
    from pathlib import Path as _P

    import numpy as np

    from kobato_eyes_tpu_torch.bench import synth_hashes
    from kobato_eyes_tpu_torch.dup.engine import TpuDuplicateScanner, cluster_ids
    from kobato_eyes_tpu_torch.dup.types import DuplicateFileMeta, DuplicateScanConfig

    hashes = synth_hashes(N_DUP, DUP_SEED)
    sizes = np.random.default_rng(DUP_SEED + 1).integers(10_000, 5_000_000, size=N_DUP)
    files = [DuplicateFileMeta(file_id=i, path=_P(f"/bench/img_{i:07d}.png"), size=int(sizes[i]),
                               width=None, height=None, phash=int(hashes[i])) for i in range(N_DUP)]
    config = DuplicateScanConfig(hamming_threshold=8)
    host = cluster_ids(TpuDuplicateScanner(config, device=DEVICE).build_clusters(files))
    device = cluster_ids(TpuDuplicateScanner(config, device=DEVICE, host_scan_max=0).build_clusters(files))
    sharded = TpuDuplicateScanner(config, mesh=mesh)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        got = cluster_ids(sharded.build_clusters(files))
        synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"multidevice dup {N_DUP}: sharded over {dict(mesh.shape)} {len(got)} clusters, wall "
          f"{walls[0]:.1f} / {walls[1]:.1f} ms (first / warm); equal to the host and device routes")
    check(got == host == device and len(got) > 1000, "sharded dup clusters != the single-device routes")

    # the host/device crossover that KET_DUP_HOST_SCAN_MAX=probe derives on this host and card
    from kobato_eyes_tpu_torch.ops import hamming

    probe = hamming.probe_crossover(device=DEVICE)
    check(4096 <= probe["derived_host_scan_max"] <= 1 << 22, f"crossover probe {probe}")
    print(f"dup crossover probe: {json.dumps(probe)}")


def _md_query_phase(work: Path, mesh) -> None:
    """20 000 files: every parity query through ``search_epoch(mesh=)``
    against the single-device engine (ids and relevance), and an unshardable
    3-row mesh served on one device."""
    from kobato_eyes_tpu_torch.parallel.mesh import Mesh
    from kobato_eyes_tpu_torch.query import engine, sharded

    conn, nnz = _write_query_catalog(work / "multidevice" / "catalog.sqlite3", MD_QUERY_FILES, 2_000, seed=11)
    try:
        epoch = engine.build_epoch(conn, version=1, device=DEVICE)
    finally:
        conn.close()
    queries = _parity_queries()
    t_single = t_sharded = 0.0
    for i, query in enumerate(queries):
        kw = dict(thresholds=THRESHOLD_SETS[i % 3], order_by=ORDERINGS[i % 4], limit=200, offset=(0, 7)[i % 2])
        t0 = time.perf_counter()
        want = engine.search_epoch(epoch, query, **kw)
        t1 = time.perf_counter()
        got = engine.search_epoch(epoch, query, mesh=mesh, **kw)
        t_sharded += time.perf_counter() - t1
        t_single += t1 - t0
        check([(r.file_id, r.relevance) for r in got] == [(r.file_id, r.relevance) for r in want],
              f"sharded query {query!r} != one device")
    shards = sharded._shard_epoch(epoch, mesh).shards
    check(sum(int(s.rows_dev.numel()) for s in shards) == nnz, "row shards' postings")
    check(all(s.device == mesh.devices[r, 0] for r, s in enumerate(shards)), "row shards off their entries")
    odd = Mesh([[DEVICE]] * 3)
    want = engine.search_epoch(epoch, "tag_0000 OR tag_0001", limit=50)
    check(engine.search_epoch(epoch, "tag_0000 OR tag_0001", limit=50, mesh=odd) == want, "unshardable mesh")
    print(f"multidevice query: {MD_QUERY_FILES} files, {nnz} postings, n_pad {epoch.n_pad} over "
          f"{dict(mesh.shape)}: {len(queries)} queries equal one device's (ids, relevance); "
          f"{t_sharded / len(queries) * 1e3:.2f} ms a query sharded, {t_single / len(queries) * 1e3:.2f} ms on one "
          f"device; a 3-row mesh served on one device")


def _md_ann_phase(mesh) -> None:
    """Flat and IVF search at 100 000 x 512 (planted duplicate rows in
    different shards) row-sharded against one device: ids equal, ties
    lowest row first (held to the f64 evaluation as ``ann_phase`` holds
    the single index), IVF through a shared quantizer; sharded training's
    recall with every list probed."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.index.flat import FlatIndex
    from kobato_eyes_tpu_torch.index.ivf import IvfFlatIndex, kmeans, recall_at_k

    rng = np.random.default_rng(61)
    vecs = rng.standard_normal((MD_ANN_N, ANN_DIM)).astype(np.float32)
    src = rng.choice(MD_ANN_N, size=ANN_PLANTED, replace=False)
    for j, row in enumerate(src):  # each source copied to rows a shard apart
        for c in range(1, MD_ENTRIES):
            vecs[(row + c * MD_ANN_N // MD_ENTRIES + j) % MD_ANN_N] = vecs[row]
    unit = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-30)
    q = np.concatenate([unit[src[: ANN_QUERIES // 2]], rng.standard_normal((ANN_QUERIES // 2, ANN_DIM))]).astype(np.float32)
    single = FlatIndex(vecs, device=DEVICE)
    sharded = FlatIndex(vecs, mesh=mesh)
    check(all(s.device == mesh.devices[r, 0] for r, s in enumerate(sharded._corpus)), "flat shards off their entries")
    s0, i0 = single.search(q, k=ANN_K)
    s1, i1 = sharded.search(q, k=ANN_K)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    want_s, want_r = _f64_topk(torch.from_numpy(unit).to(DEVICE), torch.from_numpy(qn).to(DEVICE), ANN_K)
    ties, near = check_against_f64(i1, s1, want_s, want_r, "sharded flat")
    check(np.array_equal(i0, i1), "sharded flat ids != one device")
    check(np.allclose(s0, s1, rtol=1e-6, atol=0), "sharded flat scores != one device (rtol 1e-6)")
    flat_ms = (cuda_ms(lambda: single.search(q, k=ANN_K), iters=5), cuda_ms(lambda: sharded.search(q, k=ANN_K), iters=5))

    n_clusters = int(np.sqrt(MD_ANN_N))
    quant = kmeans(unit, n_clusters, iters=IVF_ITERS, seed=0, device=DEVICE)
    ivf0 = IvfFlatIndex(vecs, n_clusters=n_clusters, quantizer=quant, device=DEVICE)
    ivf1 = IvfFlatIndex(vecs, n_clusters=n_clusters, quantizer=quant, mesh=mesh)
    a, ia = ivf0.search(q, k=ANN_K, nprobe=IVF_NPROBE)
    b, ib = ivf1.search(q, k=ANN_K, nprobe=IVF_NPROBE)
    check(np.array_equal(ia, ib), "sharded IVF ids != one device")
    fin = np.isfinite(a)
    check(np.array_equal(fin, np.isfinite(b)) and np.allclose(a[fin], b[fin], rtol=1e-6, atol=0),
          "sharded IVF scores != one device")
    ivf_ms = (cuda_ms(lambda: ivf0.search(q, k=ANN_K, nprobe=IVF_NPROBE), iters=5),
              cuda_ms(lambda: ivf1.search(q, k=ANN_K, nprobe=IVF_NPROBE), iters=5))
    trained = IvfFlatIndex(vecs, n_clusters=n_clusters, mesh=mesh, train_iters=IVF_ITERS)
    recall_all = recall_at_k(trained.search(q, k=ANN_K, nprobe=trained.n_lists)[1], i0, k=ANN_K)
    recall = recall_at_k(trained.search(q, k=ANN_K, nprobe=IVF_NPROBE)[1], i0, k=ANN_K)
    check(recall_all == 1.0, f"sharded-trained IVF recall with every list probed {recall_all} != 1")
    print(f"multidevice ann {MD_ANN_N}x{ANN_DIM} over {dict(mesh.shape)}: flat ids equal one device's "
          f"({ties} tie groups lowest row first, {near} near-tie groups), search {flat_ms[1]:.3f} ms vs "
          f"{flat_ms[0]:.3f} ms on one device; IVF ({n_clusters} clusters, shared quantizer, nprobe "
          f"{IVF_NPROBE}) ids equal, {ivf_ms[1]:.3f} vs {ivf_ms[0]:.3f} ms; sharded training recall@{ANN_K} "
          f"{recall:.3f} at nprobe {IVF_NPROBE}, {recall_all:.3f} with every list")


def multidevice_phase(work: Path) -> tuple[int, int, int, int]:
    """The sharded paths on a four-entry mesh (``md_devices``) against the
    single-device paths: the tagger, the train step, the dup scan, the query
    engine, flat and IVF search; then the dry run. Returns the kernel-1,
    GELU, sigmoid and GELU backward launches of the tagger forwards, the
    train steps and the dry run."""
    from kobato_eyes_tpu_torch.parallel.mesh import make_mesh

    devices = md_devices()
    t0 = time.perf_counter()
    attn, act, sigmoid = _md_tagger_phase(devices)
    train_act, train_backward = _md_train_phase(devices)
    mesh = make_mesh(data=MD_ENTRIES, model=1, devices=devices)
    _md_dup_phase(mesh)
    _md_query_phase(work, mesh)
    _md_ann_phase(mesh)
    dry = _md_dryrun_phase(devices)
    print(f"multidevice phase: {time.perf_counter() - t0:.1f} s on {devices}")
    return attn + dry[0], act + train_act + dry[1], sigmoid + dry[2], train_backward + dry[3]


# ---------------------------------------------------------------------------
# The measuring entry points: kobato_eyes_tpu_torch.bench and tools/
# ---------------------------------------------------------------------------

# sizes the bench phase cuts from the tools' defaults (each printed, with
# its reason, on the line before the tool's JSON line)
BENCH_QUERY_REPEATS = 3
BENCH_E2E_IMAGES = 500
BENCH_PROFILE_IMAGES = 64
BENCH_COUNTERS = ("attention", "window", "layernorm", "gelu", "sigmoid")


def _bench_counters(reset: bool = False) -> dict[str, int]:
    """The launch counts of the kernels the tools run (kernel 1, kernel 3,
    kernel 4, the GELU pass, the sigmoid pass); ``reset`` sets them to 0."""
    from kobato_eyes_tpu_torch.ops import attention, gelu, layernorm_residual, window_attention, xla_math

    if reset:
        attention.launches = window_attention.launches = layernorm_residual.launches = 0
        gelu.launches = xla_math.launches = 0
    return dict(zip(BENCH_COUNTERS, (attention.launches, window_attention.launches,
                                     layernorm_residual.launches, gelu.launches, xla_math.launches)))


def run_tool(name: str, argv: list[str], cut: str = "") -> tuple[dict, dict[str, int]]:
    """``kobato_eyes_tpu_torch.<name>.main(argv)`` in this process with its
    standard output captured. Prints ``cut`` (a size cut from the tool's
    defaults, and why), the tool's JSON line, then its wall and launches;
    returns the document and the launches of the run."""
    import importlib

    module = importlib.import_module(f"kobato_eyes_tpu_torch.{name}")
    _bench_counters(reset=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    synchronize()
    wall = time.perf_counter() - t0
    counts = _bench_counters()
    docs = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    check(rc == 0, f"{name} {argv} exited {rc}")
    check(len(docs) == 1, f"{name} {argv} printed {len(docs)} JSON documents")
    if cut:
        print(cut)
    print(json.dumps(docs[0]))
    print(f"bench {name} {' '.join(argv)}: {wall:.1f} s, launches {counts}")
    return docs[0], counts


def _expect_launches(name: str, counts: dict[str, int], **want: int) -> None:
    for key, n in want.items():
        check(counts[key] == n, f"{name}: {key} launches {counts[key]} != {n}")


def bench_phase(work: Path) -> dict[str, int]:
    """The port's measuring entry points on the card, through the entry
    points a user calls: ``python -m kobato_eyes_tpu_torch.bench`` (the dup
    headline at 70 000 hashes) as a subprocess, then each of ``tools/`` in
    this process through its ``main``: ``bench_tagger`` (ViT-B/448 with the
    fast forward, and a small run under ``--profile`` whose trace
    ``trace_ops`` must read kernel 1 from), ``mfu_probe`` (einsum and SDPA),
    ``bench_swin`` (the window kernel, and with the residual LayerNorm
    kernel), ``bench_query`` at 70 000 files, ``bench_ann`` at 100 000 x 512
    and ``bench_e2e``. Checks every tool's exit, its one JSON document, the
    crossover probe, MFU in (0, 100%], exact kernel launches, 0 query
    mismatches (the tool asserts them), recall and the planted duplicates.
    Returns the phase's launches by counter (``BENCH_COUNTERS``)."""
    from kobato_eyes_tpu_torch.tools import trace_ops

    t_phase = time.perf_counter()
    total = dict.fromkeys(BENCH_COUNTERS, 0)

    def add(counts: dict[str, int]) -> None:
        for key in total:
            total[key] += counts[key]

    # the dup headline, as a user runs it (its own process)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "kobato_eyes_tpu_torch.bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"python -m kobato_eyes_tpu_torch.bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    docs = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    check(len(docs) == 1, f"python -m kobato_eyes_tpu_torch.bench printed {len(docs)} JSON documents")
    dup = docs[0]
    print(json.dumps(dup))
    print(f"bench python -m kobato_eyes_tpu_torch.bench: {wall:.1f} s")
    for line in proc.stderr.splitlines():
        if line.startswith(("warm ", "device-path ", "cold ")):
            print(f"  {line}")
    check(dup["metric"] == f"dup_scan_pairs_per_sec_{N_DUP // 1000}k", f"bench metric {dup['metric']}")
    check("error" not in dup["crossover_probe"], f"bench crossover probe failed: {dup['crossover_probe']}")
    check(dup["value"] > 0 and dup["vs_baseline"] > 0, "bench: no rate")

    # tagger throughput: 256 synthetic images at batch 32, so 8 batches: 4
    # latency batches (1 warm-up + 3), 7 timed, 1 counted forward
    depth, batches = 12, N_IMAGES // BATCH
    doc, counts = run_tool("tools.bench_tagger", [])
    forwards = min(batches, 4) + (batches - 1) + 1
    _expect_launches("bench_tagger", counts, attention=depth * forwards, gelu=depth * forwards,
                     sigmoid=forwards, window=0, layernorm=0)
    mfu = doc["roofline"]["mfu"]
    check(mfu is not None and 0 < mfu <= 1, f"bench_tagger MFU {mfu}")
    add(counts)
    prof = work / "bench_tagger_profile"
    _, counts = run_tool("tools.bench_tagger", ["--synthetic", str(BENCH_PROFILE_IMAGES), "--profile", str(prof)],
                         cut=f"bench_tagger --synthetic {BENCH_PROFILE_IMAGES} --profile: a second, small run "
                             "for the trace (the profiler's own cost stays out of the run above)")
    small = BENCH_PROFILE_IMAGES // BATCH
    forwards = min(small, 4) + (small - 1) + 1
    _expect_launches("bench_tagger --profile", counts, attention=depth * forwards)
    add(counts)
    rows = trace_ops.summarize(trace_ops.load_trace(prof), device="cuda")
    check(rows, "the bench_tagger trace holds no device events")
    wgmma = [(name, n) for name, _, n in rows if "attn_wgmma_kernel" in name]
    check(wgmma and sum(n for _, n in wgmma) == depth * (small - 1),
          f"trace_ops: kernel 1 in the bench_tagger trace {wgmma}")
    grand = sum(us for _, us, _ in rows)
    print(f"trace_ops: device events {sum(n for _, _, n in rows)}, total {grand / 1e3:.2f} ms")
    for name, us, n in rows[:6]:
        print(f"  {us / 1e3:9.2f} ms  {100 * us / grand:5.1f}%  x{n:<5d} {name}")

    # the forward probes: 1 first call + 3 warm + 3 chains of 20 forwards
    forwards = 1 + 3 + 3 * 20
    for argv in ([], ["--attn", "fused"]):
        doc, counts = run_tool("tools.mfu_probe", argv)
        _expect_launches("mfu_probe", counts, attention=0, gelu=depth * forwards, sigmoid=0)
        check(doc["mfu_pct"] is not None and 0 < doc["mfu_pct"] <= 100, f"mfu_probe {argv} MFU {doc['mfu_pct']}")
        add(counts)
    blocks = sum(SWIN_B448_DEPTHS)
    for argv, ln_launches in (([], 0), (["--ln", "pallas_residual"], 2 * blocks * forwards)):
        doc, counts = run_tool("tools.bench_swin", argv)
        _expect_launches("bench_swin", counts, window=blocks * forwards, layernorm=ln_launches,
                         gelu=blocks * forwards, attention=0)
        check(doc["mfu_pct"] is not None and 0 < doc["mfu_pct"] <= 100, f"bench_swin {argv} MFU {doc['mfu_pct']}")
        add(counts)

    # query latency at the tool's 70 000 files
    doc, counts = run_tool(
        "tools.bench_query", ["--repeats", str(BENCH_QUERY_REPEATS)],
        cut=f"bench_query --repeats {BENCH_QUERY_REPEATS} (the tool's default 20): at 70 000 files the "
            "SQL backend's queries would take most of the phase at 20 repeats")
    check(doc["files"] == 70_000 and doc["value"] > 0, f"bench_query {doc['files']} files")
    add(counts)

    # ANN at the tool's 100 000 x 512, the device structures
    doc, counts = run_tool(
        "tools.bench_ann", ["--skip-hnsw"],
        cut="bench_ann --skip-hnsw (the tool's own switch): the host's HNSW build at 100 000 x 512 would "
            "take tens of seconds of the phase; the ANN phase builds HNSW at 20 000")
    check(doc["flat"]["recall"] == 1.0 and doc["ivf"]["recall"] >= 0.9, f"bench_ann recall {doc['ivf']}")
    add(counts)

    # the whole system at batch 32 (the refresh adds 25 images: one more batch)
    doc, counts = run_tool(
        "tools.bench_e2e", ["--images", str(BENCH_E2E_IMAGES), "--workdir", str(work / "bench_e2e")],
        cut=f"bench_e2e --images {BENCH_E2E_IMAGES} (the tool's default 5000): generating and indexing 5000 "
            "images is host decode for minutes, past the phase's time")
    forwards = math.ceil(BENCH_E2E_IMAGES / BATCH) + math.ceil(25 / BATCH)
    _expect_launches("bench_e2e", counts, attention=depth * forwards, sigmoid=forwards)
    checks = doc["checks"]
    check(checks["indexed"]["tagged"] == BENCH_E2E_IMAGES, f"bench_e2e indexed {checks['indexed']}")
    check(checks["dup"]["planted_clustered"] == checks["dup"]["planted_pairs"], f"bench_e2e dup {checks['dup']}")
    check(checks["ann"]["flat_self_recall"] == 1.0, f"bench_e2e ann {checks['ann']}")
    add(counts)
    print(f"bench phase: {time.perf_counter() - t_phase:.1f} s, launches {total}")
    return total


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


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
    print(card_line())

    t_start = time.perf_counter()
    build_kernels()
    attn, attn_separate = attention_phase()
    window = window_attention_phase()
    ln = layernorm_residual_phase()
    act, act_backward = gelu_phase()
    flash_fwd, flash_dkv, flash_dq = flash_attention_phase()
    sigmoid = sigmoid_phase()
    hamming = pairwise_hamming_phase()
    kernels = [attn, attn_separate, window, ln, hamming, act, act_backward, sigmoid, flash_fwd, flash_dkv, flash_dq]
    work_root = REPO / "build"
    work_root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=work_root))
    try:
        lib, labels, cfg = write_workspace(work)
        attn["launches"], sep_vit, gelu_vit, sig_vit = slice_phase(work, lib, labels, cfg)
        window["launches"], sep_swin, ln["launches"], gelu_swin, sig_swin = swin_phase(work, lib, labels, cfg)
        query_cli_phase(work, lib, labels, cfg)
        hamming["launches"] = dup_scan_phase()
        dup_cli_phase(work)
        query_parity_phase(work)
        query_scale_phase()
        ann_launches, sep_ann = ann_phase(work, lib, labels)
        check(ann_launches == attn["launches"], "attention launches of the ANN index run")
        gelu_train, act_backward["launches"], train_attn = train_phase(work, lib)  # before upkeep changes the library
        flash_vit = flash_vit_phase()
        flash_fwd["launches"], flash_dkv["launches"], flash_dq["launches"] = flash_train_phase()
        flash_fwd["launches"] += flash_vit
        up_attn, up_window, sep_up = upkeep_phase(work, lib, labels, cfg)
        attn["launches"] += up_attn + train_attn
        window["launches"] += up_window
        attn_separate["launches"] = sep_vit + sep_swin + sep_ann + sep_up
        act["launches"] = gelu_vit + gelu_swin + gelu_train
        hamming["launches"] += serve_phase(work)
        bench = bench_phase(work)
        md_attn, md_gelu, md_sigmoid, md_gelu_backward = multidevice_phase(work)
        attn["launches"] += md_attn + bench["attention"]
        window["launches"] += bench["window"]
        ln["launches"] += bench["layernorm"]
        act["launches"] += md_gelu + bench["gelu"]
        act_backward["launches"] += md_gelu_backward
        sigmoid["launches"] = sig_vit + sig_swin + md_sigmoid + bench["sigmoid"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(card_line())  # again at the end, where a cut tail of the output still shows it
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
