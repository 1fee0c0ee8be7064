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
  tagger's saved weights.

Each kernel's launch count is set to 0 just before the path that runs it
and read just after. It checks each tagger's fast forward against its exact
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

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate and the bf16
# tensor-core rate. The attention kernel's bound uses these.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

VIT_B448 = dict(batch=32, tokens=785, heads=12, head_dim=64)
# SwinV2-B/448 window attention per stage: (windows per image, heads); every
# stage has n = 7*7 tokens per window and head_dim 32
SWIN_B448_STAGES = ((256, 4), (64, 8), (16, 16), (4, 32))
SWIN_B448_DEPTHS = (2, 2, 18, 2)
SWIN_WINDOW = 7
N_IMAGES = 256
BATCH = 32
N_LABELS = 8192


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


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


def attention_phase() -> dict:
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
        print(f"attention {name}: max_abs_err={err:.3e} (tol {tol:g})")
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
    return {
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

    def compare(name, qkv, scale, bias, mask, tol, qk_precision="default"):
        got = wa.windowed_cosine_attention_packed(qkv, scale, bias, mask, qk_precision=qk_precision)
        want = wa.windowed_cosine_attention_packed_plain(qkv, scale, bias, mask, qk_precision=qk_precision)
        torch.cuda.synchronize()
        check(got.dtype == qkv.dtype and got.shape == want.shape, f"window {name}: dtype/shape")
        check(bool(torch.isfinite(got).all()), f"window {name}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        print(f"window attention {name}: max_abs_err={err:.3e} (tol {tol:g})")
        check(err <= tol, f"window {name}: max_abs_err {err} > {tol}")
        return err

    b, n, hd = BATCH, SWIN_WINDOW**2, 32
    errs = []
    main = {}
    for stage in (0, 2):
        nw, h = SWIN_B448_STAGES[stage]
        for masked in (False, True):
            ins = _window_inputs(b, nw, n, h, hd, torch.bfloat16, 10 + stage, masked)
            # bf16 output: one bf16 rounding of |out| <= ~4 is 2^-6
            errs.append(compare(f"swinv2-b448 stage {stage} bf16 {'masked' if masked else 'unmasked'}",
                                *ins, 3e-2))
            if masked:
                main[stage] = ins
    # f32: 5e-5, the JAX package's kernel tolerance (sums in another order)
    compare("f32 stage 1 masked B=4", *_window_inputs(4, 64, n, 8, hd, torch.float32, 20, True), 5e-5)
    compare("n=196 f32 masked", *_window_inputs(2, 4, 196, 2, 32, torch.float32, 21, True), 5e-5)
    compare("n=196 hd=16 bf16", *_window_inputs(2, 4, 196, 3, 16, torch.bfloat16, 22, False), 3e-2)
    compare("qk_precision=bf16 f32", *_window_inputs(2, 16, n, 4, hd, torch.float32, 23, True), 5e-5,
            qk_precision="bf16")
    # production bounds: clamped scale 100, CPB bias at its 16 ceiling, one
    # window masked off the diagonal: rows survive on the diagonal only
    qkv, _, _, _ = _window_inputs(1, 4, 196, 2, 32, torch.float32, 2, False)
    scale = torch.full((2,), 100.0, device=dev)
    bias = torch.full((2, 196, 196), 16.0, device=dev)
    mask_np = np.zeros((4, 196, 196), np.float32)
    mask_np[0] = -100.0
    for i in range(196):
        mask_np[0, i, i] = 0.0
    compare("production bounds f32", qkv, scale, bias, torch.from_numpy(mask_np).to(dev), 5e-4)

    rows = []
    for stage in (0, 2):
        qkv, scale, bias, mask = main[stage]
        nw, h = SWIN_B448_STAGES[stage]
        ms = cuda_ms(lambda: wa.windowed_cosine_attention_packed(qkv, scale, bias, mask), iters=20)
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
        flops = 4.0 * n * n * hd * b * nw * h
        bytes_moved = (qkv.numel() + b * nw * n * h * hd) * qkv.element_size() + (bias.numel() + mask.numel()) * 4
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        print(
            f"window attention swinv2-b448 stage {stage} bf16 B={b} nW={nw} H={h}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa call alone {library_ms:.4f} ms, "
            f"bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP, {bytes_moved / 1e6:.1f} MB, "
            f"{'bytes' if t_bytes >= t_ops else 'operations'})"
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

    def compare(name, x, res, gamma, beta):
        got = lnr.layernorm_residual(x, res, gamma, beta)
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
        print(f"layernorm_residual {name}: max_abs_err={err:.3e} (tol {tol})")
        check(ok, f"ln {name}: max_abs_err {err} over {tol}")
        return err

    errs = []
    main = {}
    for rows, c in ((401408, 128), (6272, 1024)):
        for dtype in (torch.bfloat16, torch.float32):
            ins = inputs(rows, c, dtype, seed=c)
            err = compare(f"({rows}, {c}) {str(dtype).split('.')[-1]}", *ins)
            if dtype == torch.bfloat16:
                errs.append(err)
                main[c] = ins
    compare("(4096, 100) f32", *inputs(4096, 100, torch.float32, 3))
    compare("(4096, 100) bf16", *inputs(4096, 100, torch.bfloat16, 4))

    rows_out = []
    for c in (128, 1024):
        x, res, gamma, beta = main[c]
        ms = cuda_ms(lambda: lnr.layernorm_residual(x, res, gamma, beta), iters=20)
        plain_ms = cuda_ms(lambda: lnr.layernorm_residual_plain(x, res, gamma, beta), iters=5)
        g16, b16 = gamma.to(x.dtype), beta.to(x.dtype)
        # yardstick: two calls, F.layer_norm then the residual add
        library_ms = cuda_ms(
            lambda: res + torch.nn.functional.layer_norm(x, (x.shape[-1],), g16, b16, 1e-5), iters=20
        )
        bytes_moved = 3 * x.numel() * x.element_size() + 2 * gamma.numel() * 4
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = 8.0 * x.numel() / BF16_FLOPS_PER_S * 1e3
        print(
            f"layernorm_residual ({x.shape[0]}, {c}) bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"layer_norm + add (two calls) {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({bytes_moved / 1e6:.1f} MB, {'bytes' if t_bytes >= t_ops else 'operations'})"
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


def slice_phase(work: Path, lib: Path, labels: Path, cfg: Path) -> int:
    """ViT index + search through the CLI; returns the attention launches of
    the index run."""
    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.ops import attention

    data = work / "data"
    base = ["--config", str(cfg), "--data-dir", str(data), "--device", "cuda"]
    attention.launches = 0
    t0 = time.perf_counter()
    out = run_cli(base + ["index"])
    wall = time.perf_counter() - t0
    launches = attention.launches
    stats = json.loads(out.strip().splitlines()[-1])
    print_index_stats("vit-b448", stats, wall, f"attention_launches={launches}")
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
    return launches


def swin_phase(work: Path, lib: Path, labels: Path, cfg: Path) -> tuple[int, int]:
    """SwinV2-B/448: index through ``run_index_once``, search through the CLI,
    fast / exact / residual-LN forwards, then ``validate-checkpoint`` through
    the CLI on the index tagger's weights. Returns the window-kernel launches
    of the index run and the LN-kernel launches of the residual-LN batch."""
    import dataclasses

    import numpy as np
    import torch

    from kobato_eyes_tpu_torch.core.config.service import load_settings
    from kobato_eyes_tpu_torch.core.pipeline import run_index_once
    from kobato_eyes_tpu_torch.models.labels import load_labels
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.ops import layernorm_residual, window_attention
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

    t0 = time.perf_counter()
    fast = WD14Tagger(arch="swinv2", labels_path=labels, device="cuda")
    check(fast.cfg.attn_impl == "pallas" and fast.cfg.ln_impl == "xla", "swinv2 fast_math knobs")
    print(f"swinv2-b448 tagger: seeded init + upload in {time.perf_counter() - t0:.1f} s")
    data = work / "data_swin"
    (data / "db").mkdir(parents=True)
    window_attention.launches = 0
    layernorm_residual.launches = 0
    t0 = time.perf_counter()
    stats = run_index_once(data / "db" / "catalog.sqlite3", load_settings(cfg), fast).__dict__
    wall = time.perf_counter() - t0
    win_launches, ln_launches = window_attention.launches, layernorm_residual.launches
    print_index_stats("swinv2-b448", stats, wall,
                      f"window_launches={win_launches} ln_launches={ln_launches}")
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
    return win_launches, ln_launches


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
    attn = attention_phase()
    window = window_attention_phase()
    ln = layernorm_residual_phase()
    work_root = REPO / "build"
    work_root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=work_root))
    try:
        lib, labels, cfg = write_workspace(work)
        attn["launches"] = slice_phase(work, lib, labels, cfg)
        window["launches"], ln["launches"] = swin_phase(work, lib, labels, cfg)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [attn, window, ln]}))
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
