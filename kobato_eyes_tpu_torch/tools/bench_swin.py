"""SwinV2 MFU probe: time SwinV2-B/448 forward variants on the card.

Counterpart of the repository's ``tools/bench_swin.py``: times a SwinV2
forward (normalisation + model, random weights from seed 0) by variant:

  --attn einsum|pallas      window attention: the exact einsum, or the
                            hand-written CUDA window kernel
                            (ops/window_attention.py)
  --ln xla|pallas_residual  post-norm LayerNorm: torch ops, or the CUDA
                            residual LayerNorm kernel
                            (ops/layernorm_residual.py)
  --qk default|bf16|highest QK product precision inside the window kernel
  --act gelu|gelu_tanh      the MLP activation

Timing: ``--repeats`` forwards are queued back to back and the chain ends
with ``torch.cuda.synchronize``; the least of three chains is kept.
``mfu_pct`` holds ``swin_forward_flops`` against the card's published bf16
peak (``utils/profiling.PEAK_BF16_FLOPS``; a card missing from it raises);
it is null on the CPU, which has no device rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--attn", choices=["einsum", "pallas"], default="pallas")
    parser.add_argument("--ln", choices=["xla", "pallas_residual"], default="xla")
    parser.add_argument("--qk", choices=["default", "bf16", "highest"], default="default")
    parser.add_argument("--act", choices=["gelu", "gelu_tanh"], default="gelu_tanh")
    parser.add_argument("--preset", default="base")
    parser.add_argument("--image-size", type=int, default=448)
    parser.add_argument("--labels", type=int, default=9083)
    parser.add_argument("--profile", metavar="DIR")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from kobato_eyes_tpu_torch.bench import synchronize
    from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec, normalize_on_device
    from kobato_eyes_tpu_torch.models.swin import (
        SwinV2,
        init_swin_,
        swin_config,
        swin_forward_flops,
    )
    from kobato_eyes_tpu_torch.utils.profiling import device_trace, peak_flops_for

    cfg = swin_config(
        args.preset, image_size=args.image_size, num_classes=args.labels,
        attn_impl=args.attn, act=args.act, qk_precision=args.qk,
        ln_impl=args.ln,
    )
    model = init_swin_(SwinV2(cfg), torch.Generator().manual_seed(0))
    model = model.to(device).eval().requires_grad_(False)
    spec = PreprocessSpec(mode="wd14", size=args.image_size)

    def fwd(xb: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(normalize_on_device(xb, spec))

    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.integers(0, 256, (args.batch, args.image_size, args.image_size, 3), dtype=np.uint8)
    ).to(device)

    t0 = time.perf_counter()
    fwd(x)
    synchronize(device)  # first call: kernel build and load
    compile_s = time.perf_counter() - t0

    def timed_chain(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fwd(x)
        synchronize(device)
        return (time.perf_counter() - t0) / n

    timed_chain(3)  # warm the dispatch path
    with device_trace(args.profile):
        per_batch = min(timed_chain(args.repeats) for _ in range(3))

    flops = swin_forward_flops(cfg, args.batch)
    peak = peak_flops_for(device)
    print(json.dumps({
        "variant": {
            "batch": args.batch, "attn": args.attn, "ln": args.ln,
            "qk": args.qk, "act": args.act, "labels": args.labels,
        },
        "ms_per_batch": round(per_batch * 1e3, 2),
        "imgs_per_s": round(args.batch / per_batch, 1),
        "tflops_per_s": round(flops / per_batch / 1e12, 1),
        "mfu_pct": round(100 * flops / per_batch / peak, 1) if peak else None,
        "compile_s": round(compile_s, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
