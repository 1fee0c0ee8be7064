"""MFU probe: time ViT-B/448 forward variants on the card.

Counterpart of the repository's ``tools/mfu_probe.py``: times a ViT-B/16 @
448 forward (normalisation + model, random weights from seed 0) by variant
and can capture a trace (``--profile DIR``) that
``python -m kobato_eyes_tpu_torch.tools.trace_ops DIR`` summarizes.

Variants: ``--attn einsum`` (the exact f32-logit attention) or ``fused``
(``F.scaled_dot_product_attention``, the counterpart of the JAX package's
XLA attention); ``--bf16-params`` (inference-only bf16 weights); ``--batch``.
``--unroll`` is the JAX package's ``nn.scan`` unroll factor: the port's
layers are a Python loop, so it changes nothing here (it is kept in the
flags and in the ``variant`` echo so that runs read alike).

Timing: ``--repeats`` forwards are queued back to back and the chain ends
with ``torch.cuda.synchronize``; the least of three chains is kept.
``mfu_pct`` holds the analytic FLOPs against the card's published bf16 peak
(``utils/profiling.PEAK_BF16_FLOPS``; a card missing from it raises); it is
null on the CPU, which has no device rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.models.vit import vit_config


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--unroll", type=int, default=1)
    parser.add_argument("--attn", choices=["einsum", "fused"], default="einsum")
    parser.add_argument("--bf16-params", action="store_true")
    parser.add_argument("--labels", type=int, default=9083)
    parser.add_argument("--profile", metavar="DIR")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from kobato_eyes_tpu_torch.bench import synchronize
    from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec, normalize_on_device
    from kobato_eyes_tpu_torch.models.vit import ViT, init_vit_, vit_forward_flops
    from kobato_eyes_tpu_torch.utils.profiling import device_trace, peak_flops_for

    cfg = vit_config(
        "base", image_size=448, num_classes=args.labels,
        unroll=args.unroll, attn_impl=args.attn,
    )
    model = init_vit_(ViT(cfg), torch.Generator().manual_seed(0))
    if args.bf16_params:  # as the tagger's knob: every f32 parameter stored in bf16
        with torch.no_grad():
            for param in model.parameters():
                if param.dtype == torch.float32:
                    param.data = param.data.to(torch.bfloat16)
    model = model.to(device).eval().requires_grad_(False)
    spec = PreprocessSpec(mode="wd14", size=cfg.image_size)

    def fwd(xb: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(normalize_on_device(xb, spec))

    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.integers(0, 256, (args.batch, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    ).to(device)

    t0 = time.perf_counter()
    fwd(x)
    synchronize(device)  # first call: kernel build and load
    compile_s = time.perf_counter() - t0

    # Timed: queue n forwards, then wait once for the chain
    def timed_chain(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fwd(x)
        synchronize(device)
        return (time.perf_counter() - t0) / n

    timed_chain(3)  # warm the dispatch path
    with device_trace(args.profile):
        per_batch = min(timed_chain(args.repeats) for _ in range(3))

    flops = vit_forward_flops(cfg, args.batch)
    peak = peak_flops_for(device)
    tf = flops / per_batch / 1e12
    print(json.dumps({
        "variant": {
            "batch": args.batch, "unroll": args.unroll, "attn": args.attn,
            "bf16_params": bool(args.bf16_params), "labels": args.labels,
        },
        "ms_per_batch": round(per_batch * 1e3, 2),
        "imgs_per_s": round(args.batch / per_batch, 1),
        "tflops_per_s": round(tf, 1),
        "mfu_pct": round(100 * flops / per_batch / peak, 1) if peak else None,
        "compile_s": round(compile_s, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
