"""Host decode+prepare ceiling for the cold tagging wall.

Counterpart of the repository's ``tools/bench_decode.py``. A cold
full-library index is paced by the host's decode, not by the card: this tool
measures that ceiling in isolation, on the same synthetic library that
``bench_e2e`` indexes, timing each stage of the input pipeline with no device
in the loop (it takes no ``--device``: nothing here touches a tensor on a
card) —

  decode        PIL open -> EXIF -> RGB array (utils.image_io.load_rgb_array)
  prepare       white letterbox + resize to the tagger input size
                (models.preprocess.letterbox_square_rgb)
  decode+prep   the loader's per-image path end-to-end, single thread
  loader        PrefetchLoader wall (thread pool + queue) over the corpus
  sha256        the scan stage's hashing cost per new file

The imgs/s of ``decode+prep`` is the cold-index ceiling on this host: no
pipeline overlap can index faster than the host can produce prepared
arrays. Prints ONE JSON document::

    python -m kobato_eyes_tpu_torch.tools.bench_decode [--images 1000]

``--workdir`` defaults to ``ket_e2e`` under the temporary directory
(``TMPDIR``), as ``bench_e2e``'s does, so the two share a generated library.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--images", type=int, default=1000,
                        help="corpus size (generated via bench_e2e's library)")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--target", type=int, default=448)
    parser.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "ket_e2e"))
    parser.add_argument("--io-workers", type=int, default=4)
    args = parser.parse_args(argv)

    from kobato_eyes_tpu_torch.models.preprocess import letterbox_square_rgb
    from kobato_eyes_tpu_torch.tools.bench_e2e import _gen_library
    from kobato_eyes_tpu_torch.utils.hashing import compute_sha256
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

    lib = Path(args.workdir) / f"lib_{args.images}_{args.seed}"
    info = _gen_library(lib, args.images, args.seed)
    paths = sorted(p for p in lib.iterdir() if p.suffix in (".png", ".jpg"))
    n = len(paths)
    assert n == info["n"], (n, info["n"])

    report: dict[str, object] = {"metric": "decode_ceiling", "images": n}

    # -- decode only ------------------------------------------------------
    t0 = time.perf_counter()
    arrays = [load_rgb_array(p) for p in paths]
    dt = time.perf_counter() - t0
    report["decode_s"] = round(dt, 2)
    report["decode_imgs_per_s"] = round(n / dt, 1)

    # -- prepare only (letterbox+resize on already-decoded arrays) ---------
    t0 = time.perf_counter()
    for a in arrays:
        letterbox_square_rgb(a, args.target)
    dt = time.perf_counter() - t0
    report["prepare_s"] = round(dt, 2)
    report["prepare_imgs_per_s"] = round(n / dt, 1)
    del arrays

    # -- decode + prepare, single thread (the per-image loader path) -------
    t0 = time.perf_counter()
    for p in paths:
        a = load_rgb_array(p)
        letterbox_square_rgb(a, args.target)
    dt = time.perf_counter() - t0
    report["decode_prepare_s"] = round(dt, 2)
    ceiling = n / dt
    report["decode_prepare_imgs_per_s"] = round(ceiling, 1)

    # -- the loader machinery (thread pool, queue, batching) ---------------
    from kobato_eyes_tpu_torch.core.pipeline.contracts import FileRecord
    from kobato_eyes_tpu_torch.core.pipeline.loaders import PrefetchLoader

    records = [
        FileRecord(file_id=i, path=p, size=p.stat().st_size,
                   mtime=p.stat().st_mtime)
        for i, p in enumerate(paths)
    ]
    loader = PrefetchLoader(
        records,
        prepare=lambda imgs: np.stack(
            [letterbox_square_rgb(a, args.target) for a in imgs]
        ),
        batch_size=32, prefetch_depth=4, io_workers=args.io_workers,
    )
    t0 = time.perf_counter()
    n_out = sum(len(b.records) for b in loader)
    dt = time.perf_counter() - t0
    report["loader_s"] = round(dt, 2)
    report["loader_imgs_per_s"] = round(n_out / dt, 1)

    # -- scan-stage hashing cost -------------------------------------------
    t0 = time.perf_counter()
    for p in paths[: min(500, n)]:
        compute_sha256(p)
    dt = time.perf_counter() - t0
    report["sha256_imgs_per_s"] = round(min(500, n) / dt, 1)

    # ceiling verdict vs the reference's cold walls (BASELINE.md)
    report["ceiling_vs_reference"] = {
        "pixai_23_imgs_per_s": round(ceiling / 23.0, 2),
        "wd14_58_imgs_per_s": round(ceiling / 58.0, 2),
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
