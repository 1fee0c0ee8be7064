"""Command-line interface of the PyTorch/CUDA port.

Counterpart of ``kobato_eyes_tpu/cli.py`` for the commands ported so far:
``index`` (scan + tag + write), ``search`` over the SQL backend and
``validate-checkpoint`` (import -> exact-vs-fast parity -> tag flips). The
device query engine and the other commands come with later slices.

Usage: ``python -m kobato_eyes_tpu_torch.cli [--device cuda|cpu] <command> ...``
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

from kobato_eyes_tpu_torch.core.config.schema import Settings
from kobato_eyes_tpu_torch.core.config.service import load_settings
from kobato_eyes_tpu_torch.utils.paths import get_app_paths

logger = logging.getLogger(__name__)


def _setup_logging(verbose: bool) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


def _resolve_tagger(settings: Settings, device: str):
    """name -> tagger instance (reference core/pipeline/resolver.py:40)."""
    from kobato_eyes_tpu_torch.models.tagger import DummyTagger, PixaiTagger, WD14Tagger

    t = settings.tagger
    name = t.name.lower()
    if name == "dummy":
        return DummyTagger()
    cls = {"wd14": WD14Tagger, "pixai": PixaiTagger}.get(name)
    if cls is None:
        raise SystemExit(f"unknown tagger {t.name!r} (dummy | wd14 | pixai)")
    return cls(
        labels_path=t.labels_path,
        checkpoint_path=t.model_path,
        thresholds=t.thresholds,
        max_tags=t.max_tags,
        score_floor=t.score_floor,
        topk_cap=t.topk_cap,
        device=device,
    )


def _load_env(args) -> tuple[Settings, Path]:
    from kobato_eyes_tpu_torch.core.config.service import apply_env_overrides

    settings = apply_env_overrides(load_settings(args.config))
    paths = get_app_paths(args.data_dir or settings.data_dir).ensure()
    return settings, paths.db_path


def _progress_printer(progress) -> None:
    pct = f"{progress.fraction * 100:5.1f}%" if progress.total else "     "
    print(f"\r[{progress.phase.value:>6}] {pct} {progress.done}/{progress.total}",
          end="", file=sys.stderr, flush=True)


# -- commands ----------------------------------------------------------------


def cmd_index(args) -> int:
    settings, db = _load_env(args)
    if args.root:
        settings.pipeline.roots = [Path(r) for r in args.root]
    if not settings.pipeline.roots:
        raise SystemExit("no roots configured; pass --root or set pipeline.roots")
    from kobato_eyes_tpu_torch.core.pipeline import run_index_once

    tagger = _resolve_tagger(settings, args.device)
    stats = run_index_once(db, settings, tagger, progress=_progress_printer)
    print(file=sys.stderr)
    print(json.dumps(stats.__dict__, default=str))
    return 0


def cmd_search(args) -> int:
    if args.backend == "device":
        print("search --backend device: device query engine not yet ported; "
              "use --backend sql", file=sys.stderr)
        return 2
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import load_tag_thresholds, search_files
    from kobato_eyes_tpu_torch.query.ast import extract_positive_tag_terms
    from kobato_eyes_tpu_torch.query.sql import normalize_thresholds, translate_query

    queries: list[str] = args.query
    multi = len(queries) > 1
    conn = bootstrap(db)
    try:
        thresholds = load_tag_thresholds(conn)
        t0 = time.perf_counter()
        results = []
        for q in queries:
            frag = translate_query(q, thresholds=thresholds)
            rows = search_files(
                conn, frag.where, frag.params,
                positive_tags=extract_positive_tag_terms(q),
                thresholds=normalize_thresholds(thresholds),
                order_by=args.order, limit=args.limit, offset=args.offset,
            )
            if multi:
                print(f"# query: {q}")
            for r in rows:
                print(f"{r.relevance:8.3f}  {r.path}")
            results.extend(rows)
        elapsed = time.perf_counter() - t0
        print(f"{len(results)} results in {elapsed * 1000:.1f} ms", file=sys.stderr)
    finally:
        conn.close()
    return 0


def cmd_validate_checkpoint(args) -> int:
    """Import -> strict manifest -> exact-vs-fast forward parity -> tag parity
    at production thresholds; exit 0 iff everything holds (models/validate.py)."""
    if args.arch == "clip":
        print("validate-checkpoint --arch clip: the CLIP lane comes with the ANN slice "
              "of the port", file=sys.stderr)
        return 2
    from kobato_eyes_tpu_torch.models.validate import validate_checkpoint

    report = validate_checkpoint(
        args.checkpoint,
        arch=args.arch,
        preset=args.preset,
        image_size=args.image_size,
        classes=args.classes,
        labels_path=args.labels,
        n_images=args.images,
        prob_tolerance=args.tolerance,
        device=args.device,
    )
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="ket-torch", description=__doc__)
    parser.add_argument("--config", help="settings.yaml path")
    parser.add_argument("--data-dir", help="data directory override")
    parser.add_argument("--device", default="cuda",
                        help="torch device for the tagger (default cuda; 'cpu' to run without a GPU)")
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("index", help="scan + tag + write")
    p.add_argument("--root", action="append", help="scan root (repeatable)")
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("search", help="tag query search")
    p.add_argument("query", nargs="+")
    p.add_argument("--backend", choices=["device", "sql"], default="device")
    p.add_argument("--order", choices=["relevance", "mtime", "path", "id"], default="relevance")
    p.add_argument("--limit", type=int, default=200)
    p.add_argument("--offset", type=int, default=0)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser(
        "validate-checkpoint",
        help="import -> exact-vs-fast parity -> tag parity, one shot",
    )
    p.add_argument("checkpoint", help=".pth/.pt/.safetensors state dict")
    p.add_argument(
        "--arch", choices=["swinv2", "vit", "pixai", "clip"], default="swinv2",
        help="model family lane: WD14 backbones, the PixAI tagger "
             "(preprocess.json + ips propagation), or the CLIP embedder",
    )
    p.add_argument("--preset", default="base")
    p.add_argument("--image-size", type=int, default=448)
    p.add_argument("--classes", type=int, default=None,
                   help="label count when --labels is not given")
    p.add_argument("--labels", default=None, help="label CSV path")
    p.add_argument("--images", type=int, default=8,
                   help="synthetic validation images to run")
    p.add_argument("--tolerance", type=float, default=0.02,
                   help="max allowed exact-vs-fast probability deviation")
    p.add_argument("--clip-variant", choices=["openai", "open_clip"],
                   default="openai", help="tower convention for --arch clip")
    p.add_argument("--patch-size", type=int, default=32,
                   help="ViT patch size for --arch clip")
    p.set_defaults(fn=cmd_validate_checkpoint)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    _setup_logging(args.verbose)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
