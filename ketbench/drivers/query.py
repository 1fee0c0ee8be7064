"""Tag query traffic: one client in a closed loop against a catalog's epoch.

Set-up draws a catalog from the seed: ``files`` files, each with one rating,
about ``general_per_file`` general tags and ``character_per_file`` character
tags drawn by Zipf popularity (exponent ``zipf``) over the configuration's
labels, scores at or above the category's threshold as the tagger stores
them (float32 values), mtimes in whole seconds over ``mtime_span`` (so that
ties fall to the file id). It fills the port's schema (``bootstrap``) with
bulk ``executemany`` rows equal to what ``write_tagging_batch`` writes, and
builds the epoch with ``build_epoch``.

Queries come from a pool of ``query_pool``: 1-4 terms joined by implicit or
explicit AND, OR, parenthesised OR groups, ``-`` / ``NOT``, ``category:`` and
``score>=`` terms, tags drawn by popularity and ``unknown_share`` of tag terms
unknown, each in the shares the mix states (its ``origin`` says where each
share comes from). The pool's shapes and popularity ranks are the same for every seed;
the seed decides which label holds which rank and the order of the pool. The
window answers them in turn through ``search_epoch`` (``order_by``,
``limit``); ``check_answers`` answers drawn from the seed are held to the
NumPy reference.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from ketbench import weights
from ketbench.core import RunContext, RunRecord
from ketbench.reference.query import Catalog

STRUCTURE_STREAM = 77031  # fixed: the pool's shapes do not depend on the seed
CATEGORY_WORDS = {"general": 0, "rating": 2, "character": 4}


def zipf_weights(n: int, exponent: float) -> np.ndarray:
    w = 1.0 / (np.arange(n) + 2.0) ** exponent
    return w / w.sum()


def generate_catalog(seed_words: list[int], mix: dict, cats: np.ndarray) -> dict:
    """Postings (row, label, float32 score) and the files' mtimes, sizes
    and paths, from the seed."""
    rng = np.random.default_rng([*seed_words, 10])
    n = mix["files"]
    general = np.nonzero(cats == 0)[0]
    character = np.nonzero(cats == 4)[0]
    rating = np.nonzero(cats == 2)[0]
    thresholds = {0: 0.35, 4: 0.25, 2: 0.1}
    rank_general = rng.permutation(general)  # rank r is label rank_general[r]
    rank_character = rng.permutation(character)
    rows, labels = [np.arange(n)], [rng.choice(rating, size=n, p=mix["rating_shares"])]
    for ranked, per_file in ((rank_general, mix["general_per_file"]), (rank_character, mix["character_per_file"])):
        counts = rng.poisson(per_file, n)
        draws = rng.choice(len(ranked), size=int(counts.sum()), p=zipf_weights(len(ranked), mix["zipf"]))
        rows.append(np.repeat(np.arange(n), counts))
        labels.append(ranked[draws])
    key = np.unique(np.concatenate(rows).astype(np.int64) * len(cats) + np.concatenate(labels))
    row, label = (key // len(cats)).astype(np.int32), (key % len(cats)).astype(np.int32)
    floor = np.array([thresholds[int(c)] for c in cats], dtype=np.float64)[label]
    u = rng.random(len(label))
    scores = (floor + (0.999 - floor) * u * u).astype(np.float32)
    mtimes = 1.6e9 + rng.integers(0, mix["mtime_span"], n).astype(np.float64)
    sizes = rng.integers(50_000, 8_000_000, n)
    paths = [f"/library/{i % 64:02d}/{i:07d}.jpg" for i in range(n)]
    return {"rows": row, "labels": label, "scores": scores, "mtimes": mtimes, "sizes": sizes,
            "paths": paths, "rank_general": rank_general, "rank_character": rank_character}


def fill_catalog(db: Path, catalog: dict, names: list[str], cats: np.ndarray, *, tagger_sig: str = "ketbench") -> None:
    """The catalog's rows, in bulk: files, the tags that occur, file_tags.
    The schema's indexes on those tables are dropped for the inserts and
    made again from their own statements after, so that each is built in
    one sorted pass rather than row by row. This connection alone skips the
    foreign-key lookups (the rows refer to each other by construction, as a
    test holds) and the disk syncs (the catalog is the run's scratch)."""
    from kobato_eyes_tpu_torch.db.connection import bootstrap

    now = time.time()
    conn = bootstrap(db)
    try:
        conn.execute("PRAGMA foreign_keys = OFF")
        conn.execute("PRAGMA synchronous = OFF")
        used = np.unique(catalog["labels"])
        indexes = conn.execute(
            "SELECT name, sql FROM sqlite_master WHERE type = 'index' AND sql IS NOT NULL "
            "AND tbl_name IN ('files', 'tags', 'file_tags') ORDER BY name").fetchall()
        with conn:
            for name, _ in indexes:
                conn.execute(f'DROP INDEX "{name}"')
            conn.executemany(
                "INSERT INTO files (id, path, size, mtime, tagger_sig, last_tagged_at, is_present, "
                "created_at, updated_at) VALUES (?, ?, ?, ?, ?, ?, 1, ?, ?)",
                [(i + 1, p, int(s), float(m), tagger_sig, now, now, now)
                 for i, (p, s, m) in enumerate(zip(catalog["paths"], catalog["sizes"], catalog["mtimes"]))],
            )
            conn.executemany("INSERT INTO tags (id, name, category) VALUES (?, ?, ?)",
                             [(int(j) + 1, names[j], int(cats[j])) for j in used])
            conn.executemany(
                "INSERT INTO file_tags (file_id, tag_id, score) VALUES (?, ?, ?)",
                zip((catalog["rows"] + 1).tolist(), (catalog["labels"] + 1).tolist(),
                    catalog["scores"].astype(np.float64).tolist()),
            )
            for _, sql in indexes:
                conn.execute(sql)
    finally:
        conn.close()


def make_pool(mix: dict, catalog: dict, names: list[str]) -> list[tuple[str, tuple]]:
    """(text, tree) queries; shapes and ranks from a fixed stream."""
    rng = np.random.default_rng(STRUCTURE_STREAM)
    ranked = {0: catalog["rank_general"], 4: catalog["rank_character"]}
    weights_by_cat = {c: zipf_weights(len(r), mix["zipf"]) for c, r in ranked.items()}

    def term() -> tuple[str, tuple]:
        r = rng.random()
        if r < mix["category_share"]:
            word = str(rng.choice(mix["category_words"]))
            return f"category:{word}", ("cat", CATEGORY_WORDS[word])
        if r < mix["category_share"] + mix["score_share"]:
            t = float(rng.choice(mix["score_values"]))
            return f"score>={t}", ("score", ">=", t)
        if rng.random() < mix["unknown_share"]:
            name = f"unknown_tag_{int(rng.integers(0, 100000))}"
        else:
            cat = 4 if rng.random() < mix["character_term_share"] else 0
            rank = int(rng.choice(len(ranked[cat]), p=weights_by_cat[cat]))
            name = names[ranked[cat][rank]]
        return name, ("tag", name)

    def negated(text: str, tree: tuple) -> tuple[str, tuple]:
        if rng.random() < mix["not_share"]:
            return (f"-{text}" if rng.random() < 0.7 else f"NOT {text}"), ("not", tree)
        return text, tree

    def factor() -> tuple[str, tuple, int]:
        if rng.random() < mix["group_share"]:
            (a, ta), (b, tb) = term(), term()
            text, tree = negated(f"( {a} OR {b} )", ("or", ta, tb))
            return text, tree, 2
        text, tree = negated(*term())
        return text, tree, 1

    def chain(budget: int) -> tuple[str, tuple, int]:
        text, tree, used = factor()
        while used < budget:
            t2, tr2, u2 = factor()
            if used + u2 > budget:
                break
            joiner = " AND " if rng.random() < mix["explicit_and_share"] else " "
            text, tree, used = f"{text}{joiner}{t2}", ("and", tree, tr2), used + u2
        return text, tree, used

    pool = []
    for _ in range(mix["query_pool"]):
        terms = int(rng.choice([1, 2, 3, 4], p=mix["terms_shares"]))
        if terms >= 2 and rng.random() < mix["or_share"]:
            left = int(rng.integers(1, terms))
            a, ta, _ = chain(left)
            b, tb, _ = chain(terms - left)
            pool.append((f"{a} OR {b}", ("or", ta, tb)))
        else:
            text, tree, _ = chain(terms)
            pool.append((text, tree))
    return pool


def run(ctx: RunContext) -> RunRecord:
    import torch

    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.query.engine import build_epoch, search_epoch

    cfg, mix, device = ctx.config, ctx.traffic, ctx.device
    names, cats = weights.label_table(cfg)
    seed_words = ctx.seed_words()
    with ctx.part("postings"):
        catalog = generate_catalog(seed_words, mix, cats)
        pool = make_pool(mix, catalog, names)
    order = np.random.default_rng([*seed_words, 11]).permutation(len(pool))
    workdir = Path(tempfile.mkdtemp(prefix="ketbench_query_"))
    try:
        db = workdir / "catalog.sqlite"
        with ctx.part("fill"):
            fill_catalog(db, catalog, names, cats)
        with ctx.part("epoch"):
            conn = bootstrap(db)
            try:
                epoch = build_epoch(conn, device=device)
            finally:
                conn.close()
        sizes = {"postings": int(len(catalog["labels"])), "files": mix["files"]}

        def ask(i: int) -> list[int]:
            text = pool[order[i % len(pool)]][0]
            with ctx.span("search"):
                found = search_epoch(epoch, text, order_by=mix["order_by"], limit=mix["limit"])
            return ctx.apply_fault("query_ids", [r.file_id for r in found])

        with ctx.part("warm"):
            for i in range(mix["warm_queries"]):
                ask(i)
        ctx.host_spans.clear()
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        answers: list[tuple[int, list[int]]] = []
        times: list[float] = []
        with ctx.window():
            t_end = time.perf_counter() + ctx.seconds
            i = 0
            while time.perf_counter() < t_end:
                t0 = time.perf_counter()
                ids = ask(i)
                times.append(time.perf_counter() - t0)
                answers.append((int(order[i % len(pool)]), ids))
                i += 1
        peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
        del epoch
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    with ctx.span("reference"):
        numbers, extra = check_answers(ctx, catalog, names, cats, pool, answers)
    checks = {k: (numbers[k], mix["check_limits"][k]) for k in ("answers_differing",)}
    ms = np.asarray(times) * 1e3
    return RunRecord(
        correct=all(v <= lim for v, lim in checks.values()),
        attempted=len(answers), failed=0,
        e2e={"query_p95_ms": float(np.percentile(ms, 95))},
        checks=checks,
        counters={"queries": len(answers), "p50_ms": float(np.median(ms)),
                  "mean_hits_checked": numbers["mean_ids"], **sizes, **extra},
        host_spans=ctx.host_spans, config=cfg, memory_peak_bytes=peak,
    )


def check_answers(ctx, catalog, names, cats, pool, answers):
    mix = ctx.traffic
    rng = np.random.default_rng(ctx.seed_words(12))
    picks = rng.choice(len(answers), size=min(mix["check_answers"], len(answers)), replace=False)

    def differing(precision: str, fault=None) -> dict:
        ref = Catalog(file_ids=np.arange(1, mix["files"] + 1), mtimes=catalog["mtimes"], rows=catalog["rows"],
                      labels=catalog["labels"], scores=catalog["scores"], names=names, cats=cats, precision=precision)
        wrong = 0
        total = 0
        for p in picks:
            q, ids = answers[p]
            if fault is not None:
                ids = fault(ids)
            total += len(ids)
            wrong += ids != ref.search(pool[q][1], limit=mix["limit"])
        return {"answers_differing": float(wrong), "mean_ids": total / max(len(picks), 1)}

    numbers = differing("float32")
    extra = {}
    if ctx.calibrate:
        extra["control"] = differing("bfloat16")
        extra["faults"] = {
            "answer_altered": differing("float32", fault=lambda ids: ids[:-1] if ids else [0]),
            "half_page_left_out": differing("float32", fault=lambda ids: ids[: len(ids) // 2] if ids else [0]),
        }
    return numbers, extra
