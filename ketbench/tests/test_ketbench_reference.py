"""The plain references against the port's exact CPU results at tiny sizes,
and their lower-precision controls, which must fail."""

import numpy as np
import pytest
import torch

from ketbench import check, model, weights
from ketbench.core import load_benchmark, load_config
from ketbench.reference import pictures
from ketbench.reference.swinv2 import swin_logits
from ketbench.reference.vit import vit_logits
from ketbench.tests.tiny import TINY_LIMITS, tiny_model


def tiny_config(name: str, dtype: str) -> dict:
    cfg = load_config(load_benchmark(), name)
    tiny_model(cfg)
    cfg.update(dtype=dtype, attn_impl="einsum")
    return cfg


@pytest.mark.parametrize("name,fn", [("wd14-vit-b16-448", vit_logits), ("wd14-swinv2-b-448", swin_logits)])
def test_reference_equals_port_float32_forward(name, fn):
    cfg = tiny_config(name, "float32")
    names, cats = weights.label_table(cfg)
    state = weights.make_state(cfg, weights.model_shapes(cfg), cats, 7, "cpu")
    tagger = model.build_tagger(cfg, state, names, cats, "cpu")
    rng = np.random.default_rng(0)
    boxed = np.stack([pictures.letterbox(rng.integers(0, 256, (40 + 9 * i, 70, 3), dtype=np.uint8),
                                         cfg["image_size"]) for i in range(3)])
    with torch.no_grad():
        port = tagger._model(torch.from_numpy(boxed).float().flip(-1)).double()
    ref = fn(state, cfg, torch.from_numpy(boxed)).double()
    assert (port - ref).abs().max().item() < 1e-4
    control = fn(state, cfg, torch.from_numpy(boxed), precision="fp8").double()
    assert (control - ref).abs().max().item() > 10 * (port - ref).abs().max().item()


@pytest.mark.parametrize("name,fn", [("wd14-vit-b16-448", vit_logits), ("wd14-swinv2-b-448", swin_logits)])
def test_control_fails_the_tag_limit(name, fn):
    """The bf16 program passes the tiny limit, the fp8 control does not."""
    cfg = tiny_config(name, "bfloat16")
    cfg["attn_impl"] = "pallas"
    names, cats = weights.label_table(cfg)
    thr = weights.threshold_vector(cfg, cats)
    state = weights.make_state(cfg, weights.model_shapes(cfg), cats, 11, "cpu")
    tagger = model.build_tagger(cfg, state, names, cats, "cpu")
    rng = np.random.default_rng(1)
    boxed = np.stack([pictures.letterbox(rng.integers(0, 256, (90, 60 + 11 * i, 3), dtype=np.uint8),
                                         cfg["image_size"]) for i in range(4)])
    rows = model.result_rows(tagger.infer_batch_prepared(boxed))
    ref = fn(state, cfg, torch.from_numpy(boxed)).double().numpy()
    low = fn(state, cfg, torch.from_numpy(boxed), precision="fp8").double().numpy()
    program = check.compare_tag_rows(rows, ref, names, cats, thr, cfg["topk_cap"])
    control = check.compare_tag_rows(check.select_rows(low, names, cats, thr, cfg["topk_cap"]),
                                     ref, names, cats, thr, cfg["topk_cap"])
    assert program["logit_gap"] <= TINY_LIMITS["logit_gap"] and program["bad_rows"] == 0
    assert control["logit_gap"] > TINY_LIMITS["logit_gap"]


def test_query_reference_equals_port_search_and_control_differs(tmp_path):
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.query.engine import build_epoch, search_epoch

    from ketbench.core import load_traffic
    from ketbench.drivers import query
    from ketbench.reference.query import Catalog

    cfg = load_config(load_benchmark(), "wd14-vit-b16-448")
    tiny_model(cfg)
    mix = load_traffic("query-70k")
    mix.update(files=2000, query_pool=300)
    names, cats = weights.label_table(cfg)
    catalog = query.generate_catalog([3, 0], mix, cats)
    pool = query.make_pool(mix, catalog, names)
    query.fill_catalog(tmp_path / "c.sqlite", catalog, names, cats)
    conn = bootstrap(tmp_path / "c.sqlite")
    epoch = build_epoch(conn, device="cpu")
    conn.close()
    args = dict(file_ids=np.arange(1, mix["files"] + 1), mtimes=catalog["mtimes"], rows=catalog["rows"],
                labels=catalog["labels"], scores=catalog["scores"], names=names, cats=cats)
    ref, low = Catalog(**args), Catalog(**args, precision="bfloat16")
    differ = 0
    for text, tree in pool:
        got = [r.file_id for r in search_epoch(epoch, text, order_by="relevance", limit=50)]
        assert got == ref.search(tree, limit=50), text
        differ += got != low.search(tree, limit=50)
    assert differ > 0
