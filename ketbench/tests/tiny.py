"""Tiny sizes of the cells for CPU tests: the same drivers, configurations
cut to a few layers, a few labels and a few pictures."""

from __future__ import annotations

TINY_LABELS = {"rating": 4, "general": 30, "character": 6}
TINY_BIAS = {"sure": {"general": 5, "character": 1}, "sure_bias": [1.5, 4.5],
             "borderline": {"general": 2, "character": 1}, "borderline_below_threshold": [0.0, 1.0],
             "rating": [2.0, 0.0, -1.5, -3.0], "rest": -8.0}


# at these sizes the bf16 program reads a logit gap of 0.015-0.02 against
# the float32 reference and the fp8 control 0.18-0.26
TINY_LIMITS = {"logit_gap": 0.08}


def tiny_model(config: dict) -> None:
    common = dict(num_labels=40, labels=TINY_LABELS, head_bias=TINY_BIAS, batch_size=4,
                  check_limits=dict(TINY_LIMITS))
    if config["arch"] == "vit":
        config.update(image_size=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=128, **common)
    else:
        config.update(image_size=224, embed_dim=32, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8], **common)


def tiny(config: dict, traffic: dict) -> None:
    """Cut a cell's two documents to CPU size, in place."""
    tiny_model(config)
    driver = traffic["driver"]
    if driver == "tag":
        traffic.update(batches=2, long_side=[40, 300], threads=2, warm_batches=2, check_batches=2)
    elif driver == "query":
        traffic.update(files=3000, query_pool=200, warm_queries=4, check_answers=150, limit=25)

