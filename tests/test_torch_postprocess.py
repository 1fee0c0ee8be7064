"""The port's device pre/postprocess against the JAX package's, bit for bit.

Top-k must keep ``jax.lax.top_k``'s order among equal scores (lower index
first): bf16 logits tie often, and the 128-tag cap falls on ties.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.models import postprocess as jpost
from kobato_eyes_tpu.models import preprocess as jpre
from kobato_eyes_tpu_torch.models import postprocess as tpost
from kobato_eyes_tpu_torch.models import preprocess as tpre

torch.set_num_threads(1)


def _bf16_probs(rng, shape) -> np.ndarray:
    """Probabilities on the bf16 grid, as a bf16 head gives them: many ties."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    return torch.sigmoid(x.float()).to(torch.bfloat16).float().numpy()


def test_probs_from_logits_already_probs_branch_is_exact():
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 1, size=(4, 257)).astype(np.float32)
    got = tpost.probs_from_logits(torch.from_numpy(p)).numpy()
    want = np.asarray(jpost.probs_from_logits(jnp.asarray(p)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, p)


def test_probs_from_logits_sigmoid_branch():
    """The batch-global test: one value outside [0, 1] sends the whole batch
    through the sigmoid. torch's sigmoid and XLA's CPU logistic round
    apart by up to 2 ulp on about 0.4% of entries (a parity fault logged in
    ROADMAP.md), so the values are held to 2 ulp; which branch ran is exact."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, size=(4, 257)).astype(np.float32)
    x[3, 17] = 1.5  # one logit outside [0, 1]
    got = tpost.probs_from_logits(torch.from_numpy(x)).numpy()
    want = np.asarray(jpost.probs_from_logits(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    assert (got[0] != x[0]).any()  # sigmoid applied to every row

    logits = (rng.normal(size=(8, 1024)) * 4).astype(np.float32)
    got = tpost.probs_from_logits(torch.from_numpy(logits)).numpy()
    want = np.asarray(jpost.probs_from_logits(jnp.asarray(logits)))
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def _plain(results) -> list[list[tuple[str, float, int]]]:
    """TagResults as plain tuples (each package has its own TagCategory)."""
    return [[(t.name, t.score, int(t.category)) for t in r.tags] for r in results]


def _thr(rng, n):
    cats = rng.integers(0, 6, size=n).astype(np.int32)
    thr = jpost.build_threshold_vector(cats, {0: 0.35, 4: 0.25, 3: 0.25}, score_floor=0.1)
    np.testing.assert_array_equal(
        thr, tpost.build_threshold_vector(cats, {0: 0.35, 4: 0.25, 3: 0.25}, score_floor=0.1)
    )
    return cats, thr


@pytest.mark.parametrize("k", [1, 16, 128])
def test_topk_hits_bit_exact_with_ties(k):
    rng = np.random.default_rng(2)
    probs = _bf16_probs(rng, (6, 2048))
    # a row of exact ties across the k cut, and a row with no hits at all
    probs[1, :] = 0.5
    probs[2, :] = 0.0
    cats, thr = _thr(rng, probs.shape[1])
    js, ji, jh = (np.asarray(a) for a in jpost.topk_hits(jnp.asarray(probs), jnp.asarray(thr), k=k))
    ts, ti, th = (t.numpy() for t in tpost.topk_hits(torch.from_numpy(probs), torch.from_numpy(thr), k=k))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(th, jh)
    # the tie row kept the lowest indices among the hits
    hit_idx = np.flatnonzero(probs[1] >= thr)
    np.testing.assert_array_equal(ti[1], hit_idx[:k])
    names = [f"tag_{i}" for i in range(probs.shape[1])]
    kw = dict(cats=cats, names=names, limits={}, hard_cap=k)
    assert _plain(tpost.select_wd14(ts, ti, th, **kw)) == _plain(jpost.select_wd14(js, ji, jh, **kw))


def test_topk_hits_by_category_bit_exact_with_ties():
    rng = np.random.default_rng(3)
    probs = _bf16_probs(rng, (5, 1500))
    probs[0, :] = 0.875
    cats, thr = _thr(rng, probs.shape[1])
    caps = ((0, 128), (3, 10), (4, 10), (5, 3))
    js, ji = (np.asarray(a) for a in jpost.topk_hits_by_category(
        jnp.asarray(probs), jnp.asarray(thr), jnp.asarray(cats), caps=caps))
    ts, ti = (t.numpy() for t in tpost.topk_hits_by_category(
        torch.from_numpy(probs), torch.from_numpy(thr), torch.from_numpy(cats), caps=caps))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("mode", ["wd14", "pixai", "unit"])
def test_normalize_on_device_bit_exact(mode):
    rng = np.random.default_rng(4)
    batch = rng.integers(0, 256, size=(3, 16, 16, 3), dtype=np.uint8)
    want = np.asarray(jpre.normalize_on_device(jnp.asarray(batch), jpre.PreprocessSpec(mode=mode, size=16)))
    got = tpre.normalize_on_device(torch.from_numpy(batch), tpre.PreprocessSpec(mode=mode, size=16))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_host_geometry_matches():
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in ((40, 70), (90, 33), (48, 48))]
    for mode in ("wd14", "pixai"):
        np.testing.assert_array_equal(
            tpre.prepare_batch(imgs, tpre.PreprocessSpec(mode=mode, size=48)),
            jpre.prepare_batch(imgs, jpre.PreprocessSpec(mode=mode, size=48)),
        )
