"""The tagger's arch table (``models/archs.py``): each entry's config maps
back to it, its module's state matches its manifest, its converter takes
that state back bit for bit, and its signature and ``fast_math`` rewrite
are the tagger's as pinned here."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from kobato_eyes_tpu_torch.models.archs import ARCHS, arch_of
from kobato_eyes_tpu_torch.models.import_weights import validate_state_against_manifest

torch.set_num_threads(1)

N_LABELS = 8
# arch -> (overrides of the tiny preset for a small image, signature, fast_math's (attn_impl, act))
CASES = {
    "vit": (dict(image_size=32, patch_size=16), "vit-d4-h192-p16-32", ("pallas", "gelu_tanh")),
    "swinv2": (dict(image_size=64, window_size=2), "swinv2-e96-d2.2.6.2-w2-64", ("pallas", "gelu_tanh")),
    "eva02": (dict(image_size=28), "eva02-d2-h64-p14-m170-28", ("pallas", None)),
}


@pytest.mark.parametrize("name", list(ARCHS))
def test_arch_entry(name):
    arch = ARCHS[name]
    overrides, signature, fast = CASES[name]
    cfg = arch.preset_config("tiny", num_classes=N_LABELS, **overrides)
    assert arch_of(cfg) is arch and arch.name == name
    model = arch.module(cfg)
    arch.init(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    validate_state_against_manifest(state, arch.state_manifest(cfg), name=name)
    assert arch.timm_manifest(cfg, state) == arch.state_manifest(cfg)  # the port's state is timm-named
    back = arch.from_timm(state, cfg)
    assert set(back) == set(state)
    for key, value in state.items():
        assert back[key].dtype == value.dtype and torch.equal(back[key], value), key
    assert arch.signature(cfg) == signature
    quick = arch.fast(cfg)
    assert (quick.attn_impl, getattr(quick, "act", None)) == fast
    assert arch.fast(dataclasses.replace(cfg, attn_impl="pallas")) == dataclasses.replace(cfg, attn_impl="pallas")
