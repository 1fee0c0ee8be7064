"""The port's CLIP embedder and CLIP importer against the JAX package's.

The same flax weights (through ``clip_state_from_jax_params``) and the same
uint8 batches go through the JAX ``ImageEmbedder._embed`` and the port's
``ImageEmbedder`` on the CPU, at the tiny preset: 64 px, patch 32, a 32-d
projection, plain prep and prep derived from a 128 px letterbox, the
``openai`` (QuickGELU) and ``open_clip`` towers and a random-init one.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.index import embedder as jemb
from kobato_eyes_tpu.models import import_weights as jimport
from kobato_eyes_tpu_torch.index import embedder as temb
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

EMB = dict(preset="tiny", image_size=64, patch_size=32, embed_dim=32)
SEED = 7
VARIANTS = ("openai", "open_clip", None)


def _jax_embedder(variant, derive, dtype, seed=SEED):
    """The JAX embedder with its config's activation dtype set to ``dtype``
    (its constructor takes none) and seeded flax weights."""
    j = jemb.ImageEmbedder(**EMB, clip_variant=variant, derive_from=derive, params={})
    j.cfg = dataclasses.replace(j.cfg, dtype=dtype)
    j._model = jemb.ClipImageEncoder(j.cfg, embed_dim=EMB["embed_dim"])
    dummy = jnp.zeros((1, EMB["image_size"], EMB["image_size"], 3), jnp.float32)
    j.params = jax.tree.map(np.asarray, j._model.init(jax.random.PRNGKey(seed), dummy)["params"])
    return j


def _port_embedder(variant, derive, dtype, state, device="cpu"):
    """The port's embedder on ``state``, its activations in ``dtype``."""
    t = temb.ImageEmbedder(**EMB, clip_variant=variant, derive_from=derive, device=device,
                           state_dict=state)
    if dtype != t.cfg.dtype:
        t.cfg = dataclasses.replace(t.cfg, dtype=dtype)
        t._model = temb.ClipImageEncoder(t.cfg, EMB["embed_dim"])
        t._model.load_state_dict(state)
        t._model.eval().requires_grad_(False)
    return t


def _pair(variant, derive, precision):
    jdtype, tdtype = (jnp.float32, torch.float32) if precision == "f32" else (jnp.bfloat16, torch.bfloat16)
    j = _jax_embedder(variant, derive, jdtype)
    state = timport.clip_state_from_jax_params(j.params, j.cfg)
    return j, _port_embedder(variant, derive, tdtype, state)


def _batch(derive, n=4, seed=1):
    side = derive or EMB["image_size"]
    return np.random.default_rng(seed).integers(0, 256, size=(n, side, side, 3), dtype=np.uint8)


@pytest.mark.parametrize("derive", [None, 128], ids=["plain", "derived"])
@pytest.mark.parametrize("variant", VARIANTS, ids=["openai", "open_clip", "random_init"])
def test_embed_parity_f32(variant, derive):
    j, t = _pair(variant, derive, "f32")
    batch = _batch(derive)
    want = np.asarray(j._embed(j.params, jnp.asarray(batch)))
    got = t.embed_batch_prepared(batch)
    assert got.dtype == np.float32 and got.shape == (4, EMB["embed_dim"])
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("derive", [None, 128], ids=["plain", "derived"])
@pytest.mark.parametrize("variant", VARIANTS, ids=["openai", "open_clip", "random_init"])
def test_embed_parity_bf16_by_cosine(variant, derive):
    """bf16 towers agree by cosine (the vectors are unit length). Measured
    max |Δ| per entry: 6.5e-3 (openai), 6.2e-3 (open_clip), 6.3e-3 (random
    init) plain; 4.8e-3, 6.5e-3, 5.1e-3 derived; the least cosine 0.99990.
    The erf-gelu towers carry the logged bf16 erf fault (ROADMAP §3);
    QuickGELU matches XLA bit for bit, but the f32 accumulations of the
    bf16 products still round apart."""
    j, t = _pair(variant, derive, "bf16")
    batch = _batch(derive, n=8, seed=2)
    want = np.asarray(j._embed(j.params, jnp.asarray(batch)))
    got = t.embed_batch_prepared(batch)
    cos = np.sum(got * want, axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.999, cos
    assert np.abs(got - want).max() < 1e-2


def test_quick_gelu_matches_xla_bit_for_bit_in_bf16():
    """``h * jax.nn.sigmoid(1.702 * h)`` on 200 000 bf16 values of N(0, 9):
    the port's op-by-op ``quick_gelu`` equals XLA's on every one, where
    ``x * torch.sigmoid(1.702 * x)`` (an f32 constant, one rounding of the
    sigmoid) differs on 30.6%."""
    x = (np.random.default_rng(0).normal(size=200_000) * 3).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(xj * jax.nn.sigmoid(1.702 * xj), np.float32)
    got = tvit.quick_gelu(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    one_rounding = (xt * torch.sigmoid(1.702 * xt)).float().numpy()
    assert 0.30 < (one_rounding != want).mean() < 0.31


def test_keys_and_fusion_precondition_equal():
    for derive in (None, 128):
        j = jemb.ImageEmbedder(**EMB, derive_from=derive, params={})
        t = temb.ImageEmbedder(**EMB, derive_from=derive, device="cpu")
        assert t.prep_key == j.prep_key and t.model_key == j.model_key
        for side, mode in ((128, "wd14"), (64, "wd14"), (128, "pixai")):
            assert t.accepts_prepared(side, mode) == j.accepts_prepared(side, mode)
    with pytest.raises(ValueError, match="multiple"):
        temb.ImageEmbedder(**EMB, derive_from=96, device="cpu")


def test_prepare_batch_equal():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in ((50, 90), (128, 64), (70, 70))]
    for derive in (None, 128):
        j = jemb.ImageEmbedder(**EMB, derive_from=derive, params={})
        t = temb.ImageEmbedder(**EMB, derive_from=derive, device="cpu")
        np.testing.assert_array_equal(t.prepare_batch_from_rgb(imgs), j.prepare_batch_from_rgb(imgs))


def test_device_tensor_is_read_in_place():
    """A batch already on the embedder's device (the fused lane's one
    upload) gives the same vectors as the host array."""
    j, t = _pair("openai", 128, "f32")
    batch = _batch(128)
    np.testing.assert_array_equal(t.embed_batch_prepared(torch.from_numpy(batch)),
                                  t.embed_batch_prepared(batch))


# ---------------------------------------------------------------------------
# CLIP import: OpenAI / open_clip visual towers through both packages
# ---------------------------------------------------------------------------


def _clip_state(variant: str, seed: int = 11) -> dict[str, torch.Tensor]:
    """A seeded CLIP visual state dict with the manifest's names and shapes
    (a full model's ``visual.`` prefix for OpenAI, a bare tower for
    open_clip), LayerNorm scales near 1 so activations stay in range."""
    cfg = temb.embedder_config("tiny", 64, 32, EMB["embed_dim"], variant)
    prefix = "visual." if variant == "openai" else ""
    rng = np.random.default_rng(seed)
    state = {}
    for key, shape in jimport.clip_vit_state_manifest(cfg, embed_out=EMB["embed_dim"], prefix=prefix).items():
        if key.endswith(("ln_pre.weight", "ln_post.weight", "ln_1.weight", "ln_2.weight")):
            arr = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            fan_in = shape[-1] if len(shape) > 1 else 16
            arr = rng.normal(size=shape) / np.sqrt(fan_in)
        state[key] = torch.from_numpy(arr.astype(np.float32))
    if variant == "openai":
        state["text_projection"] = torch.zeros(4, 4)  # a full model's text tower rides along
    return state


def test_clip_manifest_equal():
    for variant in ("openai", "open_clip"):
        cfg = temb.embedder_config("tiny", 64, 32, 32, variant)
        for prefix in ("visual.", ""):
            assert (timport.clip_vit_state_manifest(cfg, embed_out=32, prefix=prefix)
                    == jimport.clip_vit_state_manifest(cfg, embed_out=32, prefix=prefix))


@pytest.mark.parametrize("variant", ["openai", "open_clip"])
def test_clip_import_gives_equal_embeddings(variant, tmp_path):
    path = tmp_path / f"{variant}.pt"
    torch.save(_clip_state(variant), path)
    j = _jax_embedder(variant, None, jnp.float32)
    j.params = jimport.import_torch_checkpoint(path, j.cfg)
    t = temb.ImageEmbedder.from_clip_checkpoint(path, clip_variant=variant, **EMB, device="cpu")
    assert t.cfg.act == ("quick_gelu" if variant == "openai" else "gelu") and t.cfg.ln_pre
    t = _port_embedder(variant, None, torch.float32, t._model.state_dict())
    batch = _batch(None, seed=4)
    want = np.asarray(j._embed(j.params, jnp.asarray(batch)))
    np.testing.assert_allclose(t.embed_batch_prepared(batch), want, atol=2e-4, rtol=0)
    # the carry-across is the importer's inverse: the same state either way
    carried = timport.clip_state_from_jax_params(j.params, t.cfg)
    for key, value in t._model.state_dict().items():
        np.testing.assert_array_equal(carried[key].numpy(), value.numpy(), err_msg=key)


def test_clip_drifted_key_is_named_in_both(tmp_path):
    state = _clip_state("openai")
    state["visual.ln_pre.gamma"] = state.pop("visual.ln_pre.weight")
    path = tmp_path / "drift.pt"
    torch.save(state, path)
    cfg = temb.embedder_config("tiny", 64, 32, 32, "openai")
    with pytest.raises(jimport.StateDictMismatch, match=r"visual\.ln_pre\.weight") as jerr:
        jimport.import_torch_checkpoint(path, cfg)
    with pytest.raises(timport.StateDictMismatch, match=r"visual\.ln_pre\.weight") as terr:
        timport.import_torch_checkpoint(path, cfg)
    assert "visual.ln_pre.gamma" in str(jerr.value) and "visual.ln_pre.gamma" in str(terr.value)


def test_cli_validate_checkpoint_clip_equals_jax(tmp_path, capsys):
    """``validate-checkpoint --arch clip`` of both CLIs on one OpenAI-named
    checkpoint: the same report; the towers run in bf16, so the largest
    cross-similarity of the probes is held to 5e-3 (measured 1.4e-3 apart)."""
    import json

    from kobato_eyes_tpu import cli as jcli
    from kobato_eyes_tpu_torch import cli as tcli

    path = tmp_path / "clip.pt"
    torch.save(_clip_state("openai"), path)
    argv = ["validate-checkpoint", str(path), "--arch", "clip", "--preset", "tiny", "--image-size", "64",
            "--patch-size", "32", "--classes", "32", "--images", "4"]
    reports = []
    for main, device in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main([*device, *argv]) == 0
        reports.append(json.loads(capsys.readouterr().out))
    want, got = reports
    assert got["ok"] is True and got["import"] == "strict-manifest-ok"
    assert abs(got.pop("max_cross_similarity") - want.pop("max_cross_similarity")) <= 5e-3
    assert got == want


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        temb.ImageEmbedder(**EMB)
    # a path that is no checkpoint directory names the converter
    with pytest.raises(ValueError, match="import-weights"):
        temb.ImageEmbedder(**EMB, device="cpu", checkpoint_path="ckpt")
