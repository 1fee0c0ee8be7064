"""The port's EVA02 backbone (``models/eva02.py``) and its RoPE rotation
(``ops/rope.py``) on the CPU, tiny preset: the forward against the plain
float32 reference (``ketbench/reference/eva02.py``, which imports nothing of
the port) on seeded random weights, the rotation's plain version against the
reference's rotation, the RoPE table against the formula, the PixAI tagger
on it (dispatch / complete, checkpoint, mesh, signature), and the SwiGLU's
hidden at its 16-byte pitch (the path beside the LayerNorm kernel) against
the chain. The rotation kernel and the padded forward run on the card
(``chip_smoke.py``'s ``eva02_phase``).
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from ketbench.reference.eva02 import eva02_logits, rope_tables, rotate
from kobato_eyes_tpu_torch.models import eva02
from kobato_eyes_tpu_torch.models.eva02 import (
    EPS,
    EVA02,
    EVA02Config,
    SwiGLU,
    eva02_config,
    eva02_forward_flops,
    ROPE_REF_GRID,
    ROPE_TEMPERATURE,
    init_eva02_,
    rope_table,
)
from kobato_eyes_tpu_torch.models.base import TagCategory
from kobato_eyes_tpu_torch.models.import_weights import StateDictMismatch, eva02_state_manifest
from kobato_eyes_tpu_torch.models.labels import synthetic_labels
from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec, normalize_on_device
from kobato_eyes_tpu_torch.models.tagger import PixaiTagger, WD14Tagger, save_checkpoint
from kobato_eyes_tpu_torch.ops import layernorm
from kobato_eyes_tpu_torch.ops.rope import rope_packed, rope_packed_plain

torch.set_num_threads(1)

SIZE = 56  # 4 x 4 patches of 14
N_LABELS = 24
MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)


def tiny(dtype=torch.float32, **kw) -> EVA02Config:
    return eva02_config("tiny", image_size=SIZE, num_classes=N_LABELS, dtype=dtype, **kw)


def ref_cfg(cfg: EVA02Config) -> dict:
    """The reference's configuration keys for ``cfg``."""
    return dict(image_size=cfg.image_size, patch_size=cfg.patch_size, hidden_size=cfg.hidden_dim,
                num_hidden_layers=cfg.depth, num_attention_heads=cfg.num_heads, layer_norm_eps=EPS,
                rope_theta=ROPE_TEMPERATURE, rope_ref_feat_shape=ROPE_REF_GRID, mean=MEAN, std=STD)


def model_and_state(cfg: EVA02Config, seed: int = 3) -> tuple[EVA02, dict]:
    model = init_eva02_(EVA02(cfg), torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():  # biases and norm scales away from their init, so every term is exercised
        gen = torch.Generator().manual_seed(seed + 1)
        for name, p in model.named_parameters():
            if p.dim() == 1 or name == "cls_token":
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return model, {k: v.float() for k, v in model.state_dict().items()}


def pictures(n: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8))


def port_logits(model: EVA02, pics: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        return model(normalize_on_device(pics, PreprocessSpec(mode="pixai", size=SIZE, mean=MEAN, std=STD)))


@pytest.mark.parametrize("attn_impl", ["einsum", "pallas"])
def test_forward_f32_equals_the_reference(attn_impl):
    """float32 throughout: the port (``"pallas"`` through the kernels' plain
    versions on the CPU) within 1e-5 of the reference; the sums run in
    other orders (a matmul for the patch conv, the attention's plain
    version), nothing else differs."""
    cfg = tiny(attn_impl=attn_impl)
    model, state = model_and_state(cfg)
    pics = pictures(3, 7)
    got = port_logits(model, pics)
    want = eva02_logits(state, ref_cfg(cfg), pics)
    assert got.shape == want.shape == (3, N_LABELS)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["einsum", "pallas"])
def test_forward_bf16_stays_near_the_reference(attn_impl):
    """bf16 activations over f32 weights (the cell's dtype): 2 blocks put the
    logits within 0.08 of the float32 reference (bf16 keeps 8 bits: a few
    roundings of values near 1 through each block; 0.019-0.029 over three
    weight seeds of each path), while the fp8 control reads several times
    further (0.18-0.25)."""
    cfg = tiny(dtype=torch.bfloat16, attn_impl=attn_impl)
    model, state = model_and_state(cfg)
    pics = pictures(4, 8)
    got = port_logits(model, pics)
    want = eva02_logits(state, ref_cfg(cfg), pics)
    control = eva02_logits(state, ref_cfg(cfg), pics, precision="fp8")
    gap = float((got - want).abs().max())
    assert gap < 0.08
    assert float((control - want).abs().max()) > 2 * gap


def test_einsum_and_pallas_forwards_agree_on_the_cpu():
    """On the CPU ``"pallas"`` runs the kernels' plain versions: the same
    rotation bit for bit, kernel 1's plain attention in place of the einsum."""
    cfg = tiny(dtype=torch.bfloat16)
    model, state = model_and_state(cfg)
    other = EVA02(dataclasses.replace(cfg, attn_impl="pallas")).eval()
    other.load_state_dict(state)
    pics = pictures(2, 9)
    assert float((port_logits(model, pics) - port_logits(other, pics)).abs().max()) < 0.05


def _packed(dtype, b=2, t=17, h=4, d=16, seed=0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(b, t, 3, h, d)).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_rotation_equals_the_references_bit_for_bit(dtype):
    """The port's plain rotation of the packed q and k equals the
    reference's ``x cos + rot(x) sin`` on the same table, bit for bit, the
    class token and v untouched."""
    cfg = tiny()
    sin_r, cos_r = rope_tables(ref_cfg(cfg), "cpu")  # (N, D), each angle twice
    qkv = _packed(dtype, t=cfg.num_patches + 1, h=cfg.num_heads, d=cfg.head_dim)
    before = qkv.clone()
    got = rope_packed(qkv, sin_r[:, 0::2].contiguous(), cos_r[:, 0::2].contiguous())
    assert got is qkv  # in place
    for plane in (0, 1):
        x = before[:, 1:, plane].transpose(1, 2).float()  # (B, H, N, D)
        want = rotate(x, sin_r, cos_r).to(dtype).transpose(1, 2)
        assert torch.equal(got[:, 1:, plane].view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.contiguous().view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(got[:, 0], before[:, 0])  # the class token
    assert torch.equal(got[:, :, 2], before[:, :, 2])  # v
    assert not torch.equal(got[:, 1:, :2], before[:, 1:, :2])


def test_rope_table_is_the_formula():
    """Bands 10000^(-m/n), positions i * ref / grid, y angles then x angles,
    against a float64 evaluation in NumPy (the f32 table rounds it once)."""
    for cfg in (tiny(), EVA02Config()):
        sin, cos = rope_table(cfg)
        n = cfg.head_dim // 4
        g = cfg.grid
        bands = np.array([10000.0 ** (-m / n) for m in range(n)])
        want = np.zeros((g * g, 2 * n))
        for i in range(g):
            for j in range(g):
                y, x = i * ROPE_REF_GRID / g, j * ROPE_REF_GRID / g
                want[i * g + j] = np.concatenate([y * bands, x * bands])
        assert sin.dtype == torch.float32 and sin.shape == (g * g, cfg.head_dim // 2)
        np.testing.assert_allclose(sin.numpy(), np.sin(want), rtol=0, atol=1e-7)
        np.testing.assert_allclose(cos.numpy(), np.cos(want), rtol=0, atol=1e-7)
    cfg = EVA02Config()
    assert rope_table(cfg)[0][33, 0].item() == pytest.approx(math.sin(0.5))  # row 1, column 1: y = 0.5


def test_rotation_takes_the_rotated_tokens_from_the_tables():
    """The tables' rows say how many of the last tokens turn (EVA02: all but
    the class token); tables that do not fit raise."""
    qkv = _packed(torch.float32)  # T = 17
    before = qkv.clone()
    rope_packed_plain(qkv, torch.ones(12, 8), torch.zeros(12, 8))  # a quarter turn of the last 12
    assert torch.equal(qkv[:, :5], before[:, :5]) and torch.equal(qkv[:, :, 2], before[:, :, 2])
    assert torch.equal(qkv[:, 5:, :2, :, 1::2], before[:, 5:, :2, :, 0::2])
    assert torch.equal(qkv[:, 5:, :2, :, 0::2], -before[:, 5:, :2, :, 1::2])
    sin, cos = torch.zeros(16, 8), torch.zeros(16, 8)
    with pytest.raises(ValueError, match="cos"):
        rope_packed_plain(qkv, sin, cos[:5])
    with pytest.raises(ValueError, match="rows of angles"):
        rope_packed_plain(qkv, torch.zeros(18, 8), torch.zeros(18, 8))
    with pytest.raises(ValueError, match="packed"):
        rope_packed_plain(qkv[:, :, :2], sin, cos)


def test_forward_flops_of_eva02_l_448():
    """723.5 GFLOP an image (the 1.2 patch embedding, 24 blocks of 30.1, the head)."""
    assert round(eva02_forward_flops(EVA02Config(), 1) / 1e9, 1) == 723.5
    assert eva02_forward_flops(EVA02Config(), 32) == 32 * eva02_forward_flops(EVA02Config(), 1)


def pixai_labels() -> list[TagMeta]:
    labels = synthetic_labels(N_LABELS)
    return [dataclasses.replace(m, category=TagCategory.CHARACTER, ips=(f"series_{i % 2}",)) if i >= 18 else m
            for i, m in enumerate(labels)]


def pixai_tagger(**kw) -> PixaiTagger:
    return PixaiTagger(arch="eva02", preset="tiny", image_size=SIZE, labels=pixai_labels(), fast_math=False,
                       device="cpu", seed=5, thresholds={0: 0.45, 4: 0.5, 3: 0.5}, **kw)


def test_pixai_dispatch_complete_equals_infer():
    """Three batches at depth 2, thresholds overridden on the second: each
    completion is what ``infer_batch_prepared`` returns alone, and ips
    copyrights reach the rows."""
    tagger = pixai_tagger()
    assert isinstance(tagger._model, EVA02) and tagger.arch == "eva02"
    batches = [pictures(n, 20 + n).numpy() for n in (3, 2, 4)]
    calls = [(b, {0: 0.5} if i == 1 else None) for i, b in enumerate(batches)]
    want = [tagger.infer_batch_prepared(b, thresholds=t) for b, t in calls]
    got, inflight = [], []
    for b, t in calls:
        inflight.append(tagger.dispatch_batch_prepared(b, thresholds=t))
        if len(inflight) == 2:
            got.append(tagger.complete_batch_prepared(inflight.pop(0)))
    got += [tagger.complete_batch_prepared(h) for h in inflight]
    assert got == want
    assert any(t.category == TagCategory.COPYRIGHT for rows in want for r in rows for t in r.tags)


def test_state_manifest_and_checkpoint_round_trip(tmp_path):
    """The key manifest is the model's state dict, key for key and shape for
    shape; a checkpoint directory loads into an equal tagger; a state with a
    drifted key fails naming it; ``import-weights --arch eva02`` writes the
    same directory from a timm-named ``.safetensors``, which the app's tagger
    (``cli._resolve_tagger`` over ``tagger.model_path``, naming no arch)
    loads as an EVA02 of the manifest's preset and size."""
    from safetensors.torch import save_file

    from kobato_eyes_tpu_torch import cli
    from kobato_eyes_tpu_torch.core.config.schema import Settings, TaggerSettings

    tagger = pixai_tagger()
    state = tagger._model.state_dict()
    manifest = eva02_state_manifest(tagger.cfg)
    assert {k: tuple(v.shape) for k, v in state.items()} == manifest
    assert "blocks.0.attn.k_proj.weight" in manifest and "blocks.0.attn.k_proj.bias" not in manifest
    meta = {"arch": "eva02", "preset": "tiny", "image_size": SIZE, "num_classes": N_LABELS}
    save_checkpoint(tmp_path / "ck", state, manifest=meta)
    loaded = pixai_tagger(checkpoint_path=tmp_path / "ck")
    batch = pictures(2, 30).numpy()
    assert loaded.infer_batch_prepared(batch) == tagger.infer_batch_prepared(batch)
    assert loaded.signature_fields()["ckpt"] == str(tmp_path / "ck")

    bad = dict(state)
    bad["blocks.1.mlp.fc1.weight"] = bad.pop("blocks.1.mlp.fc1_g.weight")
    save_checkpoint(tmp_path / "bad", bad, manifest=meta)
    with pytest.raises(StateDictMismatch, match="fc1_g"):
        pixai_tagger(checkpoint_path=tmp_path / "bad")

    save_file({k: v.contiguous() for k, v in state.items()}, str(tmp_path / "w.safetensors"))
    assert cli.main(["--device", "cpu", "import-weights", str(tmp_path / "w.safetensors"), str(tmp_path / "imp"),
                     "--arch", "eva02", "--preset", "tiny", "--image-size", str(SIZE),
                     "--classes", str(N_LABELS)]) == 0
    written = json.loads((tmp_path / "imp" / "manifest.json").read_text())
    assert written["arch"] == "eva02" and written["preset"] == "tiny"
    assert pixai_tagger(checkpoint_path=tmp_path / "imp").infer_batch_prepared(batch) == tagger.infer_batch_prepared(batch)

    labels = tmp_path / "selected_tags.csv"
    labels.write_text("tag_id,name,category,count\n"
                      + "".join(f"{i},tag_{i},{4 if i >= 18 else 0},{100 - i}\n" for i in range(N_LABELS)))
    settings = Settings(tagger=TaggerSettings(name="pixai", labels_path=labels, model_path=tmp_path / "imp"))
    app = cli._resolve_tagger(settings, "cpu")
    assert isinstance(app._model, EVA02) and app.signature_fields()["arch"] == f"eva02-d2-h64-p14-m170-{SIZE}"
    held = PixaiTagger(arch="eva02", preset="tiny", image_size=SIZE, labels_path=labels, params=state,
                       thresholds=settings.tagger.thresholds, fast_math=False, device="cpu")
    assert app.infer_batch_prepared(batch) == held.infer_batch_prepared(batch)


def test_mesh_raises():
    from kobato_eyes_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="EVA02 tagger runs on one device"):
        pixai_tagger(mesh=mesh)


def test_signature_fields_name_the_backbone():
    """A catalog tagged by another backbone (or another EVA02 size) is
    re-tagged: the arch fields differ."""
    eva = pixai_tagger().signature_fields()["arch"]
    assert eva == f"eva02-d2-h64-p14-m170-{SIZE}"
    large = PixaiTagger(eva02=EVA02Config(num_classes=N_LABELS, depth=1), labels=pixai_labels(), fast_math=False,
                        device="cpu").signature_fields()["arch"]
    vit = WD14Tagger(preset="tiny", image_size=64, labels=synthetic_labels(N_LABELS), fast_math=False,
                     device="cpu").signature_fields()["arch"]
    assert len({eva, large, vit}) == 3


def test_fast_math_turns_on_the_kernels_only():
    """``fast_math`` gives EVA02 the RoPE kernel and kernel 1 (there is no
    GELU to swap for SwiGLU)."""
    assert pixai_tagger().cfg.attn_impl == "einsum"
    fast = PixaiTagger(arch="eva02", preset="tiny", image_size=SIZE, labels=pixai_labels(), fast_math=True,
                       device="cpu")
    assert fast.cfg.attn_impl == "pallas"


# ---------------------------------------------------------------------------
# SwiGLU's hidden at a 16-byte pitch (the path beside the LayerNorm kernel)
# ---------------------------------------------------------------------------


@pytest.fixture
def kernel_path(monkeypatch):
    """``on_card`` says yes and the kernel's launch writes its plain version
    into the wrapper's output: what a CUDA tensor meets, on the CPU. Where
    autograd does not record, the SwiGLU takes its padded path."""

    def launch(x2, shortcut2, weight, bias, out, body_of, eps):
        out.copy_(layernorm.layernorm_plain(x2, weight, bias, eps=eps, dtype=out.dtype, shortcut=shortcut2,
                                            body_of=body_of, out_pitch=out.shape[-1]))

    monkeypatch.setattr(layernorm, "on_card", lambda x: True)
    monkeypatch.setattr(layernorm, "_launch", launch)


def swiglu(cfg: EVA02Config, seed: int = 11) -> SwiGLU:
    """lecun-normal matrices; the biases and the sub-LayerNorm's scale moved
    off their init."""
    mlp = SwiGLU(cfg).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in mlp.parameters():
            noise = torch.randn(p.shape, generator=gen)
            p.copy_(noise / math.sqrt(p.shape[1]) if p.dim() == 2 else p + 0.1 * noise)
    return mlp


@pytest.mark.parametrize("preset,rows", [("tiny", 40), ("large", 6)])
def test_padded_swiglu_equals_the_chain(preset, rows):
    """float32, tiny (170 -> 192 columns) and EVA02-L (2730 -> 2752): the
    padded path within 1e-6 of the chain the CPU runs, relative to the
    largest output (|out| reaches ~4, where an f32 step is 4.8e-7: the
    sub-LayerNorm's sums run in the kernel's order, the products' in another;
    the zeros add nothing)."""
    cfg = eva02_config(preset, dtype=torch.float32)
    mlp = swiglu(cfg)
    assert (mlp.hidden, mlp.pitch) == {"tiny": (170, 192), "large": (2730, 2752)}[preset]
    x = torch.randn(2, rows, cfg.hidden_dim, generator=torch.Generator().manual_seed(12))
    with torch.inference_mode():
        want = mlp(x)
        got = mlp.forward_padded(x)
    assert got.shape == want.shape == x.shape
    assert float((got - want).abs().max()) <= 1e-6 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_columns_are_exact_zeros(dtype, monkeypatch):
    """g, u, SiLU(g) * u and the sub-LayerNorm's output are 0 past the 170
    real columns of the pitch; the LayerNorm reads the real columns in place
    at the pitch; the padded weights hold the parameters' casts and zeros."""
    cfg = eva02_config("tiny", dtype=dtype)
    mlp = swiglu(cfg)
    hidden, pitch = mlp.hidden, mlp.pitch
    assert hidden == 170 and pitch > hidden
    seen = []
    real = layernorm.layernorm

    def spy(x, *args, **kw):
        seen.append((x, real(x, *args, **kw)))
        return seen[-1][1]

    monkeypatch.setattr(layernorm, "layernorm", spy)
    x = torch.randn(3, 5, cfg.hidden_dim, generator=torch.Generator().manual_seed(13))
    with torch.inference_mode():
        mlp.forward_padded(x)
        w_g, w_x, b_g, b_x, w_2 = mlp.padded_operands()
        g, u = (torch.matmul(x.to(dtype), w.t()) + b for w, b in ((w_g, b_g), (w_x, b_x)))
    ((hv, out),) = seen
    assert hv.shape[-1] == hidden and hv.stride(-2) == pitch
    h = hv.as_strided((*hv.shape[:-1], pitch), hv.stride())
    for t in (g, u, h, out):
        assert t.shape == (3, 5, pitch) and t.dtype == dtype
        assert torch.equal(t[..., hidden:], torch.zeros(3, 5, pitch - hidden, dtype=dtype))
    assert torch.equal(out[..., :hidden],
                       layernorm.layernorm_plain(hv, mlp.norm.weight, mlp.norm.bias, eps=EPS, dtype=dtype))
    assert not torch.equal(h[..., :hidden], torch.zeros_like(h[..., :hidden]))
    for got, param in ((w_g, mlp.fc1_g.weight), (w_x, mlp.fc1_x.weight), (b_g, mlp.fc1_g.bias),
                       (b_x, mlp.fc1_x.bias), (w_2.t(), mlp.fc2.weight.t())):
        assert torch.equal(got[:hidden], param.to(dtype)) and not got[hidden:].any()


def test_a_hidden_width_on_16_bytes_keeps_the_chain(kernel_path, monkeypatch):
    """176 columns are 16-byte rows already: the chain runs (its LayerNorm at
    pitch C), not the padded path."""
    cfg = eva02_config("tiny", mlp_hidden=176, dtype=torch.bfloat16)
    mlp = swiglu(cfg)
    assert mlp.pitch == mlp.hidden == 176
    pitches = []
    real = layernorm.layernorm

    def spy(x, *args, out_pitch=None, **kw):
        pitches.append(out_pitch)
        return real(x, *args, out_pitch=out_pitch, **kw)

    monkeypatch.setattr(layernorm, "layernorm", spy)
    before = eva02.padded_swiglu
    x = torch.randn(2, 3, cfg.hidden_dim, generator=torch.Generator().manual_seed(14))
    with torch.inference_mode():
        got = mlp(x)
        hidden = torch.nn.functional.silu(mlp.fc1_g(x)) * mlp.fc1_x(x)
        want = mlp.fc2(layernorm.layernorm_plain(hidden, mlp.norm.weight, mlp.norm.bias, eps=EPS,
                                                 dtype=torch.bfloat16))
    assert pitches == [None] and eva02.padded_swiglu == before
    assert torch.equal(got, want)


def test_padded_swiglu_counts_a_block_on_the_padded_path_only(kernel_path, monkeypatch):
    """One count a block a forward on the padded path; none under autograd,
    none on a CPU tensor; the f32 logits within 1e-5 of the chain's."""
    cfg = tiny()
    model, _ = model_and_state(cfg)
    pics = pictures(2, 15)
    before = eva02.padded_swiglu
    padded = port_logits(model, pics)
    assert eva02.padded_swiglu == before + cfg.depth
    x = normalize_on_device(pics, PreprocessSpec(mode="pixai", size=SIZE, mean=MEAN, std=STD))
    assert model(x).requires_grad  # grad mode on, the parameters require grad: the chain
    monkeypatch.undo()
    chain = port_logits(model, pics)
    assert eva02.padded_swiglu == before + cfg.depth
    torch.testing.assert_close(padded, chain, rtol=0, atol=1e-5)


def test_padded_path_leaves_the_parameters_and_manifest_as_they_are(kernel_path, tmp_path):
    """The state dict keeps 170 hidden columns, key for key and value for
    value, after forwards on the padded path; the manifest and a checkpoint
    round trip are the parent's, and the loaded tagger answers the same."""
    tagger = pixai_tagger()
    before = {k: v.clone() for k, v in tagger._model.state_dict().items()}
    batch = pictures(2, 30).numpy()
    count = eva02.padded_swiglu
    answer = tagger.infer_batch_prepared(batch)
    assert eva02.padded_swiglu == count + tagger.cfg.depth
    state = tagger._model.state_dict()
    manifest = eva02_state_manifest(tagger.cfg)
    assert {k: tuple(v.shape) for k, v in state.items()} == manifest
    assert all(torch.equal(state[k], v) for k, v in before.items()) and state.keys() == before.keys()
    assert (manifest["blocks.0.mlp.fc1_g.weight"], manifest["blocks.0.mlp.fc2.weight"],
            manifest["blocks.0.mlp.norm.weight"]) == ((170, 64), (64, 170), (170,))
    meta = {"arch": "eva02", "preset": "tiny", "image_size": SIZE, "num_classes": N_LABELS}
    save_checkpoint(tmp_path / "ck", state, manifest=meta)
    assert pixai_tagger(checkpoint_path=tmp_path / "ck").infer_batch_prepared(batch) == answer
