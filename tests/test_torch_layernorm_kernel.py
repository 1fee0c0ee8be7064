"""The LayerNorm kernel (``ops/layernorm.py``, ``csrc/layernorm.cu``): when the
modules take it, how it chooses its body, and its plain version against the
modules' op-by-op chains.

On the CPU the kernel cannot run: the dispatch rule and the wrapper's
plumbing are driven through a stand-in launcher (``_launch`` replaced by the
plain version in the body the wrapper chose) with ``on_card`` answering yes.
The plain version sums a row in the kernel's order; against the modules'
chains, which sum in torch's order (and on the CPU divide the sum by C where
torch's CUDA ``mean`` and the kernel multiply by fl(1/C)), it agrees bit for
bit where the sums are exact in any order (integer rows, C a power of two)
and within what the sums' order explains elsewhere.

The tests marked ``card`` hold the kernel to its plain version bit for bit
on a CUDA card and skip without one (``python -m pytest
tests/test_torch_layernorm_kernel.py -m card`` on the card).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kobato_eyes_tpu_torch.models import eva02, swin, vit
from kobato_eyes_tpu_torch.ops import layernorm as L
from kobato_eyes_tpu_torch.ops import xla_math

torch.set_num_threads(1)

U = 2.0**-24  # f32 unit roundoff
CELL_COLS = (128, 256, 512, 768, 1024, 2730)  # every width of the tagging cells' LayerNorms


def _rows(r, c, dtype, seed=0, scale=3.0, offset=0.5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(r, c, generator=g) * scale + offset).to(dtype)


def _affine(c, dtype=torch.float32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(c, generator=g) * 1.5 + 0.5).to(dtype), torch.randn(c, generator=g).to(dtype)


def _vit_norm(c, dtype, weight, bias, eps=1e-5):
    m = vit.LayerNorm(c, vit.vit_config("tiny", dtype=dtype), eps=eps).to(weight.dtype)
    with torch.no_grad():
        m.weight.copy_(weight)
        m.bias.copy_(bias)
    return m


def _post_norm(c, dtype, weight, bias, ln_impl="xla"):
    m = swin.ResidualPostNorm(c, swin.swin_config("tiny", image_size=224, dtype=dtype, ln_impl=ln_impl)).to(weight.dtype)
    with torch.no_grad():
        m.weight.copy_(weight)
        m.bias.copy_(bias)
    return m


@pytest.fixture
def fake_card(monkeypatch):
    """``on_card`` says yes for every tensor and ``_launch`` writes the plain
    version in the body the wrapper chose; returns the launches' records."""
    calls = []

    def launch(x2, shortcut2, weight, bias, out, body_of, eps):
        calls.append({"rows": tuple(x2.shape), "pitch": x2.stride(0), "body": body_of, "post": shortcut2 is not None,
                      "x": x2.dtype, "out": out.dtype, "params": (weight.dtype, bias.dtype), "eps": eps,
                      "out_pitch": out.stride(0)})
        out.copy_(L.layernorm_plain(x2, weight, bias, eps=eps, dtype=out.dtype, shortcut=shortcut2, body_of=body_of,
                                    out_pitch=out.shape[-1]))

    monkeypatch.setattr(L, "on_card", lambda x: True)
    monkeypatch.setattr(L, "_launch", launch)
    return calls


# ---------------------------------------------------------------------------
# When the modules take the kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("post", [False, True])
def test_cpu_tensor_takes_the_module_chain(post, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper was called for a CPU tensor")

    monkeypatch.setattr(L, "layernorm", refuse)
    w, b = _affine(128)
    x = _rows(8, 128, torch.bfloat16)
    before = L.launches
    with torch.inference_mode():
        out = _post_norm(128, torch.bfloat16, w, b)(x, x) if post else _vit_norm(128, torch.bfloat16, w, b)(x)
    assert out.dtype == torch.bfloat16 and L.launches == before


@pytest.mark.parametrize("post", [False, True])
def test_card_tensor_under_autograd_takes_the_module_chain(post, fake_card):
    w, b = _affine(256)
    x = _rows(8, 256, torch.float32)
    m = _post_norm(256, torch.float32, w, b) if post else _vit_norm(256, torch.float32, w, b)
    out = m(x, x) if post else m(x)  # grad mode on, the parameters require grad
    assert fake_card == [] and out.requires_grad
    out.sum().backward()
    assert m.weight.grad is not None and torch.isfinite(m.weight.grad).all()


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "nothing_requires_grad"])
def test_card_tensor_without_autograd_takes_the_kernel(post, mode, fake_card):
    w, b = _affine(768)
    x = _rows(8, 768, torch.bfloat16)
    m = _post_norm(768, torch.bfloat16, w, b) if post else _vit_norm(768, torch.bfloat16, w, b)
    if mode == "nothing_requires_grad":
        m.requires_grad_(False)
    context = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad}.get(mode, torch.enable_grad)
    before = L.launches
    with context():
        out = m(x, x) if post else m(x)
    want = L.layernorm_plain(x, m.weight, m.bias, eps=1e-5, dtype=torch.bfloat16, shortcut=x if post else None)
    assert [(c["body"], c["post"]) for c in fake_card] == [((8, 32, 4), post)]
    assert L.launches == before + 1
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)


def test_residual_layernorm_kernel_keeps_its_own_path(fake_card):
    """``ln_impl="pallas_residual"`` goes to kernel 4 (here its plain version),
    never to this kernel."""
    w, b = _affine(128)
    x = _rows(8, 128, torch.bfloat16)
    with torch.inference_mode():
        out = _post_norm(128, torch.bfloat16, w, b, ln_impl="pallas_residual")(x, x)
    assert fake_card == [] and out.dtype == torch.bfloat16


def _tiny_forward(arch):
    """(model, input shape, LayerNorms a forward) of a tiny preset."""
    g = torch.Generator().manual_seed(4)
    if arch == "vit":
        cfg = vit.vit_config("tiny", image_size=64, num_classes=8)
        return vit.init_vit_(vit.ViT(cfg), g), (1, 64, 64, 3), 2 * cfg.depth + 1
    if arch == "swinv2":
        cfg = swin.swin_config("tiny", image_size=224, num_classes=8, embed_dim=48, depths=(2, 2, 2, 2))
        return swin.init_swin_(swin.SwinV2(cfg), g), (1, 224, 224, 3), 2 * sum(cfg.depths) + 1 + cfg.num_stages
    cfg = eva02.eva02_config("tiny", image_size=56, num_classes=8)
    return eva02.init_eva02_(eva02.EVA02(cfg), g), (1, 56, 56, 3), 3 * cfg.depth + 1


@pytest.mark.parametrize("arch", ["vit", "swinv2", "eva02"])
def test_each_layernorm_of_a_forward_is_one_launch(arch, fake_card):
    """A forward launches the kernel once a LayerNorm: at full size ViT-B 25
    (12 x 2 + the final norm), SwinV2-B 53 (48 post-norms + the patch-embed,
    three merging and the final norm), EVA02-L 73 (24 x 3 + ``fc_norm``);
    and gives what the modules' chains give within the sums' order."""
    model, shape, want = _tiny_forward(arch)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        got = model(x)
    assert len(fake_card) == want
    assert {c["out"] for c in fake_card} == {torch.bfloat16}
    if arch == "swinv2":
        assert sum(c["post"] for c in fake_card) == 2 * sum(model.cfg.depths)
    fake_card.clear()
    with torch.no_grad():
        model.requires_grad_(True)
        with torch.enable_grad():
            want_logits = model(x)  # parameters require grad: the chains
    assert fake_card == []
    # logits of about 2 in bf16 (a step is 2^-6 there): a LayerNorm output a
    # bf16 step apart moves a logit by less than a few steps
    np.testing.assert_allclose(got.float().numpy(), want_logits.detach().float().numpy(), rtol=0, atol=0.05)


# ---------------------------------------------------------------------------
# Argument checks and the body
# ---------------------------------------------------------------------------


def test_checks_refuse_cpu_tensors():
    w, b = _affine(128)
    with pytest.raises(ValueError, match="CUDA"):
        L.check_inputs(_rows(2, 128, torch.float32), w, b, torch.bfloat16)


@pytest.mark.parametrize("case,match", [
    ("half", "float32 or bfloat16"), ("out_half", "writes float32 or bfloat16"), ("wide", "C <= 4096"),
    ("weight", r"must be \(128,\)"), ("shortcut", "shortcut must have"), ("params_half", "float32 or bfloat16"),
])
def test_checks_refuse_what_the_kernel_does_not_take(case, match, fake_card):
    w, b = _affine(128)
    x, dtype, shortcut = _rows(2, 128, torch.float32), torch.bfloat16, None
    if case == "half":
        x = x.half()
    elif case == "out_half":
        dtype = torch.float16
    elif case == "wide":
        x, (w, b) = _rows(2, 4097, torch.float32), _affine(4097)
    elif case == "weight":
        w = w[:64]
    elif case == "shortcut":
        shortcut = _rows(3, 128, torch.float32)
    else:
        w = w.half()
    with pytest.raises(ValueError, match=match):
        L.layernorm(x, w, b, eps=1e-5, dtype=dtype, shortcut=shortcut)
    assert fake_card == []


def _view(r, c, dtype, *, offset_bytes=0, pitch=None):
    """(r, c) rows ``offset_bytes`` past an aligned start, ``pitch`` apart."""
    pitch = c if pitch is None else pitch
    size = torch.empty((), dtype=dtype).element_size()
    flat = _rows(1, r * pitch + 16, dtype).reshape(-1)
    assert flat.data_ptr() % 16 == 0 and offset_bytes % size == 0
    return flat[offset_bytes // size:][: r * pitch].view(r, pitch)[:, :c]


@pytest.mark.parametrize("c,dtype,offset,pitch,want", [
    (128, torch.bfloat16, 0, None, (8, 16, 1)),  # SwinV2 stage 0: two rows a warp
    (256, torch.bfloat16, 0, None, (8, 32, 1)),
    (512, torch.bfloat16, 0, None, (8, 32, 2)),
    (768, torch.bfloat16, 0, None, (8, 32, 4)),  # ViT-B norm1, the final norm
    (1024, torch.bfloat16, 0, None, (8, 32, 4)),  # EVA02 norm1 / norm2, SwinV2 stage 3
    (2730, torch.bfloat16, 0, None, (2, 128, 12)),  # EVA02's sub-LayerNorm: 5460-byte rows, a block a row
    (768, torch.float32, 0, None, (4, 32, 8)),  # ViT-B norm2 on the f32 attention residual
    (2730, torch.float32, 0, None, (2, 128, 12)),
    (4096, torch.bfloat16, 0, None, (8, 128, 4)),
    (4096, torch.float32, 0, None, (4, 128, 8)),
    (4095, torch.float32, 0, None, (1, 256, 16)),
    (1537, torch.bfloat16, 0, None, (1, 256, 8)),
    (100, torch.bfloat16, 0, None, (4, 32, 1)),
    (1023, torch.bfloat16, 0, None, (1, 128, 8)),
    (5, torch.float32, 0, None, (1, 16, 1)),
    (768, torch.bfloat16, 2, None, (1, 128, 8)),  # 2 bytes off: one element a load
    (768, torch.bfloat16, 8, None, (4, 32, 8)),  # 8 bytes off: 8-byte loads
    (768, torch.bfloat16, 0, 776, (8, 32, 4)),  # strided rows, 16-byte pitch
    (768, torch.bfloat16, 0, 770, (2, 128, 4)),  # a 1540-byte pitch: 4-byte loads
])
def test_body_is_chosen_from_width_dtype_and_alignment(c, dtype, offset, pitch, want):
    x = _view(6, c, dtype, offset_bytes=offset, pitch=pitch)
    assert L.layout(*L.operands(x, torch.bfloat16)) == want


def test_shortcut_alignment_bounds_the_load_width():
    x = _view(4, 128, torch.bfloat16)
    shortcut = _view(4, 128, torch.bfloat16, offset_bytes=4)
    assert L.layout(*L.operands(x, torch.bfloat16)) == (8, 16, 1)
    assert L.layout(*L.operands(x, torch.bfloat16, shortcut)) == (2, 32, 2)


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("offset,pitch", [(2, None), (8, None), (0, 776), (4, 770)])
def test_wrapper_reads_misaligned_and_strided_rows_in_place(post, offset, pitch, fake_card):
    x = _view(5, 768, torch.bfloat16, offset_bytes=offset, pitch=pitch).view(5, 1, 768)
    shortcut = _rows(5, 768, torch.bfloat16, seed=3).view(5, 1, 768) if post else None
    w, b = _affine(768)
    got = L.layernorm(x, w, b, eps=1e-5, dtype=torch.bfloat16, shortcut=shortcut)
    (call,) = fake_card
    assert call["pitch"] == (768 if pitch is None else pitch)
    assert got.shape == x.shape and got.is_contiguous()
    want = L.layernorm_plain(x.contiguous(), w, b, eps=1e-5, dtype=torch.bfloat16, shortcut=shortcut,
                             body_of=call["body"])
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The output's pitch (EVA02's SwiGLU hidden at 2752 columns; 2736 is the 16-byte minimum)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,pitch", [(170, 176), (2730, 2736), (768, 776)])
def test_plain_writes_the_row_then_zeros_at_a_wider_pitch(c, pitch, dtype, params, fake_card):
    """At ``out_pitch`` > C the first C columns are the pitch-C result bit
    for bit and the rest 0, from the plain version and through the wrapper,
    with x read in place at that pitch as the SwiGLU lays it out, with f32
    and bf16 parameters."""
    x = _view(5, c, dtype, pitch=pitch)
    w, b = _affine(c, params)
    want = L.layernorm_plain(x, w, b, eps=1e-6, dtype=dtype)
    got = L.layernorm_plain(x, w, b, eps=1e-6, dtype=dtype, out_pitch=pitch)
    wrapped = L.layernorm(x, w, b, eps=1e-6, dtype=dtype, out_pitch=pitch)
    (call,) = fake_card
    assert (call["pitch"], call["out_pitch"]) == (pitch, pitch)
    assert got.shape == wrapped.shape == (5, pitch) and want.shape == (5, c)
    assert torch.equal(_bits(got[:, :c]), _bits(want)) and torch.equal(_bits(wrapped), _bits(got))
    assert torch.equal(got[:, c:], torch.zeros(5, pitch - c, dtype=dtype))


@pytest.mark.parametrize("route", ["fake_card", "cpu"])
@pytest.mark.parametrize("c,pitch,dtype", [(2730, 2732, torch.bfloat16), (2730, 2734, torch.float32),
                                           (2730, 2729, torch.bfloat16), (768, 772, torch.bfloat16)])
def test_wrapper_refuses_an_output_pitch_off_16_bytes(c, pitch, dtype, route, request):
    calls = request.getfixturevalue("fake_card") if route == "fake_card" else []
    w, b = _affine(c)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        L.layernorm(_rows(3, c, torch.bfloat16), w, b, eps=1e-6, dtype=dtype, out_pitch=pitch)
    assert calls == []


@pytest.mark.parametrize("route", ["fake_card", "cpu"])
@pytest.mark.parametrize("x_dtype,dtype,post", [(torch.bfloat16, torch.bfloat16, True),
                                                (torch.float32, torch.bfloat16, False)])
def test_wrapper_refuses_a_wider_pitch_with_a_shortcut_or_a_narrower_output(x_dtype, dtype, post, route, request):
    """The kernel's padded instances hold epilogue 0 with x in the output's
    type: a shortcut, or f32 x with a bf16 output, is refused at a wider
    pitch on both routes."""
    calls = request.getfixturevalue("fake_card") if route == "fake_card" else []
    w, b = _affine(2730)
    shortcut = _rows(3, 2730, dtype, seed=3) if post else None
    with pytest.raises(ValueError, match="without a shortcut and from x no wider"):
        L.layernorm(_rows(3, 2730, x_dtype), w, b, eps=1e-6, dtype=dtype, shortcut=shortcut, out_pitch=2736)
    assert calls == []


def test_output_pitch_of_c_gives_todays_launch_arguments(monkeypatch):
    """The arguments handed to ``layernorm_launch``: at the default pitch
    the output's rows are C apart (the launch before the output had a
    pitch); a sub-LayerNorm at a 2736 pitch reads and writes at that pitch and
    keeps the body it has at 2730 (the loads are unchanged)."""
    calls = []

    class Library:
        def layernorm_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(L, "on_card", lambda x: True)
    monkeypatch.setattr(L, "_library", Library)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 7}))
    table = L.rsqrt_estimate_table().ctypes.data

    def launch(c, pitch, out_pitch):
        x, (w, b) = _view(6, c, torch.bfloat16, pitch=pitch), _affine(c)
        out = L.layernorm(x, w, b, eps=1e-5, dtype=torch.bfloat16, out_pitch=out_pitch)
        assert out.shape == (6, c if out_pitch is None else out_pitch)
        return calls.pop(), (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr())

    args, (xp, wp, bp, op) = launch(768, None, None)
    assert args == (xp, 768, None, 0, wp, bp, op, 768, 6, 768, 1, 1, 0, 0, 8, 32, 4, 1e-5, table, 7)
    args, (xp, wp, bp, op) = launch(2730, None, None)
    assert args == (xp, 2730, None, 0, wp, bp, op, 2730, 6, 2730, 1, 1, 0, 0, 2, 128, 12, 1e-5, table, 7)
    args, (xp, wp, bp, op) = launch(2730, 2736, 2736)
    assert args == (xp, 2736, None, 0, wp, bp, op, 2736, 6, 2730, 1, 1, 0, 0, 2, 128, 12, 1e-5, table, 7)


def test_bf16_input_with_an_f32_output_is_widened_first(fake_card):
    w, b = _affine(256)
    x = _rows(4, 256, torch.bfloat16)
    got = L.layernorm(x, w, b, eps=1e-5, dtype=torch.float32)
    assert fake_card[0]["x"] == torch.float32 and got.dtype == torch.float32
    assert torch.equal(got, L.layernorm_plain(x.float(), w, b, eps=1e-5, dtype=torch.float32))


# ---------------------------------------------------------------------------
# The plain version: the kernel's arithmetic in the kernel's order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,body_of", [(128, (8, 16, 1)), (128, (4, 32, 2)), (130, (2, 128, 4)),
                                      (131, (1, 256, 8)), (1365, (1, 128, 12))])
def test_row_sums_follow_the_body(c, body_of):
    """The kernel's order, written out with Python floats rounded to f32
    after every add: thread j's chunks in order, butterflies, warp sums."""
    e, t, k = body_of
    x = _rows(5, c, torch.float32, seed=7)
    s, q = L.row_sums(x, e, t, k)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    for r in range(5):
        window = [float(v) for v in x[r]]
        lanes_s, lanes_q = [], []
        for j in range(t):
            acc_s = acc_q = 0.0
            for kk in range(k):
                chunk = j + t * kk
                for v in window[chunk * e:(chunk + 1) * e]:
                    acc_s, acc_q = f32(acc_s + v), f32(acc_q + f32(v * v))
            lanes_s.append(acc_s)
            lanes_q.append(acc_q)
        width = min(t, 32)
        for o in (16, 8, 4, 2, 1):
            if o < width:
                lanes_s = [f32(lanes_s[i] + lanes_s[i ^ o]) for i in range(t)]
                lanes_q = [f32(lanes_q[i] + lanes_q[i ^ o]) for i in range(t)]
        warps_s, warps_q = lanes_s[::width], lanes_q[::width]
        total_s, total_q = warps_s[0], warps_q[0]
        for ws, wq in zip(warps_s[1:], warps_q[1:]):
            total_s, total_q = f32(total_s + ws), f32(total_q + wq)
        assert (float(s[r, 0]), float(q[r, 0])) == (total_s, total_q)


def test_mean_is_the_sum_times_the_reciprocal_of_c():
    """As torch's CUDA ``mean`` (``MeanOps``: the sum times fl(1/C)): the row
    (7, 0, 0) centres on 7 * fl(1/3) = 2.33333349, not on 7 / 3 rounded,
    2.33333325 (torch's CPU ``mean``)."""
    x = torch.tensor([[7.0, 0.0, 0.0]])
    w, b = torch.ones(3), torch.zeros(3)
    got = L.layernorm_plain(x, w, b, eps=1e-5, dtype=torch.float32)
    f = np.float32
    for mean, equal in ((f(7) * (f(1) / f(3)), True), (f(7) / f(3), False)):
        var = max(f(f(49) * (f(1) / f(3))) - f(mean * mean), f(0)) if equal else f(f(49) / f(3)) - f(mean * mean)
        inv = xla_math.rsqrt_plain(torch.tensor([var + f(1e-5)]))
        want = ((x - float(mean)) * inv).float()
        assert torch.equal(got, want) == equal


def _integer_rows(r, c, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-40, 41, (r, c), generator=g).to(dtype)


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [128, 256, 512, 1024])
def test_equals_the_module_chain_bit_for_bit_where_the_sums_are_exact(c, dtype, post):
    """Integer rows: S and Q exact in any order; C a power of two: dividing
    by C and multiplying by fl(1/C) agree. What is left is the epilogue,
    which must be the chain's step for step (the clamp, each rounding, the
    post-norm's two roundings to bf16)."""
    x = _integer_rows(16, c, dtype, seed=c)
    shortcut = _rows(16, c, dtype, seed=2) if post else None
    w, b = _affine(c)
    m = _post_norm(c, dtype, w, b) if post else _vit_norm(c, dtype, w, b)
    with torch.no_grad():
        want = m(x, shortcut) if post else m(x)
    got = L.layernorm_plain(x, w, b, eps=1e-5, dtype=dtype, shortcut=shortcut)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)


def test_clamp_holds_for_a_constant_row():
    """A constant row: E[x^2] - E[x]^2 may round below 0; flax's clamp keeps
    the rsqrt finite where the post-norm's formula does not clamp."""
    x = torch.full((4, 768), 0.1)
    w, b = _affine(768)
    with torch.no_grad():
        want = _vit_norm(768, torch.float32, w, b)(x)
    got = L.layernorm_plain(x, w, b, eps=1e-5, dtype=torch.float32)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-3)


def _tolerance(want, c, dtype, bias, shortcut=None):
    """What the sums' order explains: each sum may move by (C - 1) u of its
    terms' magnitude, so the f32 value before the last rounding by about
    C u of its terms, |y| + 2 |b| (+ |shortcut|); in bf16 each rounding adds
    at most a step (one, or two through the post-norm's rounding of y and
    then of the sum)."""
    w = want.float().abs()
    s = 0.0 if shortcut is None else shortcut.float().abs()
    f32 = c * U * (w + 2 * bias.float().abs().to(w.device) + s)
    if dtype == torch.float32:
        return f32
    return f32 + 2.0**-7 * (w if shortcut is None else 2 * w + s)


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", CELL_COLS)
def test_held_to_the_module_chain_within_the_sums_order(c, dtype, post):
    x = _rows(64, c, dtype, seed=c + 1)
    shortcut = _rows(64, c, dtype, seed=3) if post else None
    w, b = _affine(c)
    m = _post_norm(c, dtype, w, b) if post else _vit_norm(c, dtype, w, b)
    with torch.no_grad():
        want = m(x, shortcut) if post else m(x)
    got = L.layernorm_plain(x, w, b, eps=1e-5, dtype=dtype, shortcut=shortcut)
    assert got.dtype == dtype
    gap = (got.float() - want.float()).abs()
    assert (gap <= _tolerance(want, c, dtype, b, shortcut)).all(), float(gap.max())
    if dtype == torch.bfloat16:
        assert float((got != want).float().mean()) <= 0.01


@pytest.mark.parametrize("post", [False, True])
def test_bf16_parameters_are_read_as_stored(post, fake_card):
    w, b = _affine(512, torch.bfloat16)
    x = _rows(8, 512, torch.bfloat16)
    shortcut = _rows(8, 512, torch.bfloat16, seed=4) if post else None
    got = L.layernorm(x, w, b, eps=1e-5, dtype=torch.bfloat16, shortcut=shortcut)
    assert fake_card[0]["params"] == (torch.bfloat16, torch.bfloat16)
    assert torch.equal(got, L.layernorm_plain(x, w.float(), b.float(), eps=1e-5, dtype=torch.bfloat16,
                                              shortcut=shortcut))


# ---------------------------------------------------------------------------
# On a card: the kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


# (rows, C, x dtype, output dtype, post-norm): each LayerNorm of the three
# tagging cells at batch 32, and f32 forms of them
CARD_CASES = [
    (25120, 768, torch.bfloat16, torch.bfloat16, False), (25120, 768, torch.float32, torch.bfloat16, False),
    (32800, 1024, torch.bfloat16, torch.bfloat16, False), (32800, 2730, torch.bfloat16, torch.bfloat16, False),
    (32, 1024, torch.bfloat16, torch.bfloat16, False),
    (401408, 128, torch.bfloat16, torch.bfloat16, True), (100352, 256, torch.bfloat16, torch.bfloat16, True),
    (25088, 512, torch.bfloat16, torch.bfloat16, True), (6272, 1024, torch.bfloat16, torch.bfloat16, True),
    (401408, 128, torch.bfloat16, torch.bfloat16, False), (100352, 256, torch.bfloat16, torch.bfloat16, False),
    (25088, 512, torch.bfloat16, torch.bfloat16, False), (6272, 1024, torch.bfloat16, torch.bfloat16, False),
    (4096, 768, torch.float32, torch.float32, False), (4096, 2730, torch.float32, torch.float32, False),
    (4096, 128, torch.float32, torch.float32, True), (4096, 1024, torch.float32, torch.float32, True),
    # rows shifted in their windows: odd and unaligned widths, a block a row
    (4099, 1023, torch.bfloat16, torch.bfloat16, False), (4099, 130, torch.bfloat16, torch.bfloat16, True),
    (4099, 2731, torch.float32, torch.float32, False), (4099, 5, torch.float32, torch.bfloat16, False),
    (1031, 4095, torch.bfloat16, torch.bfloat16, True),
]


@pytest.mark.card
@pytest.mark.parametrize("rows,c,x_dtype,dtype,post", CARD_CASES)
def test_card_kernel_is_bit_equal_to_its_plain_version(rows, c, x_dtype, dtype, post, card):
    x = _rows(rows, c, x_dtype).to(card)
    shortcut = _rows(rows, c, dtype, seed=9).to(card) if post else None
    w, b = (p.to(card) for p in _affine(c))
    got = L.layernorm(x, w, b, eps=1e-6, dtype=dtype, shortcut=shortcut)
    want = L.layernorm_plain(x, w, b, eps=1e-6, dtype=dtype, shortcut=shortcut)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.card
@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("offset,pitch,params", [(2, None, torch.float32), (8, None, torch.float32),
                                                 (0, 776, torch.float32), (4, 770, torch.bfloat16),
                                                 (0, None, torch.bfloat16)])
def test_card_misaligned_strided_rows_and_bf16_parameters(post, offset, pitch, params, card):
    x = _view(997, 768, torch.bfloat16, offset_bytes=offset, pitch=pitch)
    big = torch.empty(x.shape[0] * (x.stride(0)) + 16, dtype=torch.bfloat16, device=card)
    on_card = big[offset // 2:][: x.shape[0] * x.stride(0)].view(x.shape[0], x.stride(0))[:, :768]
    on_card.copy_(x)
    shortcut = _rows(997, 768, torch.bfloat16, seed=5).to(card) if post else None
    w, b = (p.to(card) for p in _affine(768, params))
    got = L.layernorm(on_card, w, b, eps=1e-5, dtype=torch.bfloat16, shortcut=shortcut)
    want = L.layernorm_plain(on_card, w, b, eps=1e-5, dtype=torch.bfloat16, shortcut=shortcut)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.card
@pytest.mark.parametrize("rows,c,pitch,dtype,params", [(32800, 2730, 2752, torch.bfloat16, torch.float32),
                                                       (32800, 2730, 2736, torch.bfloat16, torch.bfloat16),
                                                       (4099, 170, 176, torch.float32, torch.float32),
                                                       (4099, 768, 776, torch.bfloat16, torch.bfloat16)])
def test_card_output_at_a_wider_pitch_is_bit_equal_to_its_plain_version(rows, c, pitch, dtype, params, card):
    """x read in place at the pitch, the output written at it, over memory
    the allocator last held as NaN: the C columns and the zeros after them
    bit-equal to the plain version."""
    x = _rows(rows, pitch, dtype).to(card)[:, :c]
    w, b = (p.to(card) for p in _affine(c, params))
    del_me = torch.full((rows, pitch), float("nan"), dtype=dtype, device=card)
    del del_me
    got = L.layernorm(x, w, b, eps=1e-6, dtype=dtype, out_pitch=pitch)
    want = L.layernorm_plain(x, w, b, eps=1e-6, dtype=dtype, out_pitch=pitch)
    torch.cuda.synchronize()
    assert got.shape == (rows, pitch) and torch.equal(_bits(got), _bits(want))


@pytest.mark.card
@pytest.mark.parametrize("c,post", [(768, False), (1024, False), (2730, False), (128, True), (512, True)])
def test_card_share_of_outputs_apart_from_the_chain(c, post, card):
    """The kernel against the modules' chains on the card (the same torch
    ``mean``): apart only by the sums' order, a bf16 step on a few outputs."""
    x = _rows(8192, c, torch.bfloat16).to(card)
    shortcut = _rows(8192, c, torch.bfloat16, seed=6).to(card) if post else None
    w, b = _affine(c)
    m = (_post_norm(c, torch.bfloat16, w, b) if post else _vit_norm(c, torch.bfloat16, w, b)).to(card)
    with torch.inference_mode():
        got = m(x, shortcut) if post else m(x)
    with torch.no_grad():
        m.requires_grad_(True)
        with torch.enable_grad():
            want = (m(x, shortcut) if post else m(x)).detach()
    apart = float((got != want).float().mean())
    print(f"layernorm C={c} post={post}: {apart:.4%} of bf16 outputs apart from the chain")
    assert (got.float() - want.float()).abs().le(_tolerance(want, c, torch.bfloat16, b, shortcut)).all()
    assert apart <= 0.01
