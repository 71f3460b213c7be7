"""Host-side pieces of the bf16 tensor-core kernels (csrc/mlp_head.cu and
csrc/upconv.cu, wgmma fed by TMA), held on the CPU against the plain
versions.

The kernels themselves run only on the card (chip_smoke.py holds them
against the plain versions there, at the main-path and at ragged shapes).
What the CPU can check is what surrounds them: the decoder's weight
packing, as an implicit GEMM over the packed weights against
``upconv3x3_prelu_plain``; the head kernel's zero padding of every width
to 64, which TMA's zero fill does on chip; the width checks that refuse
what TMA cannot load; and the 16-byte alignment of what it loads.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from plr2_tpu_torch.ops import _build, mlp_head, upconv

torch.set_num_threads(2)

HEAD_WIDTHS = (1408, 640, 256, 128)


def _t(rng, shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dtype)


def _ladder(rng, widths, dtype=torch.float32):
    return [(_t(rng, (o, i), i ** -0.5, dtype), _t(rng, (o,), 0.1, dtype))
            for i, o in zip(widths[:-1], widths[1:])]


def implicit_gemm_upconv(x, wp, bias, alpha):
    """The decoder stage as the bf16 kernel computes it: the upsampled map
    rounded to x's dtype, zero-padded by one pixel, and for each tap
    t = 3 dy + dx the window shifted by (dy, dx) times wp[t]^T (Cin -> Cout),
    summed in f32; then bias and PReLU in f32, one rounding at the end."""
    up = upconv.upsample2x_bilinear(x).to(x.dtype).float()
    b, h2, w2, _ = up.shape
    pad = F.pad(up, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, h2, w2, wp.shape[1]))
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        acc += pad[:, dy:dy + h2, dx:dx + w2, :] @ wp[tap].float().t()
    y = acc + bias.float()
    y = torch.where(y >= 0, y, alpha.float().reshape(()) * y)
    return y.to(x.dtype)


def test_pack_weights_is_tap_major_k_major(rng):
    w = _t(rng, (3, 3, 24, 40))
    wp = upconv.pack_weights(w)
    assert wp.shape == (9, 40, 24) and wp.is_contiguous()
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(wp[3 * dy + dx], w[dy, dx].t())


@pytest.mark.parametrize("shape", [(2, 5, 7, 16, 24), (1, 4, 4, 64, 8),
                                   (3, 3, 6, 8, 72)])
def test_implicit_gemm_over_packed_weights_matches_plain(rng, shape):
    b, h, w, cin, cout = shape
    x = _t(rng, (b, h, w, cin))
    wk = _t(rng, (3, 3, cin, cout), (9 * cin) ** -0.5)
    bias, alpha = _t(rng, (cout,), 0.1), torch.tensor([0.25])
    got = implicit_gemm_upconv(x, upconv.pack_weights(wk), bias, alpha)
    want = upconv.upconv3x3_prelu_plain(x, wk, bias, alpha)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_implicit_gemm_bf16_rounds_the_upsampled_map_as_plain(rng):
    """In bf16 both round the upsampled map to bf16 before the conv; the
    conv's f32 sums differ in order only."""
    x = _t(rng, (2, 5, 7, 16), 1.0, torch.bfloat16)
    wk = _t(rng, (3, 3, 16, 24), 48 ** -0.5, torch.bfloat16)
    bias = _t(rng, (24,), 0.1, torch.bfloat16)
    alpha = torch.tensor([0.25], dtype=torch.bfloat16)
    got = implicit_gemm_upconv(x, upconv.pack_weights(wk), bias, alpha).float()
    want = upconv.upconv3x3_prelu_plain(x, wk, bias, alpha).float()
    # one bf16 ulp (2^-8 relative) where a sum lands near a rounding boundary
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-2, rtol=2 ** -7)


def _pad_ladder(x, params, to=64):
    """The ladder with every width zero-padded to a multiple of `to`, as the
    head kernel's TMA loads see it (zeros past every edge)."""
    def up(n):
        return -(-n // to) * to
    xp = F.pad(x, (0, up(x.shape[1]) - x.shape[1]))
    out = []
    for w, b in params:
        n, k = w.shape
        out.append((F.pad(w, (0, up(k) - k, 0, up(n) - n)), F.pad(b, (0, up(n) - n))))
    return xp, out


@pytest.mark.parametrize("widths", [(200, 72, 40, 24, 5), (64, 64, 64, 64, 21),
                                    (136, 80, 48, 8, 63)])
def test_head_zero_padding_to_64_changes_nothing(rng, widths):
    """Padded h columns are exactly 0 (zero weight rows, zero bias, ReLU)
    and meet zero weight columns in the next layer: the padded ladder,
    cut back to (P, N4), is the ladder."""
    x = _t(rng, (37, widths[0]))
    params = _ladder(rng, widths)
    xp, pp = _pad_ladder(x, params)
    got = mlp_head.mlp_head_plain(xp, pp)[:, :widths[-1]]
    np.testing.assert_allclose(got.numpy(), mlp_head.mlp_head_plain(x, params).numpy(),
                               atol=1e-5, rtol=1e-5)
    xb = x.bfloat16()
    pb = [(w.bfloat16(), b.bfloat16()) for w, b in params]
    xpb, ppb = _pad_ladder(xb, pb)
    gotb = mlp_head.mlp_head_plain(xpb, ppb)[:, :widths[-1]]
    # bf16 between layers: the padding adds exact zeros to each f32 sum,
    # so only the summation order can differ
    np.testing.assert_allclose(gotb.float().numpy(),
                               mlp_head.mlp_head_plain(xb, pb).float().numpy(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("n4", [21, 63, 84])
def test_head_width_check_takes_the_main_path(n4):
    x = torch.empty((977, HEAD_WIDTHS[0]))
    params = [(torch.empty((o, i)), torch.empty(o)) for i, o in
              zip(HEAD_WIDTHS, HEAD_WIDTHS[1:] + (n4,))]
    mlp_head.tc_widths(x, params)


@pytest.mark.parametrize("widths,bad", [((1404, 640, 256, 128, 84), "C = 1404"),
                                        ((1408, 644, 256, 128, 84), "N1 = 644"),
                                        ((1408, 640, 250, 128, 84), "N2 = 250"),
                                        ((1408, 640, 256, 130, 84), "N3 = 130")])
def test_head_width_check_names_the_shape(widths, bad):
    x = torch.empty((8, widths[0]))
    params = [(torch.empty((o, i)), torch.empty(o))
              for i, o in zip(widths[:-1], widths[1:])]
    with pytest.raises(ValueError, match=bad) as e:
        mlp_head.tc_widths(x, params)
    assert str(tuple(x.shape)) in str(e.value)


def test_upconv_width_check():
    upconv.tc_widths(torch.empty((3, 21, 13, 1024)), torch.empty((3, 3, 1024, 24)))
    with pytest.raises(ValueError, match=r"Cin = 12.*\(1, 5, 7, 12\)"):
        upconv.tc_widths(torch.empty((1, 5, 7, 12)), torch.empty((3, 3, 12, 24)))


def test_bf16_wrappers_refuse_widths_before_launching(monkeypatch):
    """Off the CPU the bf16 wrappers check widths before they pack, align
    or launch anything (meta tensors stand in for the card's)."""
    monkeypatch.setattr(_build, "require_cuda", lambda tensors, what: None)
    monkeypatch.setattr(_build, "lib", lambda: pytest.fail("launched"))

    def meta(*shape):
        return torch.empty(shape, device="meta", dtype=torch.bfloat16)
    params = [(meta(o, i), meta(o)) for i, o in ((12, 16), (16, 8), (8, 8), (8, 3))]
    with pytest.raises(ValueError, match=r"C = 12.*\(10, 12\)"):
        mlp_head.mlp_head_forward(meta(10, 12), params)
    with pytest.raises(ValueError, match=r"Cin = 12"):
        upconv.upconv3x3_prelu_forward(meta(1, 5, 7, 12), meta(3, 3, 12, 24),
                                       meta(24), meta(1))


def test_aligned16_copies_only_misaligned_data():
    base = torch.arange(40, dtype=torch.bfloat16)
    assert _build.aligned16(base) is base
    view = base[3:]  # 6 bytes past an aligned start
    assert view.data_ptr() % 16 != 0
    fixed = _build.aligned16(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
