"""Host-side pieces of the f32 kernels on the FP32 cores (csrc/mlp_head.cu
`head_sgemm_kernel`, csrc/upconv.cu `upconv_sgemm_kernel`), held on the
CPU against the plain versions.

The kernels run only on the card (chip_smoke.py holds them against the
plain versions there, at the main-path and at ragged shapes). What the CPU
can check is what the wrappers hand them: the head's W^T packing with
columns padded to 4, run here through a ladder that reads only the packed
layout and the scratch rows the kernel writes; the scratch's size and
layout (h1 and h3 share rows, h2 lies beside them); the decoder's
(9, Cin, round4(Cout)) packing through an implicit GEMM over it; and the
arguments the wrappers pass to the library.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from plr2_tpu_torch import ops
from plr2_tpu_torch.ops import _build, mlp_head, upconv

torch.set_num_threads(2)

HEAD_WIDTHS = (1408, 640, 256, 128)
# the f32 kernel's blocks an H100 (132 SMs) holds at once by split, as
# upconv.card_slots reads them on the card: two an SM unsplit and in
# clusters of 2; clusters of 4 and 8 lose blocks to the GPCs' edges
H100_SLOTS = {1: 264, 2: 264, 4: 248, 8: 240}


def _t(rng, shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _ladder(rng, widths):
    return [(_t(rng, (o, i), i ** -0.5), _t(rng, (o,), 0.1))
            for i, o in zip(widths[:-1], widths[1:])]


def _r4(n):
    return -(-n // 4) * 4


def packed_ladder(x, packed, widths):
    """The ladder as the f32 kernel runs it: layer l reads the first K
    columns of its input rows, from x padded by `pad_x_f32` (K = round4(C))
    or from the scratch, multiplies by the first K rows of the packed W^T
    (round4(K), round4(N)) and writes round4(N) columns (hidden layers) or
    N columns (the last). h1 and h3 go to the first region of one flat
    scratch of `scratch_floats` floats, h2 to the second."""
    x = mlp_head.pad_x_f32(x)
    assert x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0
    widths = (x.shape[1], *widths[1:])
    p = x.shape[0]
    scratch = torch.full((mlp_head.scratch_floats(p, widths),), float("nan"))
    lda, ldb = _r4(max(widths[1], widths[3])), _r4(widths[2])
    assert scratch.numel() == p * (lda + ldb)
    ha = scratch[:p * lda].view(p, lda)
    hb = scratch[p * lda:].view(p, ldb)
    inputs, outs = [x, ha, hb, ha], [ha, hb, ha]
    for l, (wt, b) in enumerate(packed):
        k, n = widths[l], widths[l + 1]
        assert wt.shape == (_r4(k), _r4(n)) and wt.is_contiguous()
        bias = F.pad(b, (0, _r4(n) - n))
        h = inputs[l][:, :k] @ wt[:k] + bias
        if l == 3:
            return h[:, :n]
        outs[l][:, :_r4(n)] = torch.relu(h)


@pytest.mark.parametrize("widths", [HEAD_WIDTHS + (84,), HEAD_WIDTHS + (63,),
                                    HEAD_WIDTHS + (21,), (200, 72, 40, 24, 5),
                                    (64, 21, 30, 13, 3), (202, 40, 24, 12, 5)])
def test_head_packing_and_scratch_give_the_plain_ladder(rng, widths):
    rows = 19 if widths[0] > 1000 else 37
    x = _t(rng, (rows, widths[0]))
    params = _ladder(rng, widths)
    got = packed_ladder(x, mlp_head.pack_weights_f32(params), widths)
    want = mlp_head.mlp_head_plain(x, params)
    # f32 sums in another order (the kernel's tolerance on the card)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


def test_head_packing_is_w_transposed_with_zero_padding(rng):
    params = _ladder(rng, (13, 10, 8, 7, 5))
    for (w, b), (wt, bp) in zip(params, mlp_head.pack_weights_f32(params)):
        n, k = w.shape
        assert wt.shape == (_r4(k), _r4(n)) and wt.is_contiguous() and bp is b
        assert torch.equal(wt[:k, :n], w.t())
        assert not wt[:, n:].any() and not wt[k:].any()
        assert wt.data_ptr() % 16 == 0


def test_head_pads_x_only_where_c_is_not_a_multiple_of_4(rng):
    x = _t(rng, (5, 12))
    assert mlp_head.pad_x_f32(x) is x
    x = _t(rng, (5, 13))
    xp = mlp_head.pad_x_f32(x)
    assert xp.shape == (5, 16) and torch.equal(xp[:, :13], x) and not xp[:, 13:].any()


@pytest.mark.parametrize("rows,widths,floats", [
    (8000, HEAD_WIDTHS + (84,), 8000 * (640 + 256)),
    (977, (200, 72, 40, 24, 5), 977 * (72 + 40)),
    (5, (64, 21, 30, 13, 3), 5 * (24 + 32)),
    (0, HEAD_WIDTHS + (21,), 0)])
def test_head_scratch_size(rows, widths, floats):
    assert mlp_head.scratch_floats(rows, widths) == floats


def implicit_gemm_f32(x, wp, bias, alpha, cout):
    """The decoder stage as the f32 kernel computes it over the packed
    weights (9, Cin, round4(Cout)): the f32 upsampled map zero-padded by one
    pixel, and for each tap t = 3 dy + dx the window shifted by (dy, dx)
    times wp[t] (Cin -> round4(Cout)), summed; then bias and PReLU."""
    up = upconv.upsample2x_bilinear(x)
    b, h2, w2, _ = up.shape
    pad = F.pad(up, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, h2, w2, wp.shape[2]))
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        acc += pad[:, dy:dy + h2, dx:dx + w2, :] @ wp[tap]
    y = acc[..., :cout] + bias
    return torch.where(y >= 0, y, alpha.reshape(()) * y)


@pytest.mark.parametrize("shape", [(2, 5, 7, 16, 24), (1, 4, 4, 6, 10),
                                   (1, 3, 5, 37, 130)])
def test_upconv_packing_gives_the_plain_stage(rng, shape):
    b, h, w, cin, cout = shape
    x = _t(rng, (b, h, w, cin))
    wk = _t(rng, (3, 3, cin, cout), (9 * cin) ** -0.5)
    bias, alpha = _t(rng, (cout,), 0.1), torch.tensor([0.25])
    wp = upconv.pack_weights_f32(wk)
    assert wp.shape == (9, cin, _r4(cout)) and wp.is_contiguous()
    got = implicit_gemm_f32(x, wp, bias, alpha, cout)
    want = upconv.upconv3x3_prelu_plain(x, wk, bias, alpha)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_upconv_packing_is_a_view_when_cout_is_a_multiple_of_4(rng):
    w = _t(rng, (3, 3, 12, 24))
    wp = upconv.pack_weights_f32(w)
    assert wp.data_ptr() == w.data_ptr() and wp.shape == (9, 12, 24)
    w2 = _t(rng, (3, 3, 12, 22))
    wp2 = upconv.pack_weights_f32(w2)
    assert torch.equal(wp2[..., :22], w2.reshape(9, 12, 22))
    assert not wp2[..., 22:].any()


class _FakeLib:
    """Records the arguments of a launch instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))
            return 0
        return record


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.fixture
def fake_lib(monkeypatch):
    """Off the CPU path with meta tensors standing in for the card's and
    the library replaced by a recorder."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "require_cuda", lambda tensors, what: None)
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(upconv, "card_slots", lambda device: H100_SLOTS)
    return fake


@pytest.mark.parametrize("widths", [HEAD_WIDTHS + (63,), (202, 40, 24, 12, 5),
                                    (5, 3, 7, 2, 1)])
def test_f32_head_wrapper_takes_any_width(fake_lib, widths):
    """The f32 head packs, sizes the scratch and passes the widths the C
    entry point expects, whatever the widths (C padded to a multiple of 4)."""
    params = [(_meta(o, i), _meta(o)) for i, o in zip(widths[:-1], widths[1:])]
    out = mlp_head.mlp_head_forward(_meta(977, widths[0]), params)
    assert out.shape == (977, widths[-1])
    ((name, args),) = fake_lib.calls
    assert name == "plr2_mlp_head" and args[0] == _build.DTYPE_CODES[torch.float32]
    assert args[12:18] == (977, _r4(widths[0]), *widths[1:])


def test_f32_upconv_wrapper_passes_the_stage(fake_lib):
    out = upconv.upconv3x3_prelu_forward(_meta(1, 9, 6, 37), _meta(3, 3, 37, 130),
                                         _meta(130), _meta(1))
    assert out.shape == (1, 18, 12, 130)
    ((name, args),) = fake_lib.calls
    assert name == "plr2_upconv3x3_prelu" and args[6:11] == (1, 9, 6, 37, 130)


# the decoder stages (b, h, w, Cin, Cout) and the f32 plan (tile, split)
# on an H100: batch 1 at a 160 px crop (a per-sample training forward) and
# at 240 (one crop served), batch 8 and 128 at 160 (chip_smoke.py's
# kernels phase) and 32 (the batched trainer), and chip_smoke.py's ragged
# stages; only batch-1-sized grids split
PLANS = [
    ((1, 20, 20, 1024, 256), (1, 8)), ((1, 40, 40, 256, 64), (2, 8)),
    ((1, 80, 80, 64, 64), (2, 2)),
    ((1, 30, 30, 1024, 256), (1, 2)), ((1, 60, 60, 256, 64), (2, 2)),
    ((1, 120, 120, 64, 64), (2, 1)),
    ((8, 20, 20, 1024, 256), (1, 1)), ((8, 40, 40, 256, 64), (2, 1)),
    ((8, 80, 80, 64, 64), (2, 1)),
    ((32, 20, 20, 1024, 256), (1, 1)), ((32, 40, 40, 256, 64), (2, 1)),
    ((32, 80, 80, 64, 64), (2, 1)),
    ((128, 20, 20, 1024, 256), (0, 1)), ((128, 40, 40, 256, 64), (2, 1)),
    ((128, 80, 80, 64, 64), (2, 1)),
    ((1, 5, 7, 64, 24), (2, 8)), ((3, 21, 13, 1024, 256), (1, 2)),
    ((3, 5, 7, 1024, 24), (2, 8)), ((1, 21, 13, 64, 256), (1, 8)),
    ((2, 5, 7, 6, 10), (2, 1)), ((1, 9, 6, 37, 130), (1, 4)),
]


def tile_by_waves(b, h, w, cout, slots):
    """The tile rule written out independently of `f32_plan`: 16 x 16 x
    64 below 128 channels, else 8 x 8 x 256 only where it takes fewer
    waves (by the 20 : 19 margin) than 8 x 16 x 128."""
    if cout < 128:
        return 2

    def waves(th, tw, nb):
        blocks = b * -(-2 * h // th) * -(-2 * w // tw) * -(-cout // nb)
        return -(-blocks // slots)
    return 0 if cout >= 256 and 20 * waves(8, 8, 256) < 19 * waves(8, 16, 128) else 1


@pytest.mark.parametrize("shape,plan", PLANS)
def test_f32_plan(shape, plan):
    b, h, w, cin, cout = shape
    tile, split = upconv.f32_plan(*shape, H100_SLOTS)
    assert (tile, split) == plan
    assert tile == tile_by_waves(b, h, w, cout, H100_SLOTS[1])
    th, tw, nb, ck = upconv.F32_TILES[tile]
    blocks = b * -(-2 * h // th) * -(-2 * w // tw) * -(-cout // nb)
    assert split in (1, 2, 4, 8) and split <= -(-cin // ck)
    assert split == 1 or blocks * split <= H100_SLOTS[split]
    # the largest such split: twice as many would not fit or has no chunks
    assert (split == 8 or blocks * 2 * split > H100_SLOTS[2 * split]
            or 2 * split > -(-cin // ck))


def split_implicit_gemm_f32(x, wp, bias, alpha, cout, ck, split):
    """`implicit_gemm_f32` as a split launch computes it: rank r sums the
    taps over its chunks [r nk / S, (r + 1) nk / S) of CK input channels,
    and the S partial sums are added in rank order before bias and PReLU."""
    up = upconv.upsample2x_bilinear(x)
    b, h2, w2, cin = up.shape
    pad = F.pad(up, (0, 0, 1, 1, 1, 1))
    nk = -(-cin // ck)
    total, seen = None, []
    for r in range(split):
        chunks = range(r * nk // split, (r + 1) * nk // split)
        assert len(chunks) > 0
        seen += chunks
        part = torch.zeros((b, h2, w2, wp.shape[2]))
        for c in chunks:
            lo, hi = c * ck, min(cin, (c + 1) * ck)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                part += pad[:, dy:dy + h2, dx:dx + w2, lo:hi] @ wp[tap, lo:hi]
        total = part if total is None else total + part
    assert seen == list(range(nk))  # every chunk once
    y = total[..., :cout] + bias
    return torch.where(y >= 0, y, alpha.reshape(()) * y)


@pytest.mark.parametrize("shape", [(1, 5, 7, 64, 24), (1, 9, 6, 37, 130),
                                   (1, 4, 4, 24, 10), (1, 3, 5, 40, 256)])
def test_split_partials_give_the_plain_stage(rng, shape):
    b, h, w, cin, cout = shape
    tile, split = upconv.f32_plan(*shape, H100_SLOTS)
    assert split > 1
    x = _t(rng, (b, h, w, cin))
    wk = _t(rng, (3, 3, cin, cout), (9 * cin) ** -0.5)
    bias, alpha = _t(rng, (cout,), 0.1), torch.tensor([0.25])
    got = split_implicit_gemm_f32(x, upconv.pack_weights_f32(wk), bias, alpha,
                                  cout, upconv.F32_TILES[tile][3], split)
    want = upconv.upconv3x3_prelu_plain(x, wk, bias, alpha)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 9, 6, 37, 130), (1, 30, 30, 1024, 256),
                                   (8, 20, 20, 1024, 256), (2, 5, 7, 6, 10)])
def test_f32_upconv_wrapper_passes_the_plan(fake_lib, monkeypatch, shape):
    """One C call a launch, the plan as its two trailing arguments, and the
    split launches counted apart."""
    monkeypatch.setattr(upconv, "launches", 0)
    monkeypatch.setattr(upconv, "split_launches", 0)
    b, h, w, cin, cout = shape
    upconv.upconv3x3_prelu_forward(_meta(b, h, w, cin), _meta(3, 3, cin, cout),
                                   _meta(cout), _meta(1))
    ((name, args),) = fake_lib.calls
    plan = upconv.f32_plan(*shape, H100_SLOTS)
    assert name == "plr2_upconv3x3_prelu" and args[6:11] == shape
    assert args[12:] == plan
    assert (upconv.launches, upconv.split_launches) == (1, int(plan[1] > 1))
    counts = ops.launch_counts()
    assert counts["upconv3x3_prelu"] == 1
    assert counts["upconv3x3_prelu.split"] == int(plan[1] > 1)
    ops.reset_launch_counts()
    assert ops.launch_counts()["upconv3x3_prelu.split"] == 0


def test_bf16_upconv_wrapper_passes_an_unsplit_plan(fake_lib, monkeypatch):
    monkeypatch.setattr(upconv, "launches", 0)
    monkeypatch.setattr(upconv, "split_launches", 0)
    meta = lambda *s: torch.empty(s, device="meta", dtype=torch.bfloat16)
    upconv.upconv3x3_prelu_forward(meta(1, 9, 6, 40), meta(3, 3, 40, 130),
                                   meta(130), meta(1))
    ((name, args),) = fake_lib.calls
    assert args[0] == _build.DTYPE_CODES[torch.bfloat16] and args[12:] == (0, 1)
    assert upconv.split_launches == 0


@pytest.mark.parametrize("batch,crop,splits", [(1, 240, 2), (1, 160, 3),
                                               (2, 240, 2)])
def test_psp_decoder_splits_at_one_crop(monkeypatch, batch, crop, splits):
    """The stages a PSPNet forward hands the decoder kernel, planned for
    an H100: up_1 and up_2 split at a 240 px crop, all three at 160."""
    from plr2_tpu_torch.models.pspnet import PSPNet
    plans = []

    def record(x, w, bias, alpha):
        plans.append(upconv.f32_plan(*x.shape, w.shape[3], H100_SLOTS))
        return upconv.upconv3x3_prelu_plain(x, w, bias, alpha)

    monkeypatch.setattr(upconv, "upconv3x3_prelu_forward", record)
    torch.manual_seed(0)
    net = PSPNet().eval()
    with torch.no_grad():
        net(torch.randn(batch, crop, crop, 3), torch.zeros((batch, 4), dtype=torch.long))
    assert len(plans) == 3
    assert sum(split > 1 for _, split in plans) == splits
