"""The yardstick's counts against hand sums."""

import pytest

from benchmark import counts as C


def test_upconv_and_head_counts_by_hand():
    # up_1 of one 240-pixel crop: 1024 -> 256 channels at 60 x 60
    assert C.upconv_flops(1, 30, 30, 1024, 256) == 2 * 60 * 60 * 9 * 1024 * 256
    assert C.upconv_bytes(1, 30, 30, 1024, 256, 2) == 2 * (
        30 * 30 * 1024 + 9 * 1024 * 256 + 256 + 1 + 60 * 60 * 256)
    w = C.head_widths(21)
    assert w == [(1408, 640, 256, 128, 84), (1408, 640, 256, 128, 63),
                 (1408, 640, 256, 128, 21)]
    assert C.head_flops(1000, w[0]) == 2 * 1000 * (
        1408 * 640 + 640 * 256 + 256 * 128 + 128 * 84)
    assert C.decoder_calls(8, 240) == [(8, 30, 30, 1024, 256),
                                       (8, 60, 60, 256, 64),
                                       (8, 120, 120, 64, 64)]


def test_trunk_by_hand_at_240():
    conv = lambda s, a, b, k: 2 * s * s * k * k * a * b
    stem = conv(120, 3, 64, 3) + conv(120, 64, 64, 3) + conv(120, 64, 128, 3)
    l1 = conv(60, 128, 64, 3) + conv(60, 64, 64, 3) + conv(60, 128, 64, 1) \
        + 2 * conv(60, 64, 64, 3)
    l2 = conv(30, 64, 128, 3) + conv(30, 128, 128, 3) + conv(30, 64, 128, 1) \
        + 2 * conv(30, 128, 128, 3)
    l3 = conv(30, 128, 256, 3) + conv(30, 256, 256, 3) \
        + conv(30, 128, 256, 1) + 2 * conv(30, 256, 256, 3)
    l4 = conv(30, 256, 512, 3) + conv(30, 512, 512, 3) \
        + conv(30, 256, 512, 1) + 2 * conv(30, 512, 512, 3)
    assert C.trunk_flops(240) == stem + l1 + l2 + l3 + l4


def test_crop_totals():
    # ~65.6 GFLOP a YCB crop with 2 refine iterations (about 330 a frame
    # of 5 objects); ~32 GFLOP a forward at 160 pixels
    ycb = C.posenet_flops(240, 1000, 21) + 2 * C.refiner_flops(1000, 21)
    assert ycb == pytest.approx(65.6e9, rel=0.01)
    assert C.posenet_flops(160, 1000, 21) == pytest.approx(32.3e9, rel=0.01)


def test_bound_takes_the_longer_side():
    assert C.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert C.bound_s(0, 3.35e12, "float32") == pytest.approx(1.0)
    work = C.forward_kernel_work(2, 160, 100, 5, "float32")
    one = C.forward_kernel_work(1, 160, 100, 5, "float32")
    assert work["mlp_head"] == pytest.approx(2 * one["mlp_head"], rel=0.01)
