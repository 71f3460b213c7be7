"""Host-side pieces of the int8 ladder on Hopper's int8 tensor cores
(csrc/quant.cu `qmlp_wgmma_kernel`) and of the knn kernels' bound, held on
the CPU.

The kernel runs only on the card (chip_smoke.py holds it against
`quantized_mlp_head_plain` there, bit for bit, in both rounding modes).
What the CPU can check is what it is handed and how it pads: the weights
as `pack_weights` gives them to TMA (16-byte rows, zero columns), read
here by a ladder that sees only what the kernel sees (x's codes over
128-column tiles, weight rows padded to a multiple of 128 and columns past
the packed width read as zeros, scales and biases masked to 0), which must
equal the plain version exactly; the shared-memory plan and the width
limits, against the constants of the CUDA source; and the wrapper's
refusals, before any launch, through a recording fake library.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from plr2_tpu_torch.ops import _build, knn, quant

torch.set_num_threads(2)

YCB = (1408, 640, 256, 128, 84)
RAGGED = (200, 72, 40, 24, 5)
ODD_C0 = (202, 40, 24, 12, 5)
SOURCE = Path(quant.__file__).resolve().parent.parent / "csrc" / "quant.cu"


def _up(n, m):
    return -(-n // m) * m


def _ladder(rng, widths):
    """Port-layout qparams of seeded f32 layers, N(0, 1/Cin) weights."""
    layers = [(torch.from_numpy((rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32)),
               torch.from_numpy((rng.normal(size=(o,)) * 0.05).astype(np.float32)))
              for i, o in zip(widths[:-1], widths[1:])]
    return quant.quantize_weights(layers)


def kernel_ladder(x, qparams, seed, stochastic):
    """The ladder over what the kernel reads: x's codes over round128(C0)
    columns (zeros past C0), each layer's packed weights with rows past N
    and columns past round16(K) read as zeros (TMA's fill) and its output
    over round128(N) columns, scales and biases read as 0 past N (masked
    loads), and the next layer's codes over all those columns."""
    h = F.pad(x, (0, _up(x.shape[1], 128) - x.shape[1]))
    for layer, (w, s, b) in enumerate(qparams):
        n, k = w.shape
        wp = quant.pack_weights(w)
        assert wp.dtype == torch.int8 and wp.shape == (n, _up(k, 16))
        assert wp.is_contiguous() and torch.equal(wp[:, :k], w) and not wp[:, k:].any()
        codes, a = quant.activation_codes(h, seed, layer, stochastic)
        np_ = _up(n, 128)
        wt = torch.zeros((np_, codes.shape[1]), dtype=torch.float64)
        wt[:n, :wp.shape[1]] = wp.double()
        acc = torch.matmul(codes.double(), wt.t())  # exact int32 sums
        h = acc.float() * a * F.pad(s, (0, np_ - n)) + F.pad(b, (0, np_ - n))
        if layer == len(qparams) - 1:
            return h[:, :n]
        h = torch.relu(h)


@pytest.mark.parametrize("rows,widths", [(130, YCB), (977, RAGGED), (977, ODD_C0)])
@pytest.mark.parametrize("stochastic", [False, True])
def test_padded_ladder_equals_plain_bit_for_bit(rows, widths, stochastic):
    """Zero weight columns and rows, masked scales and biases, and codes
    over padded columns (rint(0) = 0, floor(0 + u) = 0) leave every output
    exactly as the plain version computes it, in both rounding modes."""
    rng = np.random.default_rng(sum(widths) + rows)
    qp = _ladder(rng, widths)
    x = torch.from_numpy(rng.normal(size=(rows, widths[0])).astype(np.float32))
    got = kernel_ladder(x, qp, seed=77, stochastic=stochastic)
    want = quant.quantized_mlp_head_plain(x, qp, seed=77, stochastic=stochastic)
    assert got.shape == (rows, widths[-1])
    assert torch.equal(got, want)


def test_pack_weights_pads_only_what_tma_cannot_read():
    w = torch.arange(-60, 60, dtype=torch.int8).reshape(8, 15)
    p = quant.pack_weights(w)
    assert p.shape == (8, 16) and torch.equal(p[:, :15], w) and not p[:, 15].any()
    aligned = torch.ones((4, 32), dtype=torch.int8)
    assert quant.pack_weights(aligned) is aligned
    # 16-byte aligned rows but a misaligned start: a copy
    view = torch.ones(64, dtype=torch.int8)[1:33].reshape(2, 16)
    assert view.data_ptr() % 16 and quant.pack_weights(view).data_ptr() % 16 == 0


def _constant(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE.read_text())
    assert m, name
    return m.group(1)


def test_smem_plan_mirrors_the_kernel_constants():
    """ops/quant.py's plan and limits are the kernel's (csrc/quant.cu)."""
    assert int(_constant("kMaxLayers")) == quant.MAX_LAYERS
    assert int(_constant("kMaxWidth")) == quant.MAX_WIDTH
    assert 128 * int(_constant("kXVec")) == quant.MAX_INPUT
    assert int(_constant("kSmemLimit")) == quant.SMEM_LIMIT
    assert int(_constant("kSlice")) == 64 and int(_constant("kMaxStages")) == 4
    assert _constant("kSmemTail") == ("2 * kBM * 4 + kBM * 4 + 2 * kMaxWidth * 4 + "
                                      "16 * kMaxStages")
    assert _constant("kCodeTile") == "kBM * 128" and int(_constant("kBM")) == 64


@pytest.mark.parametrize("widths,plan", [
    (YCB, (3, 1024 + 11 * 8192 + 5952 + 3 * 40960)),    # main path: 219,968 B
    ((1408, 640, 256, 128, 21), (3, 219968)),
    (RAGGED, (4, 1024 + 2 * 8192 + 5952 + 4 * 128 * 64)),
    ((2176, 640), (2, 1024 + 17 * 8192 + 5952 + 2 * 40960)),  # the widest x at N1 = 640
    ((2304, 512), (2, 1024 + 18 * 8192 + 5952 + 2 * 32768)),
])
def test_smem_plan(widths, plan):
    stages, size = quant.smem_plan(widths)
    assert (stages, size) == plan and size <= quant.SMEM_LIMIT


@pytest.mark.parametrize("widths,match", [
    ((1408, 641, 5), "layer 1 has 641 outputs"),
    ((64, 64, 700), "layer 2 has 700 outputs"),
    ((2305, 64), "x has 2305 columns"),
    ((2304, 640), "more than 232448 bytes of shared memory"),
    ((64,), "1..8 layers"),
    ((16,) * 10, "1..8 layers"),
])
def test_smem_plan_refuses(widths, match):
    with pytest.raises(ValueError, match=match):
        quant.smem_plan(widths)


class _FakeLib:
    """Records the arguments of a launch instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))
            return 0
        return record


@pytest.fixture
def fake_lib(monkeypatch):
    """Off the CPU path with meta tensors standing in for the card's, the
    library replaced by a recorder, and the launch count put back after."""
    fake = _FakeLib()
    monkeypatch.setattr(quant, "launches", quant.launches)
    monkeypatch.setattr(_build, "require_cuda", lambda tensors, what: None)
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return fake


def _meta_qparams(widths):
    return [(torch.empty((o, i), dtype=torch.int8, device="meta"),
             torch.empty(o, device="meta"), torch.empty(o, device="meta"))
            for i, o in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize("widths,match", [
    ((1408, 640, 704, 84), "layer 2 has 704 outputs"),
    ((2400, 64, 5), "x has 2400 columns"),
])
def test_wrapper_refuses_widths_before_launching(fake_lib, widths, match):
    with pytest.raises(ValueError, match=match):
        quant.quantized_mlp_head(torch.empty((977, widths[0]), device="meta"),
                                 _meta_qparams(widths))
    assert fake_lib.calls == []


@pytest.mark.parametrize("widths", [YCB, ODD_C0, RAGGED])
@pytest.mark.parametrize("stochastic", [False, True])
def test_wrapper_passes_the_ladder(fake_lib, widths, stochastic):
    """Any widths under the limits launch once, with the true widths (the
    weights' padding is the wrapper's), the row count, seed and mode."""
    out = quant.quantized_mlp_head(torch.empty((977, widths[0]), device="meta"),
                                   _meta_qparams(widths), seed=-1, stochastic=stochastic)
    assert out.shape == (977, widths[-1])
    ((name, args),) = fake_lib.calls
    assert name == "plr2_quantized_mlp_head"
    num = len(widths) - 1
    assert list(args[4]) == list(widths) and args[5:9] == (num, 977, 0xFFFFFFFF,
                                                            int(stochastic))


def test_quant_source_runs_wgmma_not_mma_sync():
    code = re.sub(r"//[^\n]*", "", SOURCE.read_text())
    assert "mma.sync" not in code
    assert "wgmma_m64n256k32_s8" in code and "CU_TENSOR_MAP_DATA_TYPE_UINT8" in code


def test_knn_bound_counts_fp32_issue_slots():
    """8 slots a pair for the exact difference, 5 for the augmented form, at
    the H100's 33.5 T FP32 slots/s: the stage-1 match's least times."""
    pairs = 5 * 500_000 * 500
    assert knn.issue_slots(5 * 500_000, 500) == 8 * pairs
    assert knn.issue_slots(5 * 500_000, 500, augmented=True) == 5 * pairs
    exact_ms = knn.issue_slots(5 * 500_000, 500) / knn.FP32_SLOTS_PER_S * 1e3
    mxu_ms = knn.issue_slots(5 * 500_000, 500, True) / knn.FP32_SLOTS_PER_S * 1e3
    assert round(exact_ms, 3) == 0.299 and round(mxu_ms, 3) == 0.187
