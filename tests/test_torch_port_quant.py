"""plr2_tpu_torch.ops.quant (the int8 pose-head ladder) against the JAX
package's `quantized_mlp_head` (Pallas, interpret mode) and
`quantize_weights`, plus the port's stochastic rounding.

JAX's interpret mode always rounds to nearest, so the deterministic path is
held against it. The two are not bit-equal: XLA on the CPU fuses the
dequantise epilogue `acc * a * s + b` and contracts it into an FMA, while
the port (kernel and plain version alike) rounds each product and the sum.
Measured at 512 rows through 1408->640->256->128->84 (seed 0): 24,596 of
43,008 outputs differ, median |d| 7.5e-9, p99 1.2e-7, max 8.2e-3 (0.59% of
max|out|): one ulp of a layer output that lands on a .5 boundary of the
next layer's rounding moves that int8 code by one. Hence the tolerances
below, each with that measurement behind it.

The stochastic path draws from the port's Philox-4x32-10, which has no JAX
counterpart (the TPU PRNG is the TPU's own): it is held against the
generator's published known-answer vectors, for determinism per seed, and
for unbiasedness.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.ops import pallas_quant as jq
from plr2_tpu_torch.ops import _build, launch_counts, quant

torch.set_num_threads(2)

HEAD = [1408, 640, 256, 128, 84]
SMALL = [128, 64, 32, 16]  # tests/test_quant.py's ladder
MASK = 0xFFFFFFFF


def _params(rng, dims):
    """JAX-layout (in, out) f32 layers, N(0, 1/Cin) weights."""
    out = []
    for cin, cout in zip(dims[:-1], dims[1:]):
        w = (rng.normal(size=(cin, cout)) / np.sqrt(cin)).astype(np.float32)
        b = (rng.normal(size=(cout,)) * 0.05).astype(np.float32)
        out.append((w, b))
    return out


def _quantized(params):
    """(JAX qparams, port qparams) of the same f32 layers."""
    jqp = jq.quantize_weights(tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params))
    tqp = quant.quantize_weights([(torch.from_numpy(w.T.copy()), torch.from_numpy(b))
                                  for w, b in params])
    return jqp, tqp


def test_quantize_weights_matches_jax():
    params = _params(np.random.default_rng(0), HEAD)
    jqp, tqp = _quantized(params)
    for (jw, js, jb), (tw, ts, tb) in zip(jqp, tqp):
        assert tw.dtype == torch.int8 and ts.dtype == torch.float32
        assert tw.shape == (jw.shape[1], jw.shape[0])
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).T)
        np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("dims,rows", [(SMALL, 40), (HEAD, 512)],
                         ids=["small-40", "head-512"])
def test_plain_matches_jax_interpret(dims, rows):
    rng = np.random.default_rng(0)
    params = _params(rng, dims)
    jqp, tqp = _quantized(params)
    x = rng.normal(size=(rows, dims[0])).astype(np.float32)
    want = np.asarray(jq.quantized_mlp_head(jnp.asarray(x), jqp, seed=0,
                                            interpret=True))
    got = quant.quantized_mlp_head(torch.from_numpy(x), tqp, stochastic=False)
    assert got.shape == want.shape == (rows, dims[-1])
    assert got.dtype == torch.float32
    d = np.abs(got.numpy() - want)
    scale = np.abs(want).max()
    # rounding-level differences almost everywhere (measured p99 1.2e-7 at
    # max|out| 1.39), a few int8 codes moved by one (max 0.59% of max|out|)
    assert np.percentile(d, 99) <= 1e-6 * scale, (np.percentile(d, 99), scale)
    assert d.max() <= 2e-2 * scale, (d.max(), scale)


def test_layer_by_layer_codes_match_jax():
    """From the same layer input, the next layer's int8 codes of the JAX
    kernel's output and of the port's differ by at most 1, on at most 1e-3
    of the entries (one f32 ulp across a .5 rounding boundary)."""
    rng = np.random.default_rng(1)
    params = _params(rng, HEAD)
    jqp, tqp = _quantized(params)
    h = torch.from_numpy(rng.normal(size=(256, HEAD[0])).astype(np.float32))
    moved = total = 0
    for layer in range(len(HEAD) - 2):
        want = np.asarray(jq.quantized_mlp_head(
            jnp.asarray(h.numpy()), jqp[layer:layer + 1], interpret=True))
        got = quant.quantized_mlp_head_plain(h, tqp[layer:layer + 1], stochastic=False)
        h = torch.relu(got)
        codes_t, _ = quant.activation_codes(h)
        codes_j, _ = quant.activation_codes(torch.relu(torch.from_numpy(want.copy())))
        diff = (codes_t.int() - codes_j.int()).abs()
        assert int(diff.max()) <= 1, layer
        moved += int((diff > 0).sum())
        total += diff.numel()
    assert moved <= 1e-3 * total, (moved, total)


def test_small_ladder_close_to_f32():
    """tests/test_quant.py's accuracy bound, on the port, in both modes."""
    rng = np.random.default_rng(2)
    params = _params(rng, SMALL)
    _, tqp = _quantized(params)
    x = rng.normal(size=(40, SMALL[0])).astype(np.float32)
    ref = x
    for i, (w, b) in enumerate(params):
        ref = ref @ w + b
        if i < len(params) - 1:
            ref = np.maximum(ref, 0.0)
    denom = np.maximum(np.abs(ref), np.abs(ref).mean())
    for stochastic in (False, True):
        out = quant.quantized_mlp_head(torch.from_numpy(x), tqp, seed=7,
                                       stochastic=stochastic).numpy()
        rel = np.abs(out - ref) / denom
        assert np.median(rel) < 0.05 and np.mean(rel) < 0.15, (stochastic, rel)


# ---------------- the stochastic rounding ----------------


def _philox_python(ctr, key):
    """Philox-4x32-10 in Python integers (no 16-bit splitting)."""
    ctr, key = list(ctr), list(key)
    for r in range(10):
        if r:
            key = [(key[0] + 0x9E3779B9) & MASK, (key[1] + 0xBB67AE85) & MASK]
        p0, p1 = 0xD2511F53 * ctr[0], 0xCD9E8D57 * ctr[2]
        ctr = [(p1 >> 32) ^ ctr[1] ^ key[0], p1 & MASK,
               (p0 >> 32) ^ ctr[3] ^ key[1], p0 & MASK]
    return ctr


def test_philox_known_answers():
    # Random123's known-answer vectors for philox4x32-10
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((MASK,) * 4, (MASK, MASK), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        assert tuple(_philox_python(ctr, key)) == want
    zero = torch.zeros(1, dtype=torch.int64)
    assert [int(w) for w in quant.philox4x32(zero, zero, 0, 0)] == list(kat[0][2])
    # the torch twin (counters (c0, c1, 0, 0)) against Python integers
    rng = np.random.default_rng(3)
    c0, c1 = (rng.integers(0, 1 << 32, size=64, dtype=np.int64) for _ in range(2))
    k0, k1 = (int(k) for k in rng.integers(0, 1 << 32, size=2))
    words = torch.stack(quant.philox4x32(torch.from_numpy(c0), torch.from_numpy(c1),
                                         k0, k1), -1)
    for i in range(64):
        assert words[i].tolist() == _philox_python((int(c0[i]), int(c1[i]), 0, 0),
                                                   (k0, k1))


def test_rounding_noise_depends_on_global_row_and_column_only():
    full = quant.rounding_noise(40, 37, seed=5, layer=2)
    assert full.dtype == torch.float32
    assert float(full.min()) >= 0.0 and float(full.max()) < 1.0
    # a row's draws do not depend on how many rows or columns are drawn
    assert torch.equal(quant.rounding_noise(27, 37, 5, 2), full[:27])
    assert torch.equal(quant.rounding_noise(40, 20, 5, 2), full[:, :20])
    assert not torch.equal(quant.rounding_noise(40, 37, 5, 3), full)
    assert not torch.equal(quant.rounding_noise(40, 37, 6, 2), full)


def test_stochastic_is_deterministic_per_seed():
    rng = np.random.default_rng(4)
    _, tqp = _quantized(_params(rng, [64, 32, 8]))
    x = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    a = quant.quantized_mlp_head(x, tqp, seed=3)
    b = quant.quantized_mlp_head(x, tqp, seed=3)
    c = quant.quantized_mlp_head(x, tqp, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_stochastic_rounding_is_unbiased():
    """Over 256 seeds, floor(scaled + u) - scaled has mean ~0: overall
    within 5e-3 (sigma ~1e-3 for 262,144 draws) and per entry within 0.2
    (sigma <= 0.5 / 16 for 256 draws); each code is within 1 of
    round(scaled)."""
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    a = torch.clamp(h.abs().amax(1, keepdim=True) / 127.0, min=1e-12)
    scaled = (h / a).double()
    nearest = torch.clamp(torch.round(h / a), -127, 127)
    err = torch.zeros_like(scaled)
    for seed in range(256):
        codes, a_s = quant.activation_codes(h, seed, layer=1, stochastic=True)
        assert torch.equal(a_s, a)
        assert int((codes.float() - nearest).abs().max()) <= 1
        err += codes.double() - scaled
    err /= 256
    assert abs(float(err.mean())) <= 5e-3, float(err.mean())
    assert float(err.abs().max()) <= 0.2, float(err.abs().max())


# ---------------- the wrapper ----------------


def _meta_qparams(dims, wdtype=torch.int8):
    return [(torch.empty((o, i), dtype=wdtype, device="meta"),
             torch.empty(o, device="meta"), torch.empty(o, device="meta"))
            for i, o in zip(dims[:-1], dims[1:])]


def test_wrapper_raises_off_cpu_without_cuda(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: there
    is no fallback to the plain version, and nothing is counted."""
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        quant.quantized_mlp_head(torch.empty((10, 8), device="meta"),
                                 _meta_qparams([8, 6, 4]))
    # past the device check, the kernel's dtypes and shapes are enforced
    monkeypatch.setattr(_build, "require_cuda", lambda tensors, what: None)
    with pytest.raises(TypeError, match="float32"):
        quant.quantized_mlp_head(torch.empty((10, 8), dtype=torch.float64,
                                             device="meta"), _meta_qparams([8, 6, 4]))
    with pytest.raises(TypeError, match="int8"):
        quant.quantized_mlp_head(torch.empty((10, 8), device="meta"),
                                 _meta_qparams([8, 6, 4], torch.float32))
    with pytest.raises(ValueError, match="layer 2"):
        quant.quantized_mlp_head(torch.empty((10, 8), device="meta"),
                                 _meta_qparams([8, 6, 4])[:1] + _meta_qparams([5, 4]))
    with pytest.raises(ValueError, match="layers"):
        quant.quantized_mlp_head(torch.empty((10, 8), device="meta"),
                                 _meta_qparams([8] * (quant.MAX_LAYERS + 2)))
    assert launch_counts() == before
    assert launch_counts()["quantized_mlp_head"] == 0


def test_cpu_tensors_run_the_plain_version():
    rng = np.random.default_rng(6)
    _, tqp = _quantized(_params(rng, [12, 10, 7]))  # widths not multiples of 4
    x = torch.from_numpy(rng.normal(size=(9, 12)).astype(np.float32))
    for stochastic in (False, True):
        assert torch.equal(
            quant.quantized_mlp_head(x, tqp, seed=1, stochastic=stochastic),
            quant.quantized_mlp_head_plain(x, tqp, seed=1, stochastic=stochastic))
    assert launch_counts()["quantized_mlp_head"] == 0
