"""Host-side layouts and tile geometry of the Hopper GEMM kernels behind K1
(``csrc/gl_fused.cu``) and K3 (``csrc/griffin_lim.cu``), on the CPU.

The kernels read their DFT matrices with the bins interleaved per 64-bin
tile (re columns, then im columns) and, for the forward products,
transposed.  Products through those layouts must equal the products through
the separate matrices the plain versions use.  bf16 x bf16 products are
exact in float64, so each matrix product is summed exactly (``math.fsum``)
and rounded to float32: the summation order then cannot show, and the two
sides must agree bit for bit."""

import math

import numpy as np
import pytest
import torch

from tacotron_tpu_torch.dsp import chip as tchip
from tacotron_tpu_torch.ops.kernels import gl_fused, griffin_lim, layouts


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16, as float64."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).double().numpy()


def product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b with every sum exact, rounded to float32."""
    bt = np.ascontiguousarray(b.T)
    out = np.empty((a.shape[0], b.shape[1]))
    for i, row in enumerate(a):
        out[i] = [math.fsum(terms) for terms in row * bt]
    return out.astype(np.float32)


def test_interleave_round_trip():
    rng = np.random.default_rng(0)
    re = rng.standard_normal((3, 5, 128)).astype(np.float32)
    im = rng.standard_normal((3, 5, 128)).astype(np.float32)
    x = layouts.interleave_bins(re, im)
    assert x.shape == (3, 5, 256)
    np.testing.assert_array_equal(x[..., :64], re[..., :64])
    np.testing.assert_array_equal(x[..., 64:128], im[..., :64])
    np.testing.assert_array_equal(x[..., 128:192], re[..., 64:])
    for back, want in zip(layouts.deinterleave_bins(x), (re, im)):
        np.testing.assert_array_equal(back, want)
    for back, want in zip(layouts.deinterleave_bins(torch.from_numpy(x)),
                          (re, im)):
        torch.testing.assert_close(back, torch.from_numpy(want), rtol=0,
                                   atol=0)
    with pytest.raises(ValueError):
        layouts.interleave_bins(re[..., :96], im[..., :96])


@pytest.mark.parametrize("n_fft", [2048, 256, 254])
def test_k1_interleaved_matrices_give_the_same_products(n_fft):
    """Forward: u @ [e_r | e_i] interleaved, read back per tile, is u @ e_r
    and u @ e_i; the transposed copy is the forward GEMM's K-major B.
    Inverse: interleaved spectra @ the interleaved matrix^T is
    x_r @ e_r^T + x_i @ e_i^T, the sum of the plain version's two
    products.  (254 is no K1 geometry; the layout holds there all the
    same.)"""
    e_r, e_i, o_r, o_i = (bf16(m) for m in gl_fused.fwd_matrices(n_fft)[:4])
    we_t, wo_t, we, wo = (bf16(m) for m in gl_fused.kernel_matrices(n_fft))
    M = n_fft // 2
    assert we.shape == (M, 2 * e_r.shape[1])
    assert wo.shape == (M, 2 * o_r.shape[1])
    np.testing.assert_array_equal(we_t, we.T)
    np.testing.assert_array_equal(wo_t, wo.T)
    rng = np.random.default_rng(1)
    rows = 5
    for w, w_t, mr, mi in ((we, we_t, e_r, e_i), (wo, wo_t, o_r, o_i)):
        a = bf16(rng.standard_normal((rows, M)))
        re, im = layouts.deinterleave_bins(product(a, w_t.T))
        np.testing.assert_array_equal(re, product(a, mr))
        np.testing.assert_array_equal(im, product(a, mi))
        xr = bf16(rng.standard_normal((rows, mr.shape[1])))
        xi = bf16(rng.standard_normal((rows, mr.shape[1])))
        x = layouts.interleave_bins(xr, xi)
        np.testing.assert_array_equal(
            product(x, w.T), product(np.concatenate([xr, xi], 1),
                                     np.concatenate([mr.T, mi.T], 0)))


@pytest.mark.parametrize("n_fft", [2048, 256, 254])
def test_k3_interleaved_and_stacked_matrices_give_the_same_products(n_fft):
    """Forward: bf16 frames (zero-padded to Np) @ the interleaved matrix is
    frames @ DFT_RE and frames @ DFT_IM; inverse: the interleaved spectra @
    the stacked inverse matrices is sre @ IDFT_RE + sim @ IDFT_IM."""
    dre, dim, ire, iim = (bf16(m) for m in tchip.dft_matrices(n_fft))
    fwd_t, inv_t = (bf16(m) for m in griffin_lim.kernel_matrices(n_fft))
    F = n_fft // 2 + 1
    Fp = layouts.round_up(F, griffin_lim.TILE)
    Np = layouts.round_up(n_fft, griffin_lim.TILE)
    assert fwd_t.shape == (2 * Fp, Np) and inv_t.shape == (Np, 2 * Fp)
    rng = np.random.default_rng(2)
    rows = 5
    frames = bf16(rng.standard_normal((rows, n_fft)))
    padded = np.pad(frames, ((0, 0), (0, Np - n_fft)))
    re, im = layouts.deinterleave_bins(product(padded, fwd_t.T))
    np.testing.assert_array_equal(re[:, :F], product(frames, dre))
    np.testing.assert_array_equal(im[:, :F], product(frames, dim))
    assert not re[:, F:].any() and not im[:, F:].any()

    sre = bf16(rng.standard_normal((rows, F)))
    sim = bf16(rng.standard_normal((rows, F)))
    spec = layouts.interleave_bins(np.pad(sre, ((0, 0), (0, Fp - F))),
                                   np.pad(sim, ((0, 0), (0, Fp - F))))
    got = product(spec, inv_t.T)
    np.testing.assert_array_equal(
        got[:, :n_fft], product(np.concatenate([sre, sim], 1),
                                np.concatenate([ire, iim], 0)))
    assert not got[:, n_fft:].any()


@pytest.mark.parametrize("n_fft", [2048, 256])
def test_k1_padding_geometry(n_fft):
    """What K1's GEMMs take for granted (``csrc/gl_fused.cu``): the bins pad
    to whole 64-bin tiles (NE 1025 -> 576 even bins at n_fft 2048; at the
    small geometry NE 65 -> 128, NO 64), every K loop (M forward; 2 NE and
    2 NO inverse) is a whole number of 64-deep stages, the inverse's 64
    output columns tile M, and every TMA row stride (u/v, spectra,
    matrices, bf16) is a multiple of 16 bytes.  Frame rows need no padding:
    TMA fills rows past the edge with zeros."""
    M = n_fft // 2
    we_t, wo_t, we, wo = gl_fused.kernel_matrices(n_fft)
    ne, no = we.shape[1] // 2, wo.shape[1] // 2
    assert (ne, no) == {2048: (576, 512), 256: (128, 64)}[n_fft]
    assert we_t.shape == (2 * ne, M) and wo_t.shape == (2 * no, M)
    for depth in (M, 2 * ne, 2 * no):
        assert depth % layouts.DEPTH_TILE == 0
        assert depth * 2 % 16 == 0
    assert ne % layouts.BIN_TILE == 0 and no % layouts.BIN_TILE == 0
    assert M % 64 == 0
    e_r, e_i, o_r, o_i, we_w, wo_w = gl_fused.fwd_matrices(n_fft)
    # the padded bins carry zero matrix columns and zero Hermitian weight
    for m, w, n in ((e_r, we_w, M // 2 + 1), (o_r, wo_w, M // 2)):
        assert not m[:, n:].any() and not w[n:].any()


@pytest.mark.parametrize("n_fft,rows", [(2048, 800), (2048, 1), (256, 70),
                                        (254, 33)])
def test_k3_padding_geometry(n_fft, rows):
    """What K3's kernels take for granted (``csrc/griffin_lim.cu``): bins
    pad from F to Fp and the time axis from n_fft to Np, both multiples of
    64, with zero matrix entries in the padding; the bf16 frames
    [rows, Np] and spectra [rows, 2 Fp] have 16-byte row strides; the
    forward K loop (Np) and the inverse one (2 Fp) are whole stages.  The
    plain version on the padded, interleaved layout equals the plain
    version (any number of rows: TMA fills rows past the edge with
    zeros)."""
    F = n_fft // 2 + 1
    fwd_t, inv_t = griffin_lim.kernel_matrices(n_fft)
    Fp, Np = fwd_t.shape[0] // 2, fwd_t.shape[1]
    assert (Fp, Np) == (layouts.round_up(F, 64), layouts.round_up(n_fft, 64))
    assert inv_t.shape == (Np, 2 * Fp)
    for depth in (Np, 2 * Fp):
        assert depth % layouts.DEPTH_TILE == 0 and depth * 2 % 16 == 0
    re_t, im_t = layouts.deinterleave_bins(fwd_t.T)
    assert not re_t[:, F:].any() and not im_t[:, F:].any()
    assert not re_t[n_fft:].any() and not im_t[n_fft:].any()
    assert not inv_t[n_fft:].any()

    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.standard_normal((rows, n_fft)).astype(
        np.float32))
    mag = torch.from_numpy(rng.random((rows, F)).astype(np.float32))
    want = griffin_lim.spectral_step_reference(frames, mag, n_fft)
    fb = torch.nn.functional.pad(frames, (0, Np - n_fft)).to(
        torch.bfloat16).float()
    x = fb @ torch.from_numpy(fwd_t).to(torch.bfloat16).float().T
    re, im = layouts.deinterleave_bins(x)
    mag_p = torch.nn.functional.pad(mag, (0, Fp - F))
    inv_amp = torch.rsqrt(torch.clamp(re * re + im * im, min=1e-16))
    spec = torch.from_numpy(layouts.interleave_bins(
        (mag_p * re * inv_amp).numpy(), (mag_p * im * inv_amp).numpy()))
    got = spec.to(torch.bfloat16).float() @ torch.from_numpy(inv_t).to(
        torch.bfloat16).float().T
    assert got.shape == (rows, Np)
    # the same roundings; f32 sums in another order can flip isolated bf16
    # roundings of the spectra (the kernels' own tolerance on the card)
    assert float((got[:, :n_fft] - want).abs().max()) \
        <= 2e-3 * float(want.abs().max())


def test_tensor_map_errors_are_named():
    """A GEMM entry point reports a tensor map it could not encode as
    MAP_ERROR + the driver's CUresult; the wrappers name it as such."""
    from tacotron_tpu_torch.ops.kernels import _build

    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled.*1$"):
        _build.check(_build.MAP_ERROR + 1, "gl_dft_project")
    with pytest.raises(RuntimeError, match="launch of gl_ola_norm.*error 9"):
        _build.check(9, "gl_ola_norm")
    _build.check(0, "gl_ola_norm")
