"""The arithmetic of the 3xTF32 tensor-core kernels K1 and K2, emulated on
the CPU in plain torch and held against the JAX package.

Each operand splits as x = hi + lo, hi = x rounded to tf32 (10 mantissa
bits, to nearest with ties away from zero, by integer arithmetic:
``kernels.split_tf32``, the same rounding the kernels and the wrappers
use), lo = x - hi, of which the tensor core reads the top 10 mantissa bits
(``tf32_truncate``); K2's projector is read as it is, its hi the tensor
core's truncation of x and its lo = x - hi made beside it. A product is
lo*hi + hi*lo + hi*hi, in that
order, each k8 step's product added into an
fp32 accumulator (an m16n8k8 mma), a fresh accumulator per 32-deep slab
added into the running fp32 sum, as the kernels do. The emulation rounds an
mma's result to nearest; the card's tensor cores truncate it, which is why
the kernels keep their mma chains short (K2) or their partial sums small
(K1's offset removal).

Bars, as the card holds the kernels: K2 1e-5 relative Frobenius against
``fused_v_projection`` (interpret mode); K1 sigma 1e-4 max relative against
``get_mean_and_noise`` (nperseg 256) and ``get_mean_and_noise_ref_compat``
(nperseg = T). Inputs carry an offset (uint16 at 1000), where a single TF32
pass fails: the negative cases show it does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, to_np

from localmd_tpu.ops import noise as jnoise
from localmd_tpu.ops.pallas_kernels import fused_v_projection
from localmd_tpu_torch.ops import kernels

K2_TOL = 1e-5
SIGMA_TOL = 1e-4
H100_SMS = 132


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """The tf32 value a tensor core reads from a float32 register: the low
    13 mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _terms(a: torch.Tensor, b: torch.Tensor, passes: int, b_truncated: bool = False):
    """The products of one tensor-core step in the kernels' order, as
    (left, right) operand pairs; ``passes=1`` is a single TF32 pass.
    ``b_truncated``: b's hi is b truncated to tf32 (K2's projector)."""
    a_hi, a_lo = kernels.split_tf32(a)
    if b_truncated:
        b_hi = tf32_truncate(b)
        b_lo = b - b_hi
    else:
        b_hi, b_lo = kernels.split_tf32(b)
    a_lo, b_lo = tf32_truncate(a_lo), tf32_truncate(b_lo)
    if passes == 1:
        return [(a_hi, b_hi)]
    return [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]


def emulated_product(a: torch.Tensor, b: torch.Tensor, passes: int = 3, slab: int = 32,
                     b_truncated: bool = False) -> torch.Tensor:
    """(m, k) @ (k, n) as the kernels take it: per k8 step the products of
    ``_terms``, each summed exactly (float64) and added into an fp32 slab
    accumulator; each slab's sum added into the fp32 total."""
    terms = _terms(a, b, passes, b_truncated)
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for s0 in range(0, a.shape[1], slab):
        part = torch.zeros_like(total)
        for k0 in range(s0, min(s0 + slab, a.shape[1]), 8):
            for left, right in terms:
                step = left[:, k0:k0 + 8].double() @ right[k0:k0 + 8].double()
                part = (part.double() + step).float()
        total = total + part
    return total


def k2_emulated(raw: np.ndarray, a: np.ndarray, c: np.ndarray, passes: int = 3) -> np.ndarray:
    """K2: (raw @ A - c)^T with the pixel axis in the splits of K2's
    schedule on a 132-SM H100 (``vp_schedule``), each a work unit's slab
    sums from zero, added in order (the kernel's split-K and its
    fixed-order reduce)."""
    x = torch.from_numpy(raw.astype(np.float32))
    aa = torch.from_numpy(a)
    k_chunk = kernels.vp_schedule(x.shape[0], x.shape[1], aa.shape[1], H100_SMS).k_chunk
    out = torch.zeros(x.shape[0], aa.shape[1], dtype=torch.float32)
    for k0 in range(0, x.shape[1], k_chunk):
        out = out + emulated_product(x[:, k0:k0 + k_chunk], aa[k0:k0 + k_chunk], passes,
                                     b_truncated=True)
    return to_np((out - torch.from_numpy(c)[None, :]).T)


def k1_sigma_emulated(chunk: np.ndarray, nperseg: int, passes: int = 3,
                      offset: bool = True) -> np.ndarray:
    """K1's sigma of a (T, P) chunk: per segment the band DFT of x minus the
    segment's first sample (``offset=False``: of x itself) against the
    wrapper's own tf32 matrices, detrend through the column sums, |X|^2 over
    segments, the Nyquist bin halved."""
    w_hi, w_lo, cos1, sin1, scale = kernels._dft_constants(nperseg, torch.device("cpu"))
    w = torch.empty_like(w_hi)
    w[:, kernels.k8_order(w.shape[1])] = w_hi + w_lo        # back to sample order
    w = w[:, :nperseg].T                                     # (nperseg, 128): cos bins, sin bins
    cos_cols, sin_cols = torch.arange(64), torch.arange(64, 128)
    x = torch.from_numpy(chunk.astype(np.float32))
    t, p = x.shape
    step = nperseg - 128
    n_segs = (t - nperseg) // step + 1
    power = torch.zeros(p, 64, dtype=torch.float32)
    for s in range(n_segs):
        seg = x[s * step: s * step + nperseg]
        u = (seg - seg[0] if offset else seg).T.contiguous()   # (P, nperseg)
        acc = emulated_product(u, w, passes)
        m = u.sum(dim=1, keepdim=True) / nperseg
        re = acc[:, cos_cols] - cos1[None, :] * m
        im = acc[:, sin_cols] - sin1[None, :] * m
        power = power + (re * re + im * im)
    band = power * (scale / n_segs)
    k = torch.arange(65, 129)
    band = torch.where(2 * k >= nperseg, band * 0.5, band)
    return to_np(torch.sqrt(band.sum(dim=1) / 64))


def _offset_u16(rng, shape, noise):
    return np.clip(rng.standard_normal(shape) * noise + 1000.0, 0, 65535).astype(np.uint16)


def _jax_sigma(chunk: np.ndarray, nperseg: int) -> np.ndarray:
    t, p = chunk.shape
    movie = jnp.asarray(chunk.T.reshape(p, 1, t).astype(np.float32))
    if nperseg == t:
        _, sigma = jnoise.get_mean_and_noise_ref_compat(movie, t)
    else:
        _, sigma = jnoise.get_mean_and_noise(movie, t)
    return np.asarray(sigma).reshape(p)


def test_tf32_split_rounds_to_nearest_ties_away_and_is_exact_for_uint16(rng):
    x = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32)
    x[:4] = [1 + 2.0**-11, 1 + 3 * 2.0**-11, -(1 + 2.0**-11), 0.0]   # ties, and zero
    hi, lo = kernels.split_tf32(torch.from_numpy(x))
    m, e = np.frexp(x.astype(np.float64))
    scaled = np.ldexp(m, 11)
    expected = np.ldexp(np.sign(scaled) * np.floor(np.abs(scaled) + 0.5), e - 11)
    np.testing.assert_array_equal(to_np(hi), expected.astype(np.float32))
    assert not (to_np(hi).view(np.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(to_np(hi) + to_np(lo), x)           # lo = x - hi exactly
    seen = to_np(tf32_truncate(lo))                            # what the tensor core reads
    assert not (seen.view(np.int32) & 0x1FFF).any()
    resid = np.abs(x.astype(np.float64) - to_np(hi) - seen)
    assert (resid <= np.abs(x) * 2.0**-21).all()
    u = np.arange(65536, dtype=np.float32)
    hi, lo = kernels.split_tf32(torch.from_numpy(u))
    np.testing.assert_array_equal(to_np(hi) + to_np(tf32_truncate(lo)), u)


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_k2_3xtf32_matches_fused_v_projection(dtype, rng):
    t, d, r = 64, 8192, 48
    if dtype == "uint16":
        raw = _offset_u16(rng, (t, d), 40.0)
    else:
        raw = (rng.standard_normal((t, d)) * 2.3 + 1000.0).astype(np.float32)
    a = (rng.standard_normal((d, r)) * 0.01).astype(np.float32)
    c = rng.standard_normal(r).astype(np.float32)
    ref = np.asarray(fused_v_projection(jnp.asarray(raw), jnp.asarray(a), jnp.asarray(c)))
    assert rel_fro(k2_emulated(raw, a, c), ref) <= K2_TOL


def test_k2_single_tf32_pass_fails_the_bar_on_offset_uint16(rng):
    t, d, r = 64, 4096, 48
    raw = _offset_u16(rng, (t, d), 40.0)
    a = (rng.standard_normal((d, r)) * 0.01).astype(np.float32)
    c = rng.standard_normal(r).astype(np.float32)
    ref = np.asarray(fused_v_projection(jnp.asarray(raw), jnp.asarray(a), jnp.asarray(c)))
    assert rel_fro(k2_emulated(raw, a, c, passes=1), ref) > 10 * K2_TOL


@pytest.mark.parametrize("offset", [True, False])
@pytest.mark.parametrize("t,nperseg", [(1024, 256), (1024, 1024), (300, 300)])
def test_k1_3xtf32_sigma_matches_jax_on_offset_uint16(t, nperseg, offset, rng):
    """With the kernel's offset removal and without it: the split alone
    holds the bar."""
    chunk = _offset_u16(rng, (t, 48), 3.0)
    ref = _jax_sigma(chunk, nperseg)
    ours = k1_sigma_emulated(chunk, nperseg, offset=offset)
    assert np.abs(ours / ref - 1).max() <= SIGMA_TOL


@pytest.mark.parametrize("t,nperseg", [(1024, 256), (1024, 1024)])
def test_k1_single_tf32_pass_fails_the_bar_on_offset_uint16(t, nperseg, rng):
    """One TF32 pass over x as it is (no offset removal) misses the bar."""
    chunk = _offset_u16(rng, (t, 48), 3.0)
    ref = _jax_sigma(chunk, nperseg)
    ours = k1_sigma_emulated(chunk, nperseg, passes=1, offset=False)
    assert np.abs(ours / ref - 1).max() > 10 * SIGMA_TOL


@pytest.mark.parametrize("r", [37, 64, 168, 300, 336, 465, 1650, 2560])
def test_k2_r_tiles_fit_r(r):
    """K2's r' tile: one of ``VP_WIDTHS`` (at most 176 columns), near-equal
    tiles, under 16 padded columns a tile (under 8 past 160 columns) and no
    empty tile."""
    width, n_tiles = kernels._vp_tiles(r)
    assert width in kernels.VP_WIDTHS and width <= 176
    assert (n_tiles - 1) * width < r <= n_tiles * width
    assert n_tiles * width - r < (8 if width > 160 else 16) * n_tiles


@pytest.mark.parametrize("t,d,r", [
    (4000, 640 * 540, 1650),    # the widefield chunk
    (256, 1 << 20, 168),        # chip_smoke's 1024^2 uint16 blocks-40 call
    (2048, 512 * 512, 336),     # the main path's f32 call
    (64, 640 * 540, 1650),      # a small t: one t tile
    (129, 20000, 177),
])
def test_k2_schedule_covers_every_pixel_once_and_fills_the_card(t, d, r):
    """K2's schedule as a pure function of the shapes and the SM count:
    the splits partition the pixels, no unit's fp32 sum spans more than
    ``_VP_MAX_K_CHUNK`` pixels, and there are work units for a persistent
    CTA on every SM."""
    sched = kernels.vp_schedule(t, d, r, H100_SMS)
    assert (sched.bn, sched.n_tiles) == kernels._vp_tiles(r)
    assert sched.t_tiles == -(-t // 128)
    assert sched.k_chunk % 32 == 0 and 256 <= sched.k_chunk <= kernels._VP_MAX_K_CHUNK
    owner = np.zeros(d, np.int64)
    for split in range(sched.splits):
        owner[split * sched.k_chunk:(split + 1) * sched.k_chunk] += 1
    assert (owner == 1).all() and (sched.splits - 1) * sched.k_chunk < d
    assert sched.units == sched.splits * sched.n_tiles * sched.t_tiles
    assert sched.units >= H100_SMS and sched.ctas == H100_SMS


def test_k8_order_is_the_fragment_order():
    """Position t of each 8 holds sample 2t and position t + 4 sample
    2t + 1 (csrc/tf32_common.cuh, the fragment order)."""
    order = kernels.k8_order(16).tolist()
    assert order == [0, 2, 4, 6, 1, 3, 5, 7, 8, 10, 12, 14, 9, 11, 13, 15]
