"""K1 and K2 on every movie dtype the Pallas kernels read, and the loader
that feeds them: int16 (negative samples included), uint8, int8, float16
and bfloat16 beside float32 and uint16.

- The plain twins (the wrappers on CPU tensors) against ``fused_movie_stats``
  and ``fused_v_projection`` in interpret mode, bfloat16 built from the same
  bits on both sides. Tolerances as tests/test_torch_noise_stats.py: mean
  rtol 1e-5 with atol 1e-5 x max|mean|, sigma rtol 1e-4; K2 1e-5 relative
  Frobenius (chip_smoke.py's bar for the kernel).
- Every chunk K1 and K2 receive is in ``kernels.KERNEL_DTYPES``: a
  card-resident movie of another dtype (float64, int32) is cast to float32
  by the loader, one chunk at a time; the dtypes K1 reads stay native.
- The loader's stream dtype and movie-cache dtype for host and
  card-resident sources of each dtype, the native reader on int16 files.
- A golden-sized int16 movie with negative samples through the JAX package
  and the port (numpy and tensor input), sketches injected and thresholds
  pinned as tests/test_torch_golden.py: each package's int16 run within
  1e-6 of its run on the float32 cast, the port within 1e-4 of the JAX
  package (see the test for why not 1e-5), equal ``pipeline_ranks``.
- ``compress --raw-dtype int16`` on a small raw file against the in-process
  run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import rel_fro, to_np

from localmd_tpu.ops.pallas_kernels import fused_movie_stats, fused_v_projection
from localmd_tpu_torch.dataset import NumpyArray, RawBinaryArray, TensorMovie, TiffArray
from localmd_tpu_torch.loader import PMDLoader
from localmd_tpu_torch.ops import kernels

NEW_DTYPES = ("int16", "uint8", "int8", "float16", "bfloat16")
SIGMA_TOL = dict(rtol=1e-4)


def assert_mean_close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(
        actual, desired, rtol=1e-5, atol=1e-5 * float(np.abs(desired).max())
    )


def _values(dtype, shape, rng):
    """(numpy array or bfloat16 bits, torch tensor, jax array) of the same
    values: int16 clip(40 x - 100) (negative samples), uint8 clip(8 x + 128),
    int8 clip(8 x), float16 and bfloat16 2.3 x + 1."""
    x = rng.standard_normal(shape)
    if dtype == "bfloat16":
        bits = (np.asarray(x * 2.3 + 1, np.float32).view(np.uint32) >> 16).astype(np.uint16)
        t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        j = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
        return bits, t, j
    scale, offset, lo, hi = {
        "int16": (40, -100, -32768, 32767), "uint8": (8, 128, 0, 255), "int8": (8, 0, -128, 127),
        "float16": (2.3, 1, -65504, 65504),
    }[dtype]
    arr = np.clip(x * scale + offset, lo, hi).astype(dtype)
    return arr, torch.from_numpy(arr), jnp.asarray(arr)


@pytest.mark.parametrize("dtype", NEW_DTYPES)
@pytest.mark.parametrize("t,p,nperseg", [(512, 700, 256), (300, 600, 300)])
def test_movie_stats_twin_matches_pallas(dtype, t, p, nperseg, rng):
    _, x, xj = _values(dtype, (t, p), rng)
    if dtype == "int16":
        assert int(x.min()) < 0
    m, s = kernels.movie_stats(x, 10_000, nperseg=nperseg)
    pm, ps = fused_movie_stats(xj, 10_000, nperseg=nperseg)
    assert_mean_close(to_np(m), np.asarray(pm))
    np.testing.assert_allclose(to_np(s), np.asarray(ps), **SIGMA_TOL)
    # the twin reads the values as their float32 cast, exactly
    m32, s32 = kernels.movie_stats(x.to(torch.float32), 10_000, nperseg=nperseg)
    assert torch.equal(m, m32) and torch.equal(s, s32)


@pytest.mark.parametrize("dtype", NEW_DTYPES)
@pytest.mark.parametrize("t,d,r", [(100, 700, 37), (256, 512, 128)])
def test_v_projection_twin_matches_pallas(dtype, t, d, r, rng):
    _, x, xj = _values(dtype, (t, d), rng)
    a = rng.standard_normal((d, r)).astype(np.float32) * 0.01
    c = rng.standard_normal(r).astype(np.float32)
    ours = to_np(kernels.v_projection(x, torch.from_numpy(a), torch.from_numpy(c)))
    ref = np.asarray(fused_v_projection(xj, jnp.asarray(a), jnp.asarray(c)))
    assert ours.shape == (r, t)
    assert rel_fro(ours, ref) <= 1e-5


def test_kernel_dtypes_are_public():
    """The seven dtypes K1 and K2 read are public; 32- and 64-bit integers
    and float64 are not among them (tests/test_torch_kernels_gpu.py holds
    the wrappers' refusal of them on the card)."""
    assert kernels.KERNEL_DTYPES == (
        torch.float32, torch.uint16, torch.int16, torch.uint8, torch.int8,
        torch.float16, torch.bfloat16)
    for dt in (torch.float64, torch.int32, torch.int64):
        assert dt not in kernels.KERNEL_DTYPES


# ---------------------------------------------------------------------------
# the repair: every chunk K1 and K2 receive is in a dtype they read
# ---------------------------------------------------------------------------

ALL_DTYPES = NEW_DTYPES + ("float64", "int32")


def _golden_like(rng, t=300, d1=40, d2=36, rank=3):
    spatial = rng.random((d1 * d2, rank))
    temporal = rng.standard_normal((rank, t)) * np.asarray([8.0, 6.0, 4.5])[:, None]
    return ((spatial @ temporal).T.reshape(t, d1, d2) + 0.3 * rng.standard_normal((t, d1, d2)))


def _as_dtype(x, dtype):
    """x in ``dtype`` as a CPU tensor, scaled to the type's range."""
    if dtype in ("int16", "int32"):
        return torch.from_numpy(np.clip(np.rint(x * 100 - 100), -32768, 32767).astype(dtype))
    if dtype == "uint8":
        return torch.from_numpy(np.clip(np.rint(x * 8 + 128), 0, 255).astype(np.uint8))
    if dtype == "int8":
        return torch.from_numpy(np.clip(np.rint(x * 8), -128, 127).astype(np.int8))
    return torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ALL_DTYPES)
def test_kernels_receive_only_kernel_dtypes(dtype, monkeypatch):
    """``localmd_decomposition`` on a card-resident (here CPU) TensorMovie,
    on the golden 40 x 36 grid (a snapped tail, so K2 runs): K1 and K2 see
    the movie's own dtype where they read it and float32 where they do not.
    Before the repair a float64 or int32 movie reached them as it was,
    which on the card raises in K1's wrapper."""
    from localmd_tpu_torch import localmd_decomposition

    seen = []
    ms, vp = kernels.movie_stats, kernels.v_projection
    monkeypatch.setattr(kernels, "movie_stats",
                        lambda x, *a, **k: seen.append(("K1", x.dtype)) or ms(x, *a, **k))
    monkeypatch.setattr(kernels, "v_projection",
                        lambda x, *a, **k: seen.append(("K2", x.dtype)) or vp(x, *a, **k))
    movie = _as_dtype(_golden_like(np.random.default_rng(5)), dtype)
    pmd = localmd_decomposition(TensorMovie(movie), (16, 16), frame_range=300, max_components=4,
                                background_rank=2, temporal_avg_factor=4, seed=0, device="cpu")
    assert {k for k, _ in seen} == {"K1", "K2"}
    want = movie.dtype if movie.dtype in kernels.KERNEL_DTYPES else torch.float32
    assert {dt for _, dt in seen} == {want}
    assert pmd.pipeline_cache["stream_dtype"] == str(want).removeprefix("torch.")


@pytest.mark.parametrize("dtype", ALL_DTYPES)
def test_card_resident_movie_matches_its_float32_copy(dtype):
    """The same values as a float32 movie give the same factorization: the
    native dtypes convert exactly, and the loader's cast of the others is
    the float32 movie's values."""
    from localmd_tpu_torch import localmd_decomposition

    movie = _as_dtype(_golden_like(np.random.default_rng(6)), dtype)
    runs = [localmd_decomposition(TensorMovie(m), (16, 16), frame_range=300, max_components=4,
                                  background_rank=2, temporal_avg_factor=4, seed=0, device="cpu")
            for m in (movie, movie.to(torch.float32))]
    assert runs[0].pipeline_ranks == runs[1].pipeline_ranks
    assert rel_fro(runs[0][:, :, :], runs[1][:, :, :]) <= 1e-5


# ---------------------------------------------------------------------------
# the loader: stream dtype, cache dtype, the native reader
# ---------------------------------------------------------------------------

HOST_DTYPES = [("int16", "int16"), ("int8", "int8"), ("uint8", "uint8"), ("uint16", "uint16"),
               ("float16", "float16"), ("float32", "float32"), ("float64", "float32"),
               ("int32", "float32"), ("uint32", "float32"), ("int64", "float32")]


def _small_movie(dtype, rng, t=300, d1=12, d2=10):
    x = rng.standard_normal((t, d1, d2)) * 20
    if np.dtype(dtype).kind == "u":
        x = x + 100
    return np.clip(np.rint(x) if np.dtype(dtype).kind in "iu" else x,
                   *((0, 255) if dtype == "uint8" else (-128, 127) if dtype == "int8"
                     else (-1e9, 1e9))).astype(dtype)


@pytest.mark.parametrize("dtype,want", HOST_DTYPES)
def test_host_source_streams_and_caches_native(dtype, want, rng):
    """A host source streams, and the movie cache holds, its stored dtype
    wherever K1 reads it, else float32; the cached frames are the movie's
    values and the mean is the float64 mean's float32."""
    movie = _small_movie(dtype, rng)
    loader = PMDLoader(NumpyArray(movie), device="cpu", background_rank=1, cache_movie=True, seed=0)
    assert loader.stream_dtype == getattr(torch, want)
    assert loader._cache is not None and loader._cache.dtype == getattr(torch, want)
    np.testing.assert_array_equal(to_np(loader._cache), movie.astype(want))
    np.testing.assert_allclose(to_np(loader.mean_img), movie.astype(np.float64).mean(0),
                               rtol=1e-5, atol=1e-5)


def test_uint32_above_2_31_is_not_wrapped(rng):
    """The JAX package's ``_cast_f32`` takes uint32 through int32, so values
    at or above 2^31 wrap negative; the port streams uint32 as float32."""
    movie = (rng.integers(0, 1000, (300, 8, 8)) + 3_000_000_000).astype(np.uint32)
    loader = PMDLoader(NumpyArray(movie), device="cpu", background_rank=1, seed=0)
    assert loader.stream_dtype == torch.float32
    np.testing.assert_allclose(to_np(loader.mean_img), movie.astype(np.float64).mean(0),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ALL_DTYPES + ("float32", "uint16"))
def test_card_resident_stream_dtype_and_chunks(dtype):
    """A card-resident movie: no cache; a contiguous range in a dtype K1
    reads is a view of the movie, any other is cast to float32 per chunk."""
    base = _golden_like(np.random.default_rng(7), t=260, d1=12, d2=10)
    if dtype == "uint16":
        movie = torch.from_numpy(np.clip(np.rint(base * 40 + 1000), 0, 65535).astype(np.uint16))
    else:
        movie = _as_dtype(base, dtype)
    loader = PMDLoader(TensorMovie(movie), device="cpu", background_rank=1, cache_movie=True, seed=0)
    want = movie.dtype if movie.dtype in kernels.KERNEL_DTYPES else torch.float32
    assert loader.stream_dtype == want and loader._cache is None
    chunk = loader._load_raw(slice(10, 50))
    gathered = loader._load_raw([3, 9, 4])
    assert chunk.dtype == want and gathered.dtype == want
    assert torch.equal(chunk.to(torch.float32), movie[10:50].to(torch.float32))
    assert torch.equal(gathered.to(torch.float32), movie[[3, 9, 4]].to(torch.float32))
    if want == movie.dtype:
        assert chunk.data_ptr() == movie[10:50].data_ptr()


def test_host_bfloat16_tensor_reads_into_a_bfloat16_buffer():
    """A bfloat16 tensor on the host has no numpy form: the loader copies it
    tensor to tensor into the (pinned, on the card) stream buffer."""
    movie = torch.randn(40, 6, 5).to(torch.bfloat16)
    loader = PMDLoader.__new__(PMDLoader)
    loader.dataset, loader.shape = TensorMovie(movie), tuple(movie.shape)
    out = torch.empty((4, 6, 5), dtype=torch.bfloat16)
    loader._read_into([7, 2, 30, 8], out)
    assert torch.equal(out, movie[[7, 2, 30, 8]])
    out = torch.empty((5, 6, 5), dtype=torch.bfloat16)
    loader._read_into(slice(10, 15), out)
    assert torch.equal(out, movie[10:15])


@pytest.mark.parametrize("kind", ["raw", "tiff"])
@pytest.mark.parametrize("dtype", ["int16", "int8", "uint8"])
def test_file_sources_stream_native_through_the_native_reader(kind, dtype, rng, tmp_path,
                                                              monkeypatch):
    """An int16, int8 or uint8 raw file or TIFF streams in its own dtype, so
    ``read_into`` finds the buffer in the file's dtype and reads through the
    native reader (where it is built), and the cache holds that dtype."""
    from localmd_tpu_torch.io import native
    from localmd_tpu_torch.io.tiff import TiffReader, write_tiff

    movie = _small_movie(dtype, rng)
    if kind == "raw":
        path = str(tmp_path / "m.raw")
        movie.tofile(path)
        src = RawBinaryArray(path, movie.shape, dtype)
    else:
        path = str(tmp_path / "m.tif")
        write_tiff(path, movie)
        src = TiffArray(path)
    native_reads = []
    read_scatter = native.FastReader.read_scatter
    try_native = TiffReader._try_native_read

    def spy_scatter(self, *args):
        native_reads.append(True)
        return read_scatter(self, *args)

    def spy_tiff(self, *args):
        ok = try_native(self, *args)
        native_reads.append(ok)
        return ok

    monkeypatch.setattr(native.FastReader, "read_scatter", spy_scatter)
    monkeypatch.setattr(TiffReader, "_try_native_read", spy_tiff)
    loader = PMDLoader(src, device="cpu", background_rank=1, cache_movie=True, seed=0)
    assert loader.stream_dtype == getattr(torch, dtype)
    assert loader._cache.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(to_np(loader._cache), movie)
    if native.native_available():
        assert any(native_reads), "the native reader was not used"


# ---------------------------------------------------------------------------
# the slice as a whole: a golden-sized int16 movie, JAX against the port
# ---------------------------------------------------------------------------

def _int16_golden_movie():
    """tests/test_torch_golden.py's construction (seed 55, 500 x 40 x 36,
    rank 4) scaled to int16 around a negative offset: 100 x - 100."""
    rng = np.random.default_rng(55)
    T, d1, d2, R = 500, 40, 36, 4
    spatial = rng.random((d1 * d2, R)).astype(np.float32)
    temporal = rng.standard_normal((R, T)).astype(np.float32)
    temporal *= np.asarray([8.0, 6.0, 4.5, 3.0], np.float32)[:, None]
    movie = (spatial @ temporal).T.reshape(T, d1, d2)
    movie += 1e-4 * rng.standard_normal(movie.shape).astype(np.float32)
    return np.clip(np.rint(movie * 100 - 100), -32768, 32767).astype(np.int16), T, R


def _jax_sketch(shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1234), shape))


GOLDEN_SETTINGS = dict(background_rank=2, temporal_avg_factor=4, compute_normalizer=True,
                       welch_compat="reference", seed=0, final_rank_tol=0.0)


@pytest.fixture(scope="module")
def int16_runs():
    """The int16 movie and its float32 cast through the JAX package, and
    through the port as numpy, as a tensor and (the cast) as numpy."""
    import localmd_tpu.pipeline as jax_pipeline
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu.ops.linalg import sketch_override as jax_sketch_override
    from localmd_tpu_torch.utils.random import sketch_override

    movie, T, R = _int16_golden_movie()
    cast = movie.astype(np.float32)
    mp = pytest.MonkeyPatch()
    ref, ours = {}, {}
    try:
        mp.setattr(jax_pipeline, "threshold_heuristic", lambda *a, **k: (1e9, 1e9))
        mp.setattr(port_pipeline, "threshold_heuristic", lambda *a, **k: (1e9, 1e9))
        with jax_sketch_override(lambda shape: jax.random.normal(jax.random.PRNGKey(1234), shape)):
            for name, src in (("int16", movie), ("float32", cast)):
                ref[name] = jax_pipeline.localmd_decomposition(
                    src, (16, 16), frame_range=T, max_components=R, **GOLDEN_SETTINGS)
        with sketch_override(_jax_sketch):
            for name, src in (("numpy", movie), ("tensor", torch.from_numpy(movie)),
                              ("float32", cast)):
                ours[name] = port_pipeline.localmd_decomposition(
                    src, (16, 16), frame_range=T, max_components=R, device="cpu",
                    **GOLDEN_SETTINGS)
    finally:
        mp.undo()
    return movie, ref, ours


@pytest.mark.parametrize("source", ["numpy", "tensor"])
def test_int16_movie_matches_the_jax_pipeline(source, int16_runs):
    """Each package reads the int16 movie as its float32 cast (<= 1e-6: both
    convert exactly), and the port matches the JAX package on it with equal
    ``pipeline_ranks``. Across the packages the bar is 1e-4, as in
    tests/test_torch_pipeline.py: the int16 rounding is white noise of 3e-4
    of the signal, in which the 4-component block fits differ by 5.8e-5
    between the packages on the float32 cast too (1e-5 holds on the golden
    movie's 1e-4 noise, tests/test_torch_golden.py)."""
    movie, ref, ours = int16_runs
    pmd = ours[source]
    assert int(movie.min()) < 0
    assert pmd.pipeline_cache["stream_dtype"] == "int16"
    assert rel_fro(pmd[:, :, :], ours["float32"][:, :, :]) <= 1e-6
    assert rel_fro(ref["int16"][:, :, :], ref["float32"][:, :, :]) <= 1e-6
    assert pmd.pipeline_ranks == ref["int16"].pipeline_ranks
    assert rel_fro(pmd[:, :, :], ref["int16"][:, :, :]) <= 1e-4
    np.testing.assert_allclose(pmd.var_img, ref["int16"].var_img, rtol=1e-4)
    assert_mean_close(pmd.mean_img, ref["int16"].mean_img)


def test_cli_compress_raw_int16(tmp_path, capsys):
    """``compress --raw-shape T d1 d2 --raw-dtype int16`` on a raw file with
    negative samples: the in-process run's rank and factors (1e-6), streamed
    as int16."""
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch.cli import main as cli_main
    from localmd_tpu_torch.pmd_array import PMDArray
    from localmd_tpu_torch.utils.random import sketch_override

    def sketch(shape):
        return np.random.default_rng(1234).standard_normal(shape).astype(np.float32)

    movie = _as_dtype(_golden_like(np.random.default_rng(8), t=300, d1=24, d2=24), "int16").numpy()
    assert movie.min() < 0
    raw = str(tmp_path / "m.raw")
    movie.tofile(raw)
    npz = str(tmp_path / "out.npz")
    args = ["--blocks", "12", "12", "--frame-range", "300", "--max-components", "4",
            "--background-rank", "1", "--temporal-avg-factor", "4", "--seed", "0"]
    with sketch_override(sketch):
        cli_main(["compress", raw, npz, "--raw-shape", "300", "24", "24", "--raw-dtype", "int16",
                  *args, "--device", "cpu"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        ref = port_pipeline.localmd_decomposition(
            movie, (12, 12), frame_range=300, max_components=4, background_rank=1,
            temporal_avg_factor=4, seed=0, device="cpu")
    assert out["shape"] == [300, 24, 24] and out["rank"] == ref.rank
    assert out["cache"]["stream_dtype"] == "int16"
    got = PMDArray.from_npz(npz, device="cpu")
    assert rel_fro(got[:, :, :], ref[:, :, :]) <= 1e-6
