"""The four CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``; each test skips (in a fixture, not at import) unless
``torch.cuda.is_available()``. Run on a machine with the card:
``python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py``
(the shared conftest imports jax). Tolerances:
K1 mean max|d|/max|ref| 1e-5, sigma rtol 1e-4; K2 and K3 1e-5 relative
Frobenius; K4 eigenvalues 1e-5 * |lambda_max| of the plain twin's (and of
float64 cuSOLVER),
``V diag(lambda) V^T`` 1e-5 relative Frobenius of the input, and
``max|V^T V - I|`` 1e-5."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_fro(a, b):
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


@pytest.mark.parametrize("dtype,t,p,nperseg,noise", [
    ("float32", 1024, 5000, 256, True),
    ("uint16", 1024, 4097, 256, True),
    ("float32", 500, 700, 500, True),
    ("float32", 300, 64, 256, False),
])
def test_movie_stats_matches_plain(cuda, dtype, t, p, nperseg, noise):
    from localmd_tpu_torch.ops import kernels

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(t, p, generator=g, device=cuda) * 40 + 1000
    x = x.to(getattr(torch, dtype))
    m_k, s_k = kernels.movie_stats(x, t, compute_noise=noise, nperseg=nperseg)
    m_p, s_p = kernels.movie_stats_plain(x, t, compute_noise=noise, nperseg=nperseg)
    assert float((m_k - m_p).abs().max() / m_p.abs().max()) <= 1e-5
    if noise:
        torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=0)
    else:
        assert bool((s_k == 0).all())


@pytest.mark.parametrize("dtype,t,nperseg", [("uint16", 1024, 256), ("uint16", 1024, 1024),
                                             ("float32", 300, 300)])
def test_movie_stats_offset_small_noise_matches_plain(cuda, dtype, t, nperseg):
    """clip(3 N(0, 1) + 1000): the input on which one TF32 pass misses the
    sigma bar; the 3xTF32 kernel holds it (nperseg 256 and reference mode)."""
    from localmd_tpu_torch.ops import kernels

    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(t, 8192, generator=g, device=cuda) * 3 + 1000).clamp(0, 65535)
    x = x.to(getattr(torch, dtype))
    m_k, s_k = kernels.movie_stats(x, t, nperseg=nperseg)
    m_p, s_p = kernels.movie_stats_plain(x, t, nperseg=nperseg)
    assert float((m_k - m_p).abs().max() / m_p.abs().max()) <= 1e-5
    torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=0)


@pytest.mark.parametrize("dtype,t,d,r", [
    ("uint16", 300, 20000, 77), ("float32", 64, 1024, 2560),
    ("uint16", 256, 1 << 20, 168),      # the 1024^2 uint16 cell's chunk
    ("float32", 500, 65536, 465),       # the voltage cell's r'
    ("uint16", 4000, 640 * 540, 1650),  # the widefield cell's chunk: clusters of 4, 94 splits
    ("uint16", 512, 256, 200),          # one split: no split-K
    ("uint16", 129, 20000, 1), ("uint16", 129, 20000, 176), ("uint16", 129, 20000, 177),
])
def test_v_projection_matches_plain(cuda, dtype, t, d, r):
    from localmd_tpu_torch.ops import kernels

    g = torch.Generator(device=cuda).manual_seed(1)
    raw = (torch.randn(t, d, generator=g, device=cuda) * 40 + 1000).to(getattr(torch, dtype))
    a = torch.randn(d, r, generator=g, device=cuda) * 0.01
    c = torch.randn(r, generator=g, device=cuda)
    before = kernels.v_projection.launches
    out = kernels.v_projection(raw, a, c)
    assert kernels.v_projection.launches == before + 1
    assert _rel_fro(out, kernels.v_projection_plain(raw, a, c)) <= 1e-5
    # the same inputs give the same bits: no atomics, a fixed order of sums
    assert torch.equal(kernels.v_projection(raw, a, c), out)
    # a projector prepared once serves every chunk
    prepared = kernels.prepare_projector(a)
    assert torch.equal(kernels.v_projection(raw, a, c, prepared), out)
    if (t, d) == (512, 256):
        n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert kernels.vp_schedule(t, d, r, n_sm).splits == 1


@pytest.mark.parametrize("d1,d2,b,s,f", [
    (128, 96, 32, 20, 130), (60, 52, 15, 5, 7),
    # S from 1 to 40 (16-byte and 4-byte panel rows), f off the 64-frame tile
    (60, 52, 20, 1, 64), (60, 52, 20, 3, 40), (60, 52, 20, 8, 130), (60, 52, 20, 33, 70),
    (60, 52, 20, 40, 129),
    # three blocks a dimension at the snapped tail; odd blocks; 60 = 7.5 tiles
    (52, 52, 20, 20, 130), (60, 52, 15, 12, 96),
])
def test_block_reconstruct_matches_plain(cuda, d1, d2, b, s, f):
    from localmd_tpu_torch.ops import kernels
    from localmd_tpu_torch.ops.tiling import BlockGrid

    grid = BlockGrid(d1, d2, (b, b))
    g = torch.Generator(device=cuda).manual_seed(2)
    panels = torch.randn(grid.n_blocks, b * b, s, generator=g, device=cuda)
    temporal = torch.randn(grid.n_blocks, s, f, generator=g, device=cuda)
    cosets = [ids for ids, _ in grid.cosets()]
    args = (panels, temporal, grid.starts, cosets, (d1, d2), (b, b))
    before = kernels.block_reconstruct.launches
    out = kernels.block_reconstruct(*args)
    assert kernels.block_reconstruct.launches == before + 1
    assert _rel_fro(out, kernels.block_reconstruct_plain(*args)) <= 1e-5
    # a plan made once serves every call, with the same sums
    plan = kernels.prepare_reconstruct(grid.starts, cosets, (d1, d2), (b, b), cuda)
    assert torch.equal(kernels.block_reconstruct(*args, plan), out)


@pytest.mark.parametrize("n,k", [(256, 30), (131, 11), (1, 25), (64, 64), (3, 1)])
def test_jacobi_eigh_matches_plain(cuda, n, k):
    from localmd_tpu_torch.ops import kernels, linalg

    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn(n, k, k + 3, generator=g, device=cuda)
    sym = (a @ a.transpose(1, 2)).contiguous()
    before = kernels.jacobi_eigh.launches
    vals, vecs = kernels.jacobi_eigh(sym)
    vals_p, _ = linalg.jacobi_eigh_plain(sym)
    assert kernels.jacobi_eigh.launches == before + 1
    lam = float(vals_p.abs().max())
    assert float((vals - vals_p).abs().max()) <= 1e-5 * lam
    assert bool((vals[:, 1:] <= vals[:, :-1]).all())
    v64 = vecs.double()
    recon = (v64 * vals.double()[:, None, :]) @ v64.transpose(1, 2)
    assert _rel_fro(recon, sym) <= 1e-5
    eye = torch.eye(k, device=cuda, dtype=torch.float64)
    assert float((v64.transpose(1, 2) @ v64 - eye).abs().max()) <= 1e-5
    # eigh_descending sends every small eigh on the card to K4
    linalg.eigh_descending(sym)
    assert kernels.jacobi_eigh.launches == before + 2


@pytest.mark.parametrize("kind", ["random_psd", "rank_deficient", "repeated", "diagonal"])
@pytest.mark.parametrize("k", [11, 20, 25, 30, 33, 64])
def test_jacobi_eigh_spectra_match_plain(cuda, k, kind):
    """The four spectra of chip_smoke.k4_matrices on both kernels (four
    warps a matrix for k <= 32, the CTA kernel above), 37 matrices a call,
    held to the plain twin and to float64 cuSOLVER."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import k4_matrices
    from localmd_tpu_torch.ops import kernels, linalg

    g = torch.Generator(device=cuda).manual_seed(5)
    sym = k4_matrices(kind, 37, k, g)
    before = kernels.jacobi_eigh.launches
    vals, vecs = kernels.jacobi_eigh(sym)
    assert kernels.jacobi_eigh.launches == before + 1
    vals_p, _ = linalg.jacobi_eigh_plain(sym)
    vals_64 = torch.linalg.eigvalsh(sym.double()).flip(-1)
    lam = float(vals_64.abs().max())
    assert float((vals - vals_p).abs().max()) <= 1e-5 * lam
    assert float((vals.double() - vals_64).abs().max()) <= 1e-5 * lam
    v64 = vecs.double()
    recon = (v64 * vals.double()[:, None, :]) @ v64.transpose(1, 2)
    assert _rel_fro(recon, sym) <= 1e-5
    eye = torch.eye(k, device=cuda, dtype=torch.float64)
    assert float((v64.transpose(1, 2) @ v64 - eye).abs().max()) <= 1e-5


def _smooth_movie(t, d1, d2, rank=4, seed=3, noise=1e-4):
    """Smooth low-rank movie (numpy only: the card's machine has no jax)."""
    rng = np.random.default_rng(seed)
    spatial = rng.random((d1, d2, rank))
    for _ in range(4):
        spatial = 0.2 * (spatial + np.roll(spatial, 1, 0) + np.roll(spatial, -1, 0)
                         + np.roll(spatial, 1, 1) + np.roll(spatial, -1, 1))
    temporal = rng.random((rank, t))
    for _ in range(3):
        temporal = 0.5 * temporal + 0.25 * (np.roll(temporal, 1, 1) + np.roll(temporal, -1, 1))
    movie = (spatial.reshape(d1 * d2, rank) @ temporal).T.reshape(t, d1, d2)
    return (movie + noise * rng.standard_normal(movie.shape)).astype(np.float32)


@pytest.mark.parametrize("case", ["order_c", "uint16_numpy", "tail_1100", "multi_window"])
def test_pipeline_on_card_matches_cpu(cuda, case, monkeypatch):
    """The whole port on the card (all four kernels, the cuSOLVER/cuBLAS
    paths, numpy sources crossing to the device chunk by chunk) against the
    port on the CPU with the same injected draws: reconstruction 1e-4
    relative Frobenius, std image rtol 1e-4, equal final rank."""
    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch.utils.random import sketch_override

    t, order, frame_range = (1100, "F", 500) if case == "tail_1100" else (600, "F", 600)
    window_chunks = 150 if case == "multi_window" else None
    if case == "order_c":
        order = "C"
    movie = _smooth_movie(t, 40, 36)
    if case == "uint16_numpy":
        movie = np.clip(np.rint(movie * 2000.0 + 500.0), 0, 65535).astype(np.uint16)
    monkeypatch.setattr(port_pipeline, "threshold_heuristic", lambda *a, **k: (1e9, 1e9))
    runs = {}
    with sketch_override(lambda shape: np.random.default_rng(1234).standard_normal(shape)):
        for dev in ("cpu", "cuda"):
            runs[dev] = port_pipeline.localmd_decomposition(
                movie, (16, 16), frame_range=frame_range, order=order, max_components=6,
                background_rank=2, temporal_avg_factor=5, seed=0, device=dev,
                window_chunks=window_chunks,
            )
    frames = np.arange(t)
    ref = runs["cpu"].reconstruct_frames(frames)
    ours = runs["cuda"].reconstruct_frames(frames).cpu()
    assert _rel_fro(ours, ref) <= 1e-4
    np.testing.assert_allclose(runs["cuda"].var_img, runs["cpu"].var_img, rtol=1e-4)
    assert runs["cuda"].rank == runs["cpu"].rank


def test_block_reconstruct_rejects_out_of_canvas_blocks(cuda):
    from localmd_tpu_torch.ops import kernels
    from localmd_tpu_torch.ops.tiling import BlockGrid

    grid = BlockGrid(60, 52, (20, 20))
    n = grid.n_blocks
    starts = grid.starts.copy()
    starts[-1, 1] += 1                       # one block past the right edge
    before = kernels.block_reconstruct.launches
    with pytest.raises(ValueError, match="outside the FOV"):
        kernels.block_reconstruct(
            torch.zeros(n, 400, 2, device=cuda), torch.zeros(n, 2, 3, device=cuda),
            starts, [ids for ids, _ in grid.cosets()], (60, 52), (20, 20),
        )
    # the starts stay on the host: the wrapper reads nothing back from the card
    with pytest.raises(ValueError, match="on the host"):
        kernels.block_reconstruct(
            torch.zeros(n, 400, 2, device=cuda), torch.zeros(n, 2, 3, device=cuda),
            torch.as_tensor(grid.starts, device=cuda), [ids for ids, _ in grid.cosets()],
            (60, 52), (20, 20),
        )
    assert kernels.block_reconstruct.launches == before


NEW_DTYPES = ("int16", "uint8", "int8", "float16", "bfloat16")


def _dtype_values(dtype, shape, g, kind):
    """chip_smoke.dtype_values: bench_torch.make_movie's construction of
    ``dtype`` on N(0, 1), small noise on a baseline, or the type's ends."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import dtype_values

    return dtype_values(dtype, shape, g, kind)


@pytest.mark.parametrize("dtype", NEW_DTYPES)
@pytest.mark.parametrize("kind,t,p,nperseg", [
    ("movie", 1024, 5000, 256), ("movie", 500, 4097, 500), ("baseline", 1024, 8192, 256),
    ("extremes", 512, 700, 256),
])
def test_movie_stats_new_dtypes_match_plain(cuda, dtype, kind, t, p, nperseg):
    """K1 on int16 (negative samples), uint8, int8, float16 and bfloat16, P
    on and off the 16-byte chunk, and from a base off 16-byte alignment."""
    from localmd_tpu_torch.ops import kernels

    g = torch.Generator(device=cuda).manual_seed(5)
    x = _dtype_values(dtype, (t + 1, p), g, kind)
    for chunk in (x[:t], x.reshape(-1)[1 : 1 + t * p].view(t, p)):
        before = kernels.movie_stats.launches
        m_k, s_k = kernels.movie_stats(chunk, t, nperseg=nperseg)
        assert kernels.movie_stats.launches == before + 1
        m_p, s_p = kernels.movie_stats_plain(chunk, t, nperseg=nperseg)
        assert float((m_k - m_p).abs().max() / m_p.abs().max().clamp_min(1e-30)) <= 1e-5
        torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=0)


@pytest.mark.parametrize("dtype", NEW_DTYPES)
@pytest.mark.parametrize("kind,t,d,r", [
    ("movie", 300, 20000, 77), ("movie", 256, 1 << 20, 168), ("baseline", 100, 701, 37),
    ("extremes", 64, 4096, 176),
    ("movie", 4000, 640 * 540, 1650), ("movie", 512, 256, 200), ("baseline", 129, 20000, 1),
    ("movie", 129, 20000, 176), ("extremes", 129, 20000, 177),
])
def test_v_projection_new_dtypes_match_plain(cuda, dtype, kind, t, d, r):
    from localmd_tpu_torch.ops import kernels

    g = torch.Generator(device=cuda).manual_seed(6)
    raw = _dtype_values(dtype, (t, d + 1), g, kind)
    a = torch.randn(d, r, generator=g, device=cuda) * 0.01
    c = torch.randn(r, generator=g, device=cuda)
    for chunk in (raw[:, :d].contiguous(), raw.reshape(-1)[1 : 1 + t * d].view(t, d)):
        before = kernels.v_projection.launches
        out = kernels.v_projection(chunk, a, c)
        assert kernels.v_projection.launches == before + 1
        assert _rel_fro(out, kernels.v_projection_plain(chunk, a, c)) <= 1e-5


def test_kernels_refuse_other_dtypes(cuda):
    """float64, int32 and int64 chunks raise in the wrappers; nothing is
    launched and nothing is cast there."""
    from localmd_tpu_torch.ops import kernels

    a = torch.zeros(64, 3, device=cuda)
    c = torch.zeros(3, device=cuda)
    for dt in (torch.float64, torch.int32, torch.int64):
        x = torch.zeros(300, 64, device=cuda, dtype=dt)
        with pytest.raises(ValueError, match="bfloat16"):
            kernels.movie_stats(x, 300)
        with pytest.raises(ValueError, match="bfloat16"):
            kernels.v_projection(x, a, c)


@pytest.mark.parametrize("dtype", NEW_DTYPES + ("float64", "int32"))
def test_card_resident_dtypes_match_the_float32_movie(cuda, dtype):
    """A card-resident movie of each dtype against the float32 movie of the
    same values: equal ranks, reconstruction within 1e-5, K1 and K2 (the
    40 x 36 grid has a snapped tail) launched on the native dtype or, for
    float64 and int32, on float32 chunks."""
    import os
    import sys

    import localmd_tpu_torch.pipeline as port_pipeline
    from localmd_tpu_torch.ops import kernels

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import LAUNCH_DTYPES, install_dtype_spies

    movie = torch.from_numpy(_smooth_movie(600, 40, 36)).to(cuda)
    if dtype in ("int16", "int32"):
        movie = (movie * 2000 - 700).round()
    elif dtype in ("uint8", "int8"):
        movie = (movie * 100 + (0 if dtype == "uint8" else -60)).round()
    movie = movie.to(getattr(torch, dtype))
    # the dtype each K1/K2 launch passes to its CUDA entry point (a spy on
    # the wrapper itself would take its launch count)
    install_dtype_spies()
    runs, seen = [], []
    for m in (movie, movie.float()):
        LAUNCH_DTYPES.clear()
        runs.append(port_pipeline.localmd_decomposition(
            m, (16, 16), frame_range=600, max_components=6, background_rank=2,
            temporal_avg_factor=5, seed=0, device="cuda"))
        seen.append(set(LAUNCH_DTYPES))
    want = str(movie.dtype if movie.dtype in kernels.KERNEL_DTYPES else torch.float32)
    want = want.removeprefix("torch.")
    assert seen == [{("movie_stats", want), ("v_projection", want)},
                    {("movie_stats", "float32"), ("v_projection", "float32")}]
    assert runs[0].pipeline_ranks == runs[1].pipeline_ranks
    frames = np.arange(600)
    assert _rel_fro(runs[0].reconstruct_frames(frames), runs[1].reconstruct_frames(frames)) <= 1e-5
