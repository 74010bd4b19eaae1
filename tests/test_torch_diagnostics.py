"""The port's streamed QC images (``localmd_tpu_torch.diagnostics``)
against ``localmd_tpu.diagnostics``: every image function, both modes (or
two lags), with the PMD movie given as a dense numpy array, as a PMDArray
(the port's built from the JAX run's block panels, so K3's plain twin
reconstructs it) and as the port's PMDArray loaded from the JAX run's .npz
(a sparse CSR reconstruction); 64-frame chunks over 300 frames. Tolerance:
rtol 1e-4, atol 1e-5. One matplotlib render of the component browser and
the QC panel."""

import os

import numpy as np
import pytest

from conftest import make_low_rank_movie

import localmd_tpu.diagnostics as jd
import localmd_tpu_torch.diagnostics as td
from localmd_tpu_torch import PMDArray, load_decomposition

CHUNK = 64


@pytest.fixture(scope="module")
def movies(tmp_path_factory):
    from localmd_tpu import localmd_decomposition

    movie = make_low_rank_movie(3, (300, 20, 20), rng=np.random.default_rng(4), noise=0.3)
    jax_pmd = localmd_decomposition(movie, (10, 10), frame_range=300, max_components=5,
                                    background_rank=1, temporal_avg_factor=4, sim_iters=15,
                                    seed=0)
    u = jax_pmd._blocksparse
    state = dict(
        panels=np.asarray(u.panels), rows=np.asarray(u.rows), dense_basis=np.asarray(u.dense_basis),
        starts=np.asarray(u.starts), block_shape=u.block_shape, counts=np.asarray(jax_pmd._counts),
        r=np.asarray(jax_pmd._r_padded), s=np.asarray(jax_pmd._s_src), v=np.asarray(jax_pmd._v_src),
        k2_keep=jax_pmd._k2_keep, mean_img=jax_pmd.mean_img, std_img=jax_pmd.var_img,
        order=jax_pmd.order,
    )
    npz = str(tmp_path_factory.mktemp("diag") / "d.npz")
    jax_pmd.to_npz(npz)
    return dict(
        raw=movie,
        numpy=(jax_pmd[:, :, :], jax_pmd[:, :, :]),
        pmdarray=(jax_pmd, PMDArray.from_reference_state(state, device="cpu")),
        npz=(jax_pmd, load_decomposition(npz, device="cpu")),
    )


SOURCES = ["numpy", "pmdarray", "npz"]


def _close(ours, ref):
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("mode", ["max", "mean"])
def test_correlation_image_of_the_pmd_movie(movies, source, mode):
    ref_src, port_src = movies[source]
    _close(td.make_correlation_image(port_src, mode, chunk_frames=CHUNK, device="cpu"),
           jd.make_correlation_image(ref_src, mode, chunk_frames=CHUNK))


@pytest.mark.parametrize("mode", ["max", "mean"])
def test_correlation_image_of_the_raw_movie(movies, mode):
    _close(td.make_correlation_image(movies["raw"], mode, chunk_frames=CHUNK, device="cpu"),
           jd.make_correlation_image(movies["raw"], mode, chunk_frames=CHUNK))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("lag", [1, 3])
def test_autocorrelation_image(movies, source, lag):
    ref_src, port_src = movies[source]
    _close(td.make_autocorrelation_image(port_src, lag, chunk_frames=CHUNK, device="cpu"),
           jd.make_autocorrelation_image(ref_src, lag, chunk_frames=CHUNK))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("mode", ["max", "mean"])
@pytest.mark.parametrize("kind", ["pmd", "residual"])
def test_scaled_covariance_images(movies, source, mode, kind):
    ref_src, port_src = movies[source]
    name = f"make_{kind}_correlation_image"
    _close(getattr(td, name)(movies["raw"], port_src, mode, chunk_frames=CHUNK, device="cpu"),
           getattr(jd, name)(movies["raw"], ref_src, mode, chunk_frames=CHUNK))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("mode", ["max", "mean"])
def test_compute_qc_images(movies, source, mode):
    ref_src, port_src = movies[source]
    ours = td.compute_qc_images(movies["raw"], port_src, mode, lag=2, chunk_frames=CHUNK,
                                device="cpu")
    ref = jd.compute_qc_images(movies["raw"], ref_src, mode, lag=2, chunk_frames=CHUNK)
    assert set(ours) == set(ref) == {"correlation", "autocorrelation", "pmd_cov", "residual_cov"}
    for key in ref:
        _close(ours[key], ref[key])


def test_movie_sources_give_one_image(movies, tmp_path):
    """A tensor, a .npy file and a uint16 TensorMovie give the numpy source's image."""
    import torch

    from localmd_tpu_torch import TensorMovie

    raw = movies["raw"]
    want = td.make_correlation_image(raw, "mean", chunk_frames=CHUNK, device="cpu")
    path = str(tmp_path / "m.npy")
    np.save(path, raw)
    for src in (torch.from_numpy(raw), path, TensorMovie(torch.from_numpy(raw))):
        np.testing.assert_array_equal(
            td.make_correlation_image(src, "mean", chunk_frames=CHUNK, device="cpu"), want)
    u16 = np.clip(np.rint(raw * 100 + 300), 0, 65535).astype(np.uint16)
    _close(td.make_correlation_image(TensorMovie(torch.from_numpy(u16)), "max", chunk_frames=CHUNK,
                                     device="cpu"),
           jd.make_correlation_image(u16, "max", chunk_frames=CHUNK))


def test_matplotlib_render(movies, tmp_path):
    _, port_pmd = movies["pmdarray"]
    folder = str(tmp_path)
    td.plot_pmd_components(port_pmd, folder, max_components=2)
    assert sorted(f for f in os.listdir(folder)) == ["Component_0.html", "Component_1.html"]
    index = td.construct_index(folder)
    content = open(index).read()
    assert "'Component_0.html'" in content and "'Component_1.html'" in content
    images = td.compute_qc_images(movies["raw"], port_pmd, device="cpu", chunk_frames=CHUNK)
    fig = td.make_pmd_corr_diagnostic_plot(*images.values())
    assert len(fig.axes) == 5
    with pytest.raises(ValueError, match="does not exist"):
        td.plot_pmd_components(port_pmd, str(tmp_path / "missing"))
