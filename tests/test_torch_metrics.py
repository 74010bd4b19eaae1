"""The port's ``metrics`` against ``localmd_tpu.metrics`` on one shared .npz
(written by the port's pipeline on a small movie): the compression ratio,
the streamed reconstruction errors and the residual-to-noise ratio, equal
to rtol 1e-5. The port reads the factors both from the file (a sparse CSR
reconstruction) and from its in-process result (K3's plain twin), the movie
from memory, a tensor and a uint16 .npy file."""

import numpy as np
import pytest
import torch

from conftest import make_low_rank_movie

import localmd_tpu.metrics as jax_metrics
import localmd_tpu_torch.metrics as port_metrics
from localmd_tpu import load_decomposition as jax_load
from localmd_tpu_torch import load_decomposition as port_load
from localmd_tpu_torch import localmd_decomposition
from localmd_tpu_torch.utils.random import sketch_override


def _sketch(shape):
    return np.random.default_rng(1234).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """A uint16 movie, the port's decomposition of it and its .npz, loaded
    by both packages."""
    movie = make_low_rank_movie(3, (300, 20, 24), rng=np.random.default_rng(5), noise=0.3)
    movie = np.clip(np.rint(movie * 300.0 + 500.0), 0, 65535).astype(np.uint16)
    folder = tmp_path_factory.mktemp("metrics")
    npz, npy = str(folder / "d.npz"), str(folder / "m.npy")
    np.save(npy, movie)
    with sketch_override(_sketch):
        pmd = localmd_decomposition(movie, (10, 12), frame_range=300, max_components=5,
                                    background_rank=1, temporal_avg_factor=4, sim_iters=10,
                                    seed=0, device="cpu")
    pmd.to_npz(npz)
    return dict(movie=movie, npy=npy, in_process=pmd, npz=port_load(npz, device="cpu"),
                jax=jax_load(npz))


def _source(shared, kind):
    if kind == "numpy":
        return shared["movie"]
    if kind == "tensor":
        return torch.from_numpy(shared["movie"])
    return shared["npy"]


def test_compression_ratio_matches_jax(shared):
    ref = jax_metrics.compression_ratio(shared["jax"])
    assert port_metrics.compression_ratio(shared["npz"]) == pytest.approx(ref, rel=1e-12)
    assert port_metrics.compression_ratio(shared["in_process"]) == pytest.approx(ref, rel=1e-12)
    assert ref > 1.0


@pytest.mark.parametrize("factors", ["npz", "in_process"])
@pytest.mark.parametrize("source", ["numpy", "tensor", "npy_file"])
@pytest.mark.parametrize("frames,chunk", [(None, 512), (range(10, 290, 3), 64)])
def test_reconstruction_error_matches_jax(shared, factors, source, frames, chunk):
    ref = jax_metrics.reconstruction_error(shared["jax"], shared["movie"], frames=frames,
                                           chunk_frames=chunk)
    ours = port_metrics.reconstruction_error(shared[factors], _source(shared, source),
                                             frames=frames, chunk_frames=chunk, device="cpu")
    assert ours["frames"] == ref["frames"]
    for key in ("rel_error", "rel_error_centered"):
        assert ours[key] == pytest.approx(ref[key], rel=1e-5), key
    assert 0 < ours["rel_error"] < ours["rel_error_centered"] < 1


@pytest.mark.parametrize("factors", ["npz", "in_process"])
@pytest.mark.parametrize("frames,chunk", [(None, 512), (range(0, 300, 2), 37)])
def test_residual_noise_ratio_matches_jax(shared, factors, frames, chunk):
    ref = jax_metrics.residual_noise_ratio(shared["jax"], shared["movie"], frames=frames,
                                           chunk_frames=chunk)
    ours = port_metrics.residual_noise_ratio(shared[factors], shared["movie"], frames=frames,
                                             chunk_frames=chunk, device="cpu")
    assert ours == pytest.approx(ref, rel=1e-5)
    assert 0.3 < ours < 3.0
