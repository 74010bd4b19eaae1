"""The port's synthetic movies (``localmd_tpu_torch.sim``). torch cannot
reproduce JAX's threefry streams, so these check the construction, with the
JAX package's constants: shape, dtype, device, the offsets, the footprints'
centres, widths and support, the traces' spike rate and decay, and seeded
reproducibility. One case also holds the statistics of the port's movie
beside the JAX package's at the same size."""

import math

import numpy as np
import pytest
import torch

from localmd_tpu_torch import sim

SMALL = {
    "two_photon_movie": (dict(d1=40, d2=36, t=200, n_cells=12), 100.0),
    "widefield_movie": (dict(d1=48, d2=40, t=160, n_sources=6, background_rank=2), 200.0),
    "voltage_movie": (dict(d1=32, d2=30, t=400, n_cells=8), 50.0),
}


@pytest.mark.parametrize("name", list(SMALL))
def test_shape_dtype_device_and_offset(name):
    kw, offset = SMALL[name]
    movie = getattr(sim, name)(**kw, seed=3, device="cpu")
    assert tuple(movie.shape) == (kw["t"], kw["d1"], kw["d2"])
    assert movie.dtype == torch.float32 and movie.device.type == "cpu"
    clean = getattr(sim, name)(**kw, noise_sigma=0.0, seed=3, device="cpu")
    # footprints and traces are non-negative: the offset is the floor
    assert float(clean.min()) >= offset - 1e-4
    assert float(clean.max()) > offset + 1.0
    noise = movie - clean
    assert abs(float(noise.std()) - 1.0) < 0.05 and abs(float(noise.mean())) < 0.02


@pytest.mark.parametrize("name", list(SMALL))
def test_seeded_reproducibility(name):
    kw, _ = SMALL[name]
    fn = getattr(sim, name)
    a, b, c = fn(**kw, seed=7, device="cpu"), fn(**kw, seed=7, device="cpu"), fn(**kw, seed=8, device="cpu")
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)


@pytest.mark.parametrize("radius", [6.0, 5.0, 13.0])
def test_footprints_are_compact_blobs_inside_the_fov(radius):
    d1, d2, n = 96, 80, 40
    gen = torch.Generator().manual_seed(11)
    fp = sim._gaussian_blobs(gen, n, d1, d2, radius)
    assert tuple(fp.shape) == (d1, d2, n)
    flat = fp.reshape(-1, n)
    peak = flat.argmax(dim=0)
    cy, cx = (peak // d2).double(), (peak % d2).double()
    # centres uniform in [radius, d - radius), the peak pixel within 1 of it
    assert float(cy.min()) >= radius - 1 and float(cy.max()) <= d1 - radius + 1
    assert float(cx.min()) >= radius - 1 and float(cx.max()) <= d2 - radius + 1
    # peak near 1, widths radius x [0.6, 1.4): outside 5 x 1.4 x radius
    # every footprint is below exp(-12.5)
    assert float(flat.max(dim=0).values.min()) > math.exp(-1.0 / (2 * (0.6 * radius) ** 2)) - 1e-6
    yy = torch.arange(d1, dtype=torch.float64)[:, None, None]
    xx = torch.arange(d2, dtype=torch.float64)[None, :, None]
    far = ((yy - cy) ** 2 + (xx - cx) ** 2).sqrt() > 5 * 1.4 * radius + 1.5
    assert float(fp.double()[far].max()) < math.exp(-12.5)


@pytest.mark.parametrize("rate,tau", [(0.01, 20.0), (0.05, 3.0), (0.02, 40.0), (0.05, 100.0)])
def test_traces_are_bernoulli_spikes_through_an_exponential_decay(rate, tau):
    n, t = 200, 1000
    traces = sim._calcium_traces(torch.Generator().manual_seed(2), n, t, rate, tau)
    assert tuple(traces.shape) == (n, t) and traces.dtype == torch.float32
    decay = math.exp(-1.0 / tau)
    tr = traces.double()
    spikes = torch.cat([tr[:, :1], tr[:, 1:] - decay * tr[:, :-1]], dim=1)
    # every step adds exactly 0 or 1 on top of the decayed previous value
    assert float((spikes - spikes.round()).abs().max()) < 1e-4
    assert set(spikes.round().unique().tolist()) <= {0.0, 1.0}
    observed = float(spikes.round().mean())
    assert abs(observed - rate) < 5 * math.sqrt(rate * (1 - rate) / (n * t))


def test_volumetric_stack_is_one_two_photon_movie_per_plane():
    planes = sim.volumetric_stack(n_planes=3, d1=24, d2=20, t=64, seed=4, device="cpu")
    assert len(planes) == 3
    for p, plane in enumerate(planes):
        assert torch.equal(plane, sim.two_photon_movie(24, 20, 64, n_cells=60, seed=4 + p, device="cpu"))


def test_statistics_match_the_jax_construction():
    """Same construction, other streams: the mean signal per frame above
    the offset agrees with the JAX package's movie to within its spread."""
    from localmd_tpu import sim as jax_sim

    kw = dict(d1=64, d2=64, t=600, n_cells=40)
    ours = sim.two_photon_movie(**kw, seed=0, device="cpu").double()
    ref = torch.as_tensor(np.array(jax_sim.two_photon_movie(**kw, seed=0))).double()
    sig_ours, sig_ref = float(ours.mean()) - 100.0, float(ref.mean()) - 100.0
    assert 0 < 0.5 * sig_ref < sig_ours < 2.0 * sig_ref
    std_ours, std_ref = float(ours.mean(dim=(1, 2)).std()), float(ref.mean(dim=(1, 2)).std())
    assert 0.5 * std_ref < std_ours < 2.0 * std_ref
