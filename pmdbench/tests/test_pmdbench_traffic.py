"""The generators repeat for a seed: the movie, piece by piece, and the
view request list, whose sizes are the same for every seed."""

import numpy as np
import pytest
import torch

from pmdbench import catalog, traffic
from pmdbench.movie import Movie, part_seed

SPEC = dict(recipe="two_photon", shape=[700, 24, 20], dtype="uint16", piece_frames=128,
            n_cells=5, radius=3.0, rate=0.01, tau=20.0, amplitude=5.0, noise_sigma=1.0,
            offset=100.0, counts_per_sigma=40.0)


def test_movie_repeats_for_a_seed_and_pieces_stand_alone():
    a = Movie(SPEC, 3_000_000_001, "cpu").to_card()
    b = Movie(SPEC, 3_000_000_001, "cpu")
    assert a.dtype == torch.uint16 and tuple(a.shape) == (700, 24, 20)
    assert torch.equal(a, b.to_card())
    assert torch.equal(a[200:650], b.frames(200, 650))
    host = b.to_host()
    assert host.dtype == np.uint16 and np.array_equal(host, a.numpy())
    c = Movie(SPEC, 3_000_000_002, "cpu").to_card()
    assert not torch.equal(a, c)


def test_movie_counts_and_noise_scale():
    movie = Movie(SPEC, 5, "cpu").to_card().to(torch.float64)
    # offset 100 sigmas at 40 counts per sigma, noise sigma 40 counts
    assert 3990 < float(movie.median()) < 4030
    assert 35 < float(movie.diff(dim=0).std()) / 2**0.5 < 45


def test_widefield_recipe_builds():
    spec = dict(recipe="widefield", shape=[300, 36, 36], dtype="uint16", piece_frames=128,
                n_sources=4, radius_divisor=12.0, rate=0.02, tau=40.0, amplitude=3.0, bg_rank=2,
                bg_radius_divisor=3.0, bg_rate=0.05, bg_tau=100.0, bg_amplitude=10.0,
                noise_sigma=1.0, offset=200.0, counts_per_sigma=40.0)
    movie = Movie(spec, 9, "cpu").to_card()
    assert movie.shape == (300, 36, 36) and int(movie.to(torch.int32).min()) > 6000


def test_part_seeds_differ_by_part_and_piece_and_take_large_seeds():
    seeds = {part_seed(2**40 + 3, p, i) for p in ("spatial", "noise") for i in range(3)}
    assert len(seeds) == 6
    assert all(0 <= s < 2**63 for s in seeds)


def test_view_requests_repeat_and_keep_their_sizes_across_seeds():
    mix = catalog.traffic("view")
    shape = (30000, 512, 512)
    a = traffic.view_requests(mix, shape, 2**33 + 1)
    assert a == traffic.view_requests(mix, shape, 2**33 + 1)
    b = traffic.view_requests(mix, shape, 77)
    assert a != b
    size = lambda r: (r["kind"], r["n"], r["h"], r["w"])  # noqa: E731
    assert sorted(map(size, a)) == sorted(map(size, b))
    assert len(a) == mix["requests"]
    kinds = [r["kind"] for r in a]
    assert kinds.count("frame") == 2000 and kinds.count("roi_trace") == 1200
    for r in a:
        assert 0 <= r["t0"] and r["t0"] + r["n"] <= 30000
        assert r["r0"] + r["h"] <= 512 and r["c0"] + r["w"] <= 512
        if r["kind"] == "roi_trace":
            assert 16 <= r["h"] == r["w"] <= 64 and 1000 <= r["n"] <= 8000
        if r["kind"] == "playback":
            assert 16 <= r["n"] <= 128 and r["h"] == 512


def test_request_keys():
    frame = dict(kind="frame", n=1, t0=9, r0=0, c0=0, h=512, w=512)
    assert traffic.request_key(frame) == (9, slice(0, 512), slice(0, 512))
    roi = dict(kind="roi_trace", n=1000, t0=5, r0=3, c0=4, h=16, w=16)
    assert traffic.request_key(roi) == (slice(5, 1005), slice(3, 19), slice(4, 20))


def test_host_movie_counts_bytes_it_hands_out():
    from localmd_tpu_torch.dataset import NumpyArray

    arr = np.arange(5 * 4 * 3, dtype=np.uint16).reshape(5, 4, 3)
    ds = traffic.host_movie(arr)
    assert isinstance(ds, NumpyArray) and not hasattr(ds, "set_io_threads")
    out = np.empty((2, 4, 3), np.uint16)
    ds.read_into(slice(1, 3), out)
    assert np.array_equal(out, arr[1:3]) and ds.bytes_read == out.nbytes
    ds.read_into([0, 4], out)
    assert np.array_equal(out, arr[[0, 4]]) and ds.bytes_read == 2 * out.nbytes
    assert ds.shape == (5, 4, 3) and ds.dtype == np.uint16
    assert np.array_equal(ds[2], arr[2]) and ds.bytes_read == 2 * out.nbytes + arr[2].nbytes
    assert traffic.host_movie(arr).bytes_read == 0
    with pytest.raises(IndexError):
        ds[9]
