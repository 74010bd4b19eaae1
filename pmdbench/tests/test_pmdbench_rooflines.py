"""Each roofline's counts at known shapes, and the readers built on them."""

import pytest

from pmdbench import catalog, rooflines


def test_k1_counts_the_movie_once_and_two_images():
    assert rooflines.k1_bytes(30000, 512 * 512, "uint16") == 30000 * 262144 * 2 + 2 * 262144 * 4
    peaks = catalog.peaks()
    assert rooflines.k1_seconds(1024, 262144, "float32", peaks) == pytest.approx(
        (1024 * 262144 * 4 + 8 * 262144) / 3.35e12)


def _traced(kernels, calls=2):
    return dict(profile=dict(device_ops=kernels, busy_s=1.0, window_s=4.0),
                calls=[dict(wall_s=2.0, ranks=dict(reduced=168), cache=dict(stream_dtype="uint16"))
                       ] * calls,
                requests=None, movie=dict(shape=(4096, 1024, 1024), nbytes=4096 * 2**20 * 2),
                traffic=dict(movie_on="card"), peaks=catalog.peaks())


def test_kernel_readers_divide_the_bound_by_the_kernels_time():
    peaks = catalog.peaks()
    run = _traced({"void movie_stats_wgmma_kernel<2>(...)": 0.05, "vproj_wgmma_kernel": 0.03,
                   "vproj_reduce_kernel": 0.01, "other": 1.0})
    k1 = 2 * rooflines.k1_seconds(4096, 2**20, "uint16", peaks)
    assert catalog.reader("k1_roofline")(run) == pytest.approx(100 * k1 / 0.05)
    assert catalog.reader("idle_share.decompose")(run) == pytest.approx(75.0)
    assert catalog.reader("idle_share.view")(dict(run, calls=None)) is None


def test_a_kernel_off_the_path_reads_nothing():
    run = _traced({"other": 1.0})
    assert catalog.reader("k1_roofline")(run) is None


def test_stream_roofline_only_where_the_movie_streams():
    run = _traced({})
    assert catalog.reader("stream_roofline")(run) is None
    run["traffic"] = dict(movie_on="host")
    bound = 4096 * 2**20 * 2 / 6.4e10
    assert catalog.reader("stream_roofline")(run) == pytest.approx(100 * bound * 2 / 4.0)
