"""The window's arithmetic: rates over all the work and all the time, the
tail over every request, and the seeded sample."""

import statistics

import pytest

from pmdbench import catalog, window


def test_rate_is_all_work_over_all_time():
    assert window.rate(3 * 7.5e9, 12.0) == pytest.approx(1.875e9)
    with pytest.raises(ValueError):
        window.rate(1.0, 0.0)


def test_percentile_covers_every_value():
    values = list(range(1, 101))
    assert window.percentile(values, 95) == pytest.approx(95.05)
    assert window.percentile(values, 50) == pytest.approx(statistics.median(values))
    assert window.percentile([4.0], 95) == 4.0


def test_reservoir_repeats_for_a_seed_and_keeps_k():
    picks = []
    for _ in range(2):
        r = window.Reservoir(3, 2**40 + 7)
        for i in range(50):
            r.offer(i)
        picks.append(r.items)
    assert picks[0] == picks[1] and len(picks[0]) == 3
    other = window.Reservoir(3, 11)
    for i in range(50):
        other.offer(i)
    assert len(set(other.items)) == 3


def _decompose_run():
    calls = [dict(wall_s=w, timings=dict(stats_and_background=w / 2, block_decomposition=0.1,
                                         factorized_svd=0.05, v_regression=0.1),
                  ranks=dict(reduced=100), cache=dict(stream_dtype="uint16"))
             for w in (2.0, 2.5, 3.0)]
    return dict(calls=calls, window_s=8.0, movie=dict(pixel_frames=512 * 512 * 30000,
                                                       nbytes=512 * 512 * 30000 * 2,
                                                       shape=(30000, 512, 512)),
                traffic=dict(movie_on="host"), peaks=catalog.peaks(),
                setup_s=40.0)


def test_decompose_rate_and_stage_readers():
    run = _decompose_run()
    assert catalog.reader("decompose_mpf_per_s")(run) == pytest.approx(
        3 * 512 * 512 * 30000 / 8.0 / 1e6)
    assert catalog.reader("stats_s")(run) == pytest.approx(1.25)
    assert catalog.reader("setup_s")(run) == 40.0
    assert catalog.reader("view_p95_ms")(run) is None


def test_view_readers_take_every_request():
    lat = [0.001 * (i + 1) for i in range(200)]
    run = dict(requests=[dict(kind="frame" if i % 2 else "playback", latency_s=s,
                              pixel_frames=1000) for i, s in enumerate(lat)], window_s=4.0)
    assert catalog.reader("view_p95_ms")(run) == pytest.approx(1e3 * window.percentile(lat, 95))
    assert catalog.reader("view_mpf_per_s")(run) == pytest.approx(200 * 1000 / 4.0 / 1e6)
    frames = [s for i, s in enumerate(lat) if i % 2]
    assert catalog.reader("view_frame_p50_ms")(run) == pytest.approx(
        1e3 * statistics.median(frames))
    assert catalog.reader("decompose_mpf_per_s")(run) is None
