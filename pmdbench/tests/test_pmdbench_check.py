"""A whole run on the CPU at a tiny size, past the harness's look for a
card: sound runs come out correct, and a timed path broken underneath
comes out not correct, once for each fault the cells can have. (The
cells run on one card, so there is no exchange between cards to leave
out.)"""

import numpy as np
import pytest
import torch

from conftest import run_tiny


def test_sound_runs_are_correct(tiny):
    bench, root = tiny
    for cell in ("northstar_u16.stream", "northstar_u16.resident", "northstar_u16.view"):
        result = run_tiny(bench, root, cell)
        assert result["correct"] is True, (cell, result["checks"])
        assert result["failed"] == 0 and result["attempted"] >= 1
        assert list(result)[-1] == "checks"


def _stats_unchanged(monkeypatch):
    """The statistics pass returns its state as it started: zero images."""
    from localmd_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "movie_stats",
                        lambda chunk, *a, **k: (torch.zeros(chunk.shape[1]),) * 2)


def _stats_half(monkeypatch):
    """Every other chunk of the statistics pass left out, the mean taken
    over the rest."""
    from localmd_tpu_torch.ops import kernels

    real, seen = kernels.movie_stats, [0]

    def half(chunk, divisor, *a, **k):
        seen[0] += 1
        mean, sigma = real(chunk, divisor, *a, **k)
        if seen[0] % 2 == 0:
            return torch.zeros_like(mean), torch.zeros_like(sigma)
        return 2 * mean, sigma

    monkeypatch.setattr(kernels, "movie_stats", half)


def _v_half(monkeypatch):
    """The V regression's second half of the frames left out."""
    from localmd_tpu_torch.loader import PMDLoader

    real = PMDLoader.v_projection

    def half(self, u, p):
        v = real(self, u, p)
        v[:, v.shape[1] // 2 :] = 0
        return v

    monkeypatch.setattr(PMDLoader, "v_projection", half)


def _v_altered(monkeypatch):
    """One frame's temporal coefficients altered where they are produced."""
    from localmd_tpu_torch.loader import PMDLoader

    real = PMDLoader.v_projection

    def altered(self, u, p):
        v = real(self, u, p)
        v[:, 7] *= 1.05
        return v

    monkeypatch.setattr(PMDLoader, "v_projection", altered)


def _frames_altered(monkeypatch):
    """Each served frame off by one in time."""
    from localmd_tpu_torch.pmd_array import PMDArray

    real = PMDArray.__getitem__

    def shifted(self, key):
        t = key[0]
        t = t + 1 if isinstance(t, int) else slice(t.start + 1, t.stop + 1)
        if (t if isinstance(t, int) else t.stop) > self.shape[0]:
            t = key[0]
        return real(self, (t,) + tuple(key[1:]))

    monkeypatch.setattr(PMDArray, "__getitem__", shifted)


def _grid_half(monkeypatch):
    """The block stage's components of half the block grid left out."""
    from localmd_tpu_torch import pipeline

    from pmdbench import faults

    monkeypatch.setattr(pipeline, "BlockSparseMatrix",
                        faults._drop_half_grid(pipeline.BlockSparseMatrix))


@pytest.mark.parametrize("cell,fault", [
    ("northstar_u16.stream", _stats_unchanged),
    ("northstar_u16.stream", _stats_half),
    ("northstar_u16.resident", _stats_half),
    ("northstar_u16.resident", _v_half),
    ("northstar_u16.stream", _v_half),
    ("northstar_u16.stream", _v_altered),
    ("northstar_u16.stream", _grid_half),
    ("northstar_u16.resident", _grid_half),
    ("northstar_u16.view", _grid_half),
    ("northstar_u16.view", _stats_half),
    ("northstar_u16.view", _frames_altered),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    bench, root = tiny
    fault(monkeypatch)
    result = run_tiny(bench, root, cell)
    assert result["correct"] is False, result["checks"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_a_call_that_reads_less_than_the_movie_fails(tiny, monkeypatch):
    """A call served from a cache across calls reads less than the movie
    from its fresh dataset: counted as failed, and the run not correct."""
    from pmdbench import traffic

    bench, root = tiny
    counted = traffic._counted_array()
    real = counted.read_into

    def short(self, frames, out):
        real(self, frames, out)
        self.bytes_read -= out.nbytes * 3 // 4
        return out

    monkeypatch.setattr(counted, "read_into", short)
    result = run_tiny(bench, root, "northstar_u16.stream")
    assert result["failed"] >= 1 and result["correct"] is False


def test_traced_runs_report_the_per_layer_metrics(tiny):
    bench, root = tiny
    result = run_tiny(bench, root, "northstar_u16.stream", traced=True)
    assert {"stats_s.stream", "block_s.stream", "fsvd_s.stream", "vreg_s.stream",
            "stream_roofline"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert np.isfinite(result["device"]["window_s"])
