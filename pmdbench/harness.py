"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result.

The traffic mix's ``kind`` picks the loop: ``decompose`` (one caller,
``localmd_decomposition`` back to back) or ``view`` (one client,
``PMDArray.__getitem__`` on a decomposition made in set-up). Everything
else -- sizes, settings, the mix, the limits, the metrics -- comes from the
cell's files (``catalog``).
"""

from __future__ import annotations

import contextlib
import gc
import logging
import subprocess
import sys
import time

import numpy as np
import torch

from pmdbench import catalog, trace, traffic, window
from pmdbench.movie import Movie
from pmdbench.reference import frames as ref_frames
from pmdbench.reference import projection as ref_projection
from pmdbench.reference import sources as ref_sources
from pmdbench.reference import stats as ref_stats

# top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "localmd_tpu")


def log(msg: str) -> None:
    print(f"pmdbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules_loaded() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _profiled(on: bool, dev: torch.device):
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield prof


def import_port(dev: torch.device) -> dict:
    """Import the port and load its built kernels (built here on a
    checkout's first run); returns what that took."""
    t0 = time.perf_counter()
    import localmd_tpu_torch  # noqa: F401
    from localmd_tpu_torch import config as port_config
    from localmd_tpu_torch.utils.logging import get_logger

    port_config.apply()
    get_logger().setLevel(logging.WARNING)
    info = dict(import_s=time.perf_counter() - t0)
    if dev.type == "cuda":
        from localmd_tpu_torch.ops import _build

        t1 = time.perf_counter()
        _build.library()
        info.update(library_s=time.perf_counter() - t1,
                    built_here=not _build.last_build.get("cached", False),
                    build_s=_build.last_build.get("seconds", 0.0))
    return info


def factors(pmd) -> dict:
    """A decomposition's outputs, as the public API gives them on the host."""
    u = pmd.u
    return dict(indptr=u.indptr, indices=u.indices, data=u.data, r=pmd.r, s=pmd.s, v=pmd.v,
                mean=pmd.mean_img, std=pmd.var_img, order=pmd.order)


class Decomposition:
    """A decomposition's outputs on the device, in the reference's terms:
    the basis A (C-order pixels), C = diag(s) V, the statistics images."""

    def __init__(self, f: dict, shape, dev: torch.device):
        _, d1, d2 = shape
        self.a = ref_projection.spatial_basis(f["indptr"], f["indices"], f["data"], f["r"],
                                              f["order"], d1, d2, dev)
        self.c = (torch.as_tensor(np.asarray(f["s"], np.float64), device=dev)[:, None]
                  * torch.as_tensor(np.asarray(f["v"], np.float64), device=dev))
        self.mean = torch.as_tensor(np.asarray(f["mean"], np.float64), device=dev).reshape(-1)
        self.std = torch.as_tensor(np.asarray(f["std"], np.float64), device=dev).reshape(-1)


def reference_pass(decomps: list, chunk_of, shape, dev: torch.device,
                   precisions=("float64",)) -> dict:
    """One pass over the movie in its 1024-frame chunks: per precision, the
    statistics images and, per decomposition, the best coefficients C*."""
    t, d1, d2 = shape
    stats = {p: ref_stats.MovieStats(t, d1 * d2, dev, p) for p in precisions}
    projs = {p: [ref_projection.Projection(dc.a, dc.mean, dc.std, t, p) for dc in decomps]
             for p in precisions}
    for start in range(0, t, ref_stats.CHUNK_FRAMES):
        x = chunk_of(start, min(start + ref_stats.CHUNK_FRAMES, t)).reshape(-1, d1 * d2)
        for p in precisions:
            stats[p].add(start, x)
            for pr in projs[p]:
                pr.add(start, x)
        del x
    return {p: dict(zip(("mean", "noise"), stats[p].result()),
                    best=[pr.solve() for pr in projs[p]],
                    proj=[pr.projection() for pr in projs[p]]) for p in precisions}


def decomposition_numbers(decomps: list, ref: dict, footprints, outputs=None) -> dict:
    """The worst, over the decompositions, of: the mean image's gap to the
    reference in noise sigmas, the noise image's relative gap, the
    reconstruction's gap to the best in its basis, the temporal
    coefficients' gap to the projection of the movie on the basis, each
    over the frames, and the share of a source's footprint (``footprints``,
    ``Movie.footprints``) that the basis leaves out, over the sources.
    ``outputs`` (mean, noise, C per decomposition) stand in for the
    decompositions' own, as the control's do."""
    mean_ref = ref["mean"].to(torch.float64)
    noise_ref = ref["noise"].to(torch.float64)
    out = dict(mean_gap=0.0, noise_gap=0.0, recon_gap=0.0, vreg_gap=0.0, source_gap=0.0)
    for k, dc in enumerate(decomps):
        mean, noise, c = outputs[k] if outputs is not None else (dc.mean, dc.std, dc.c)
        out["mean_gap"] = max(out["mean_gap"], float(
            ((mean.to(torch.float64) - mean_ref).abs() / noise_ref).max()))
        out["noise_gap"] = max(out["noise_gap"], float(
            ((noise.to(torch.float64) - noise_ref).abs() / noise_ref).max()))
        out["recon_gap"] = max(out["recon_gap"], float(
            ref_projection.frame_gaps(dc.a, ref["best"][k], c).max()))
        out["vreg_gap"] = max(out["vreg_gap"], float(
            ref_projection.coefficient_gaps(ref["proj"][k], c).max()))
        out["source_gap"] = max(out["source_gap"], float(
            ref_sources.source_gaps(dc.a, noise, footprints).max()))
    return out


def _chunks_from(source, movie: Movie, dev: torch.device):
    if source is None:
        return movie.frames
    if isinstance(source, np.ndarray):
        return lambda a, b: torch.from_numpy(source[a:b]).to(dev)
    return lambda a, b: source[a:b]


def _settings(cfg: dict):
    settings = dict(cfg["settings"])
    return tuple(settings.pop("block_sizes")), settings


class CellRun:
    """State of one run of one cell."""

    def __init__(self, bench: dict, cell_name: str, seed: int, seconds: float, traced: bool,
                 dev: torch.device, process_start: float, here: str = catalog.HERE,
                 root: str = catalog.ROOT):
        self.bench = bench
        self.cell = catalog.cell(bench, cell_name)
        self.cfg = catalog.config(bench, self.cell["config"], root)
        self.mix = catalog.traffic(self.cell["traffic"], here)
        self.limits = catalog.limits(cell_name, here)
        self.here = here
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = traced
        self.dev = dev
        self.process_start = process_start
        self.rec: dict = dict(cell=self.cell, config=self.cfg, traffic=self.mix,
                              seconds=self.seconds, trace=traced, peaks=catalog.peaks(here),
                              setup_parts={})
        self.port = None

    # -- set-up ----------------------------------------------------------------

    def _part(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.rec["setup_parts"][name] = now - t0
        return now

    def _movie(self) -> Movie:
        movie = Movie(self.cfg["movie"], self.seed, self.dev)
        t, d1, d2 = movie.shape
        self.rec["movie"] = dict(shape=movie.shape, dtype=self.cfg["movie"]["dtype"],
                                 nbytes=movie.nbytes, pixel_frames=t * d1 * d2)
        return movie

    def _call(self, dataset):
        block_sizes, settings = _settings(self.cfg)
        pmd = self.port.localmd_decomposition(dataset, block_sizes, device=self.dev, **settings)
        _sync(self.dev)
        return pmd

    def run(self) -> dict:
        t0 = time.perf_counter()
        info = import_port(self.dev)
        import localmd_tpu_torch

        self.port = localmd_tpu_torch
        self.rec["setup_parts"].update(info)
        log(f"port imported in {info['import_s']:.3f} s" + (
            f"; kernels {'built here' if info.get('built_here') else 'loaded'} in "
            f"{info['library_s']:.3f} s (build {info['build_s']:.3f} s)"
            if "library_s" in info else ""))
        self._part("port", t0)
        kind = self.mix["kind"]
        if kind == "decompose":
            result = self._decompose()
        elif kind == "view":
            result = self._view()
        else:
            raise ValueError(f"unknown traffic kind {kind!r}")
        return result

    def _window_start(self) -> float:
        now = time.perf_counter()
        self.rec["setup_s"] = now - self.process_start
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        log("set-up " + ", ".join(f"{k} {v:.3f}" for k, v in self.rec["setup_parts"].items()
                                  if isinstance(v, float)) + f"; setup_s {self.rec['setup_s']:.3f}")
        return time.perf_counter()

    def _peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.dev)) if self.dev.type == "cuda" else 0

    # -- decompose -------------------------------------------------------------

    def _decompose(self) -> dict:
        t0 = time.perf_counter()
        movie = self._movie()
        on_host = self.mix["movie_on"] == "host"
        source = movie.to_host() if on_host else movie.to_card()
        _sync(self.dev)
        t0 = self._part("movie", t0)

        def fresh():
            return traffic.host_movie(source) if on_host else source.view(source.shape)

        def complete(ds) -> bool:
            return not on_host or ds.bytes_read >= movie.nbytes

        ds = fresh()
        with _profiled(self.traced, self.dev) as prof:
            c0 = time.perf_counter()
            pmd = self._call(ds)
            first = time.perf_counter() - c0
        if prof is not None:
            self.rec["first_profile"] = trace.read_profile(prof, first)
        first_ok = complete(ds)
        del pmd, ds
        gc.collect()
        self._part("first_call", t0)

        keep = window.Reservoir(int(self.mix["sample"]), self.seed)
        calls = []
        self._window_start()
        with _profiled(self.traced, self.dev) as prof:
            w0 = time.perf_counter()
            while True:
                ds = fresh()
                c0 = time.perf_counter()
                pmd = self._call(ds)
                c1 = time.perf_counter()
                calls.append(dict(wall_s=c1 - c0, timings=dict(pmd.pipeline_timings),
                                  ranks=dict(pmd.pipeline_ranks), cache=dict(pmd.pipeline_cache),
                                  bytes_read=getattr(ds, "bytes_read", None),
                                  complete=complete(ds)))
                keep.offer(pmd)
                del pmd, ds
                if c1 - w0 >= self.seconds:
                    break
            w1 = time.perf_counter()
        self.rec.update(window_s=w1 - w0, calls=calls, memory_peak_bytes=self._peak())
        if prof is not None:
            self.rec["profile"] = trace.read_profile(prof, w1 - w0)
            del prof
        failed = sum(not c["complete"] for c in calls) + (not first_ok)
        log(f"{len(calls)} calls in {w1 - w0:.3f} s; stages (median s): " + ", ".join(
            f"{k} {np.median([c['timings'][k] for c in calls]):.4f}" for k in calls[0]["timings"]))
        log("call walls (s): " + ", ".join(f"{c['wall_s']:.4f}" for c in calls))
        log(f"ranks {calls[-1]['ranks']}; cache {calls[-1]['cache']}")

        r0 = time.perf_counter()
        outs = [factors(p) for p in keep.items]
        keep.items.clear()
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        decomps = [Decomposition(f, movie.shape, self.dev) for f in outs]
        ref = reference_pass(decomps, _chunks_from(source, movie, self.dev), movie.shape,
                             self.dev)["float64"]
        numbers = decomposition_numbers(decomps, ref, movie.footprints())
        log(f"reference {time.perf_counter() - r0:.3f} s over {len(decomps)} sampled calls")
        return self._result(numbers, attempted=len(calls) + 1, failed=failed)

    # -- view ------------------------------------------------------------------

    def _view(self) -> dict:
        t0 = time.perf_counter()
        movie = self._movie()
        source = movie.to_card()
        _sync(self.dev)
        t0 = self._part("movie", t0)
        pmd = self._call(source)
        del source
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = self._part("decomposition", t0)
        requests = traffic.view_requests(self.mix, movie.shape, self.seed)
        for kind in sorted({r["kind"] for r in requests}):
            pmd[traffic.request_key(next(r for r in requests if r["kind"] == kind))]
        self._part("warm_requests", t0)

        keep = window.Reservoir(int(self.mix["sample"]), self.seed)
        served = []
        self._window_start()
        with _profiled(self.traced, self.dev) as prof:
            w0 = time.perf_counter()
            i = 0
            while True:
                req = requests[i % len(requests)]
                q0 = time.perf_counter()
                out = pmd[traffic.request_key(req)]
                q1 = time.perf_counter()
                served.append(dict(kind=req["kind"], latency_s=q1 - q0, pixel_frames=out.size))
                keep.offer((req, out))
                i += 1
                if q1 - w0 >= self.seconds:
                    break
            w1 = time.perf_counter()
        self.rec.update(window_s=w1 - w0, requests=served, memory_peak_bytes=self._peak())
        if prof is not None:
            self.rec["profile"] = trace.read_profile(prof, w1 - w0)
            del prof
        log(f"{len(served)} requests in {w1 - w0:.3f} s")

        r0 = time.perf_counter()
        dc = Decomposition(factors(pmd), movie.shape, self.dev)
        del pmd
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        d2 = movie.shape[2]
        gaps = [ref_frames.gap(torch.as_tensor(out, device=self.dev), ref_frames.served(
            dc.a, dc.c, dc.mean, dc.std, d2, req), dc.mean, d2, req) for req, out in keep.items]
        ref = reference_pass([dc], _chunks_from(None, movie, self.dev), movie.shape,
                             self.dev)["float64"]
        numbers = decomposition_numbers([dc], ref, movie.footprints())
        numbers["view_gap"] = max(gaps)
        log(f"reference {time.perf_counter() - r0:.3f} s over {len(gaps)} sampled requests "
            "and the set-up's decomposition")
        return self._result(numbers, attempted=len(served), failed=0)

    # -- result ------------------------------------------------------------------

    def _result(self, numbers: dict, attempted: int, failed: int) -> dict:
        log("numbers: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()))
        checks = {name: dict(value=float(numbers[name]), limit=float(limit))
                  for name, limit in self.limits.items()}
        correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
        section = "per_layer" if self.traced else "end_to_end"
        metrics = {}
        for m in catalog.metrics_of(self.bench, self.cell["name"], section):
            value = catalog.reader(m["name"], self.here)(self.rec)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        device = dict(
            platform="gpu" if self.dev.type == "cuda" else self.dev.type,
            kind=torch.cuda.get_device_name(self.dev) if self.dev.type == "cuda" else "cpu",
            count=1, memory_peak_bytes=self.rec["memory_peak_bytes"])
        result = dict(correct=bool(correct), attempted=int(attempted), failed=int(failed),
                      metrics=metrics, device=device)
        if self.traced:
            prof = self.rec["profile"]
            device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            result["breakdown"] = dict(device_ops=prof["top_device_ops"],
                                       idle_gaps=prof["idle_gaps"])
        result["checks"] = checks
        return result
