"""End-to-end localmd_tpu_torch demo: the PyTorch port's counterpart of
demos/demo.py (the reference's official_demo.ipynb workflow) on one NVIDIA
GPU.

Generates a synthetic two-photon movie (or loads a TIFF you point it at),
runs the PMD decomposition, saves the compressed .npz and loads it back,
builds the QC images, renders the QC panel and the per-component HTML
browser, exports a denoised TIFF and releases the device factors. The last
line it prints is a JSON summary: rank, seconds, the residual-to-noise
ratio, the files written and the CUDA kernels each step launched.

Usage (from a checkout: ``PYTHONPATH=. python demos/demo_torch.py``):
    python demos/demo_torch.py [path/to/movie.tif] [output_dir]
        [--d1 128] [--d2 128] [--t 1500] [--device cuda] [--no-plots]

``--d1/--d2/--t`` size the synthetic movie (128 x 128 x 1500 with 40 cells
by default). Everything runs on the card unless ``--device cpu`` is given;
without CUDA the default raises. The QC panel and the component browser
need matplotlib; ``--no-plots`` skips those two renderings and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import localmd_tpu_torch
from localmd_tpu_torch import diagnostics, metrics, sim
from localmd_tpu_torch.ops import kernels


def _launched(before: dict) -> dict:
    """Kernel launches since the ``before`` snapshot of the counts."""
    return {name: n - before.get(name, 0) for name, n in kernels.launch_counts().items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("movie", nargs="?", default=None, help="a TIFF movie (default: a sim movie)")
    ap.add_argument("out_dir", nargs="?", default="demo_output")
    ap.add_argument("--d1", type=int, default=128)
    ap.add_argument("--d2", type=int, default=128)
    ap.add_argument("--t", type=int, default=1500)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-plots", action="store_true",
                    help="skip the QC panel and the component browser (they need matplotlib)")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    launches = {}

    # ---- 1. data ------------------------------------------------------------
    if args.movie:
        dataset = localmd_tpu_torch.TiffArray(args.movie)
        print(f"Loaded {args.movie}: shape {dataset.shape}")
    else:
        print(f"No input movie given - generating a synthetic two-photon movie "
              f"({args.d1} x {args.d2} x {args.t}) on {args.device}")
        dataset = sim.two_photon_movie(d1=args.d1, d2=args.d2, t=args.t, n_cells=40, seed=0,
                                       device=args.device)

    t_total = dataset.shape[0]

    # ---- 2. decomposition ----------------------------------------------------
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    pmd = localmd_tpu_torch.localmd_decomposition(
        dataset,
        block_sizes=(32, 32),
        frame_range=min(5000, t_total),
        max_components=20,
        background_rank=15,
        temporal_avg_factor=10,
        seed=0,
        device=args.device,
    )
    seconds = time.perf_counter() - t0
    launches["decomposition"] = _launched(before)
    print(f"Compressed to rank {pmd.rank}; shape {pmd.shape} in {seconds:.3f} s")

    # ---- 3. save the compressed representation and load it back -------------
    npz_path = os.path.join(args.out_dir, "decomposition.npz")
    pmd.to_npz(npz_path)
    loaded = localmd_tpu_torch.load_decomposition(npz_path, device=args.device)
    print(f"Saved {npz_path} ({os.path.getsize(npz_path) / 1e6:.1f} MB); loaded back at "
          f"rank {loaded.rank}")
    del loaded

    # ---- 4. QC diagnostics ----------------------------------------------------
    # one streaming sweep computes all four images: the raw source is the
    # dataset and the PMD side the PMDArray, reconstructed on the device
    # chunk by chunk
    before = kernels.launch_counts()
    qc = diagnostics.compute_qc_images(dataset, pmd, device=args.device)
    launches["qc_images"] = _launched(before)
    corr, autocorr = qc["correlation"], qc["autocorrelation"]
    pmd_cov, resid_cov = qc["pmd_cov"], qc["residual_cov"]
    if args.no_plots:
        print("--no-plots: skipped the QC panel and the component browser")
    else:
        fig = diagnostics.make_pmd_corr_diagnostic_plot(corr, autocorr, pmd_cov, resid_cov)
        panel_path = os.path.join(args.out_dir, "qc_panel.png")
        fig.savefig(panel_path, dpi=110)
        print(f"Wrote QC panel to {panel_path}")

        # ---- 5. per-component browser -----------------------------------------
        comp_dir = os.path.join(args.out_dir, "components")
        os.makedirs(comp_dir, exist_ok=True)
        diagnostics.plot_pmd_components(pmd, comp_dir, max_components=40)
        index = diagnostics.construct_index(comp_dir)
        print(f"Component browser: {index}")

    # ---- 6. denoised movie export, quality and cleanup -----------------------
    denoised_path = os.path.join(args.out_dir, "denoised.tif")
    n_export = min(500, t_total)
    before = kernels.launch_counts()
    pmd.export_tiff(denoised_path, frames=range(n_export), dtype="uint16")
    launches["export_tiff"] = _launched(before)
    print(f"Denoised movie: {denoised_path}")
    rnr = metrics.residual_noise_ratio(pmd, dataset, device=args.device)
    print(f"Residual-to-noise ratio {rnr:.4f} (1.0: the residual is the estimated noise)")
    summary = dict(rank=int(pmd.rank), shape=list(pmd.shape), seconds=seconds,
                   residual_noise_ratio=rnr, npz=npz_path, tiff=denoised_path,
                   plots=not args.no_plots, launches=launches)
    pmd.close()  # release device factors (host slicing keeps working)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
