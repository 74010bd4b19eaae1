"""Command-line interface: compress a movie to a PMD .npz (counterpart of
localmd_tpu/cli.py:23-171).

Usage::

    python -m localmd_tpu_torch.cli compress movie.tif out.npz \
        --blocks 32 32 --frame-range 5000 --max-components 20

    python -m localmd_tpu_torch.cli info out.npz
    python -m localmd_tpu_torch.cli export out.npz recon.npy --frames 0 500

``compress`` and ``export`` run on the card unless ``--device cpu`` is
given, and raise without CUDA.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _add_compress(sub):
    p = sub.add_parser("compress", help="run the PMD decomposition on a movie")
    p.add_argument("input", help="movie path (.tif/.tiff/.npy) or raw binary")
    p.add_argument("output", help="output .npz path")
    p.add_argument("--blocks", nargs=2, type=int, default=[32, 32])
    p.add_argument("--frame-range", type=int, default=5000)
    p.add_argument("--max-components", type=int, default=20)
    p.add_argument("--background-rank", type=int, default=15)
    p.add_argument("--temporal-avg-factor", type=int, default=10)
    p.add_argument("--spatial-avg-factor", type=int, default=2)
    p.add_argument("--window-chunks", type=int, default=None)
    p.add_argument("--rank-prune", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--checkpoint", default=None, help="checkpoint path prefix")
    p.add_argument("--matmul-precision", default=None,
                   help="torch's fp32 matmul precision for the call: highest (default), "
                        "tensorfloat32/high or bfloat16/medium")
    p.add_argument("--raw-shape", nargs=3, type=int, default=None,
                   help="T d1 d2 for headerless raw binary input")
    p.add_argument("--raw-dtype", default="uint16")
    p.add_argument("--welch-compat", default="scipy",
                   choices=["scipy", "reference"],
                   help="noise-sigma semantics: documented scipy Welch or "
                        "strict reference-package parity")
    p.add_argument("--z-planes", type=int, default=None,
                   help="treat the movie as a plane-interleaved volumetric "
                        "stack with this many z-planes; decomposes each "
                        "plane and writes <output>_plane{z}.npz")
    p.add_argument("--no-cache-movie", action="store_true",
                   help="disable the device movie cache (default: auto)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _add_info(sub):
    p = sub.add_parser("info", help="describe a compressed .npz")
    p.add_argument("input")


def _add_export(sub):
    p = sub.add_parser("export", help="reconstruct frames to a .npy")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--frames", nargs=2, type=int, default=None,
                   help="start stop (default: all)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="localmd_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_compress(sub)
    _add_info(sub)
    _add_export(sub)
    args = parser.parse_args(argv)

    if args.cmd == "compress":
        import localmd_tpu_torch
        from localmd_tpu_torch.config import resolve_device

        # validate before any (possibly expensive) dataset construction
        if args.z_planes is not None and args.z_planes < 1:
            raise SystemExit(f"--z-planes must be >= 1, got {args.z_planes}")
        device = resolve_device(args.device)
        if args.raw_shape:
            dataset = localmd_tpu_torch.RawBinaryArray(
                args.input, tuple(args.raw_shape), dtype=args.raw_dtype
            )
        else:
            dataset = localmd_tpu_torch.as_dataset(args.input)
        kwargs = dict(
            frame_range=args.frame_range,
            max_components=args.max_components,
            background_rank=args.background_rank,
            temporal_avg_factor=args.temporal_avg_factor,
            spatial_avg_factor=args.spatial_avg_factor,
            window_chunks=args.window_chunks,
            rank_prune=args.rank_prune,
            seed=args.seed,
            checkpoint_path=args.checkpoint,
            matmul_precision=args.matmul_precision,
            welch_compat=args.welch_compat,
            cache_movie=False if args.no_cache_movie else "auto",
            device=device,
        )
        if args.z_planes:
            try:
                stack = localmd_tpu_torch.ZStackArray.from_interleaved(dataset, args.z_planes)
            except ValueError as e:
                raise SystemExit(str(e)) from e
            vol = localmd_tpu_torch.volumetric_decomposition(stack, tuple(args.blocks), **kwargs)
            prefix = args.output[: -len(".npz")] if args.output.endswith(".npz") else args.output
            paths = vol.save(prefix)
            print(json.dumps({
                "outputs": paths,
                "n_planes": vol.n_planes,
                "ranks": [p.rank for p in vol.planes],
                "shape": list(vol.shape),
            }))
            return
        pmd = localmd_tpu_torch.localmd_decomposition(dataset, tuple(args.blocks), **kwargs)
        pmd.to_npz(args.output)
        print(json.dumps({
            "output": args.output,
            "rank": pmd.rank,
            "shape": list(pmd.shape),
            "timings_s": getattr(pmd, "pipeline_timings", {}),
            "cache": getattr(pmd, "pipeline_cache", {}),
        }))
    elif args.cmd == "info":
        data = np.load(args.input, allow_pickle=True)
        u_shape = tuple(int(x) for x in data["U_shape"])
        print(json.dumps({
            "fov_shape": [int(x) for x in data["fov_shape"]],
            "fov_order": str(np.asarray(data["fov_order"])),
            "rank": int(data["s"].shape[0]),
            "frames": int(data["Vt"].shape[1]),
            "U_nnz": int(data["U_data"].shape[0]),
            "U_shape": list(u_shape),
            "compression_ratio": round(
                (u_shape[0] * data["Vt"].shape[1])
                / max(1, data["U_data"].shape[0] + data["R"].size
                      + data["s"].size + data["Vt"].size), 2),
        }))
    elif args.cmd == "export":
        from localmd_tpu_torch import PMDArray
        from localmd_tpu_torch.config import resolve_device

        device = resolve_device(args.device)
        pmd = PMDArray.from_npz(args.input, device=device)
        frames = list(range(*args.frames) if args.frames else range(pmd.shape[0]))
        # 512 frames at a time: the device holds one chunk, the host the result
        out = np.concatenate([pmd.reconstruct_frames(frames[s : s + 512]).cpu().numpy()
                              for s in range(0, len(frames), 512)], axis=0)
        np.save(args.output, out)
        print(json.dumps({"output": args.output, "shape": list(out.shape)}))


if __name__ == "__main__":
    main()
