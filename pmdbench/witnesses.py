#!/usr/bin/env python3
"""Witnesses for the levels a decomposition cell's check reads, at the
cell's own size, in one process: why ``recon_gap`` and ``source_gap`` read
what they read, and whether a fault in the coset block stage's remainder
shows in any number.

    python3 pmdbench/witnesses.py --workload <cell> --seeds 11,12 [--out FILE]

Per seed, on the cell's movie held as its traffic holds it:

- ``program``: the cell's five numbers for the program as configured, and
  ``departure``, ||A^T A - I|| (spectral norm, float64) of its basis A.
  ``recon_gap`` compares A C with the least-squares fit A C* in the same
  basis; with C the projection A^T Y_std, A C - A C* ~ A E C* for
  E = A^T A - I, so ``recon_gap`` <~ ``departure``;
- ``gram``: the factorized SVD's Gram right^T (U^T U) right formed by the
  program in float32 (the route it took) against the same Gram in float64
  (U as a float64 sparse matrix): ``rel_err``, ||G32 - G64|| / ||G64||;
  ``spread``, the largest kept eigenvalue over the smallest; and the
  departure from orthonormal columns of the whitened basis U P, P from the
  top eigenpairs as the program cuts them, for the float32 Gram with its
  float32 eigendecomposition (``departure_f32``), the float32 Gram with a
  float64 one (``departure_f32_gram``) and the float64 Gram
  (``departure_f64``), each measured against the float64 Gram;
- ``fsvd_f64``: the program with that float64 projector in place of its
  own (rounded to float32 on return; everything else as configured);
- ``canvas`` (only where the program took the banded Gram): the program
  with ``blocksparse.BANDED_GRAM`` off, the canvas Gram Z^T Z;
- ``drop_remainder``: the program with the coset stage's gathered batch of
  blocks on no lattice returning no component (only where it has one);
- ``best_basis``: ``source_gap`` of the best basis of the same rank, the
  top left singular vectors of Y_std in float64 (a randomized SVD with
  power iterations), against the program's.

Each variant's ``numbers`` are the cell's five against the float64
reference; ``fsvd_s`` is each call's ``factorized_svd`` stage. The
benchmark's runs do not run this script.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def sparse_u64(u):
    """The port's ``BlockSparseMatrix`` U as a float64 (pixels, R) torch
    sparse matrix (its blocks) and its dense background columns."""
    import torch

    nb, p, slots = u.panels.shape
    cols = (torch.arange(nb, device=u.rows.device)[:, None, None] * slots
            + torch.arange(slots, device=u.rows.device)[None, None, :]).expand(nb, p, slots)
    rows = u.rows[:, :, None].expand(nb, p, slots)
    idx = torch.stack([rows.reshape(-1), cols.reshape(-1)]).to(torch.int64)
    blocks = torch.sparse_coo_tensor(idx, u.panels.reshape(-1).to(torch.float64),
                                     (u.n_pixels, u.n_block_cols)).coalesce().to_sparse_csr()
    return blocks, u.dense_basis.to(torch.float64)


def u64_matmul(u64, x):
    blocks, dense = u64
    nb = blocks.shape[1]
    out = blocks @ x[:nb]
    if dense.shape[1]:
        out.addmm_(dense, x[nb:])
    return out


def whiten(gram, k, eigh):
    """The (m, k) matrix W = V_k diag(lambda_k)^-1/2 of the factorized SVD's
    top eigenpairs (``eigh`` gives them descending), zero where lambda is
    below 1e-6 of the largest (the program's cut), and the kept spread
    lambda_1 / lambda_min."""
    import torch

    vals, vecs = eigh(gram)
    vals_k = vals[:k]
    keep = vals_k > vals[0].clamp_min(0) * 1e-6
    inv = torch.where(keep, 1.0 / vals_k.clamp_min(1e-300).sqrt(), torch.zeros_like(vals_k))
    return vecs[:, :k] * inv[None, :], float(vals[0] / vals_k[keep][-1])


def departure(w, gram64):
    """||W^T G W - I|| over W's nonzero columns, in float64."""
    import torch

    w = w.to(torch.float64)
    w = w[:, w.abs().sum(dim=0) > 0]
    g = w.T @ gram64 @ w
    return float(torch.linalg.matrix_norm(g - torch.eye(g.shape[0], dtype=g.dtype,
                                                         device=g.device), 2))


def basis_departure(a):
    import torch

    a = a[:, a.abs().sum(dim=0) > 0]
    g = a.T @ a
    return float(torch.linalg.matrix_norm(g - torch.eye(g.shape[0], dtype=g.dtype,
                                                         device=g.device), 2))


class Capture:
    """Wraps the pipeline's ``compute_lowrank_factorized_svd``: keeps its U,
    its right-hand matrix and its expected rank, and with ``f64`` returns
    the projector computed from the float64 Gram instead."""

    def __init__(self, f64: bool = False):
        self.f64, self.seen = f64, None

    @contextlib.contextmanager
    def active(self):
        from localmd_tpu_torch import pipeline

        saved = pipeline.compute_lowrank_factorized_svd

        def run(u, v, only_left=False, expected_rank=None, **kwargs):
            self.seen = (u, v, expected_rank)
            if not self.f64:
                return saved(u, v, only_left=only_left, expected_rank=expected_rank, **kwargs)
            right, gram64 = gram_f64(u, v)
            w, _ = whiten(gram64, min(int(expected_rank), gram64.shape[0]), _eigh64)
            return (right.to(gram64.dtype) @ w).to(v.dtype)

        pipeline.compute_lowrank_factorized_svd = run
        try:
            yield self
        finally:
            pipeline.compute_lowrank_factorized_svd = saved


def _right(u, v):
    import torch

    r_cols = u.shape[1]
    return v if r_cols > v.shape[1] else torch.eye(r_cols, dtype=v.dtype, device=v.device)


def _eigh64(g):
    import torch

    vals, vecs = torch.linalg.eigh(g.to(torch.float64))
    return vals.flip(0), vecs.flip(1)


def gram_f64(u, v):
    import torch

    right = _right(u, v)
    z = u64_matmul(sparse_u64(u), right.to(torch.float64))
    gram = z.T @ z
    del z
    return right, 0.5 * (gram + gram.T)


def gram_witness(u, v, expected_rank) -> dict:
    import torch

    from localmd_tpu_torch.ops.linalg import eigh_descending

    u64 = sparse_u64(u)
    x = torch.randn(u.shape[1], 3, dtype=torch.float32, device=v.device)
    exact = u64_matmul(u64, x.to(torch.float64))
    product_gap = float((u.matmul(x).to(torch.float64) - exact).norm() / exact.norm())
    del u64
    right, g64 = gram_f64(u, v)
    g32 = u.gram_quadratic(right)
    k = min(int(expected_rank), g64.shape[0])
    w32, _ = whiten(g32, k, eigh_descending)
    w32_64, _ = whiten(g32, k, _eigh64)
    w64, spread64 = whiten(g64, k, _eigh64)
    return dict(m=int(g64.shape[0]), k=k, product_gap=product_gap,
                rel_err=float(torch.linalg.matrix_norm(g32.to(torch.float64) - g64, 2)
                              / torch.linalg.matrix_norm(g64, 2)),
                spread=spread64, departure_f32=departure(w32, g64),
                departure_f32_gram=departure(w32_64, g64), departure_f64=departure(w64, g64))


@contextlib.contextmanager
def drop_remainder():
    """The coset stage's gathered batch of blocks on no lattice (the
    pipeline's ``window0_chunk_step`` when the coset stage ran) keeps no
    component."""
    from localmd_tpu_torch import pipeline

    saved = pipeline.window0_chunk_step

    def run(*args, **kwargs):
        acc, counts, v_fit, *rest = saved(*args, **kwargs)
        return (acc * 0, counts * 0, v_fit * 0, *rest)

    pipeline.window0_chunk_step = run
    try:
        yield
    finally:
        pipeline.window0_chunk_step = saved


# the randomized SVD's power iterations and extra columns
POWER, OVERSAMPLE = 2, 16


def best_basis(chunk_of, shape, mean, std, k, dev, seed):
    """(pixels, k) float64 orthonormal basis of the top k left singular
    vectors of Y_std (pixels by frames), by a randomized SVD that streams
    the movie in 1024-frame chunks."""
    import torch

    from pmdbench.reference.stats import CHUNK_FRAMES

    t, d1, d2 = shape
    d, l = d1 * d2, k + OVERSAMPLE
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 62))

    def frames(start, stop):
        y = chunk_of(start, stop).reshape(-1, d).to(torch.float64)
        return (y - mean) / std

    def times(b):
        """Y_std (d, t) @ b (t, l)."""
        out = torch.zeros((d, b.shape[1]), dtype=torch.float64, device=dev)
        for s in range(0, t, CHUNK_FRAMES):
            e = min(s + CHUNK_FRAMES, t)
            out += frames(s, e).T @ b[s:e]
        return out

    def t_times(q):
        """Y_std^T (t, d) @ q (d, l)."""
        out = torch.empty((t, q.shape[1]), dtype=torch.float64, device=dev)
        for s in range(0, t, CHUNK_FRAMES):
            e = min(s + CHUNK_FRAMES, t)
            out[s:e] = frames(s, e) @ q
        return out

    q = torch.linalg.qr(times(torch.randn(t, l, dtype=torch.float64, device=dev,
                                          generator=gen)))[0]
    for _ in range(POWER):
        q = torch.linalg.qr(times(torch.linalg.qr(t_times(q))[0]))[0]
    _, _, vh = torch.linalg.svd(t_times(q), full_matrices=False)
    return q @ vh[:k].T


def witnesses(cell_name: str, seed: int, dev, root: str = ROOT, bench=None) -> dict:
    import torch

    from localmd_tpu_torch import blocksparse
    from pmdbench import catalog, harness, traffic
    from pmdbench.reference import sources as ref_sources

    bench = bench or catalog.load_benchmark(root)
    run = harness.CellRun(bench, cell_name, seed, 0.0, False, dev, time.perf_counter(),
                          here=os.path.join(root, "pmdbench"), root=root)
    harness.import_port(dev)
    import localmd_tpu_torch

    run.port = localmd_tpu_torch
    movie = run._movie()
    on_host = run.mix.get("movie_on") == "host"
    source = movie.to_host() if on_host else movie.to_card()

    def fresh():
        return traffic.host_movie(source) if on_host else source.view(source.shape)

    out = dict(cell=cell_name, seed=seed)
    pmds = {}
    with Capture().active() as cap:
        pmds["program"] = run._call(fresh())
    cache = pmds["program"].pipeline_cache
    out["counters"] = {k: cache.get(k) for k in ("fsvd.banded", "blocks.remainder",
                                                 "vreg.k2_calls", "vreg.k2_width")}
    out["gram"] = gram_witness(*cap.seen)
    cap.seen = None
    with Capture(f64=True).active():
        pmds["fsvd_f64"] = run._call(fresh())
    if cache.get("fsvd.banded"):
        saved = blocksparse.BANDED_GRAM
        blocksparse.BANDED_GRAM = False
        try:
            pmds["canvas"] = run._call(fresh())
        finally:
            blocksparse.BANDED_GRAM = saved
    if cache.get("blocks.remainder"):
        with drop_remainder():
            pmds["drop_remainder"] = run._call(fresh())
    names = list(pmds)
    dcs = [harness.Decomposition(harness.factors(pmds[n]), movie.shape, dev) for n in names]
    out["ranks"] = {n: int((pmds[n].s > 0).sum()) for n in names}
    out["fsvd_s"] = {n: pmds[n].pipeline_timings["factorized_svd"] for n in names}
    del pmds
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    chunk_of = harness._chunks_from(source, movie, dev)
    ref = harness.reference_pass(dcs, chunk_of, movie.shape, dev)["float64"]
    footprints = movie.footprints()
    for k, n in enumerate(names):
        one = dict(mean=ref["mean"], noise=ref["noise"], best=[ref["best"][k]],
                   proj=[ref["proj"][k]])
        out[n] = dict(numbers=harness.decomposition_numbers([dcs[k]], one, footprints),
                      departure=basis_departure(dcs[k].a))
    rank = out["ranks"]["program"]
    del dcs, ref["best"], ref["proj"]
    gc.collect()
    q = best_basis(chunk_of, movie.shape, ref["mean"].to(torch.float64).reshape(-1),
                   ref["noise"].to(torch.float64).reshape(-1), rank, dev, seed)
    out["best_basis"] = dict(rank=rank, source_gap=float(ref_sources.source_gaps(
        q, ref["noise"], footprints).max()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("witnesses: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = witnesses(args.workload, seed, dev)
        rec["seconds"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
