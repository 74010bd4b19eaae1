"""Quality-control diagnostics: correlation images and the component browser
(counterpart of localmd_tpu/diagnostics.py).

- ``make_correlation_image``: per-pixel max/mean correlation with the 8
  spatial neighbours.
- ``make_autocorrelation_image``: per-pixel lag-k autocorrelation.
- ``make_pmd_correlation_image`` / ``make_residual_correlation_image``:
  neighbour covariance of the PMD reconstruction / the residual, scaled by
  the raw movie's pixel variances.
- ``compute_qc_images``: all four from one sweep.
- ``make_pmd_corr_diagnostic_plot``, ``make_pmd_component_graph``,
  ``plot_pmd_components`` and ``construct_index``: matplotlib figures and a
  per-component HTML browser.

Every image is a streamed accumulation over frame chunks: per-pixel sums,
squared sums and the 8 shifted cross-products (``torch.roll``, the wrapped
positions masked at the end by ``_valid_mask``) add up chunk by chunk, each
relative to one reference image (the first chunk's mean), so memory holds
one chunk and a dozen images. Each chunk is moved to ``device`` once; a
``PMDArray`` source is reconstructed on its own device chunk by chunk (K3
for a pipeline result). The JAX package's quirks stay: the covariance uses
ddof 1, the variance scaling ddof 0, and "max" is floored at 0. The image
functions run on the card unless ``device="cpu"`` is passed (they raise
without CUDA) and return numpy images.

The renderers import matplotlib inside the function (the machine with the
card has none); the JAX package's plotly branch is not ported.
"""

from __future__ import annotations

import base64
import io
import os
import re

import numpy as np
import torch

from localmd_tpu_torch.config import resolve_device
from localmd_tpu_torch.dataset import as_dataset, read_frames_f32
from localmd_tpu_torch.pmd_array import PMDArray

# the 8 spatial neighbour offsets
_SHIFTS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
DEFAULT_CHUNK_FRAMES = 1024


def _valid_mask(d1: int, d2: int, dy: int, dx: int, device) -> torch.Tensor:
    """Pixels whose (dy, dx) neighbour exists (``torch.roll`` wraps; wrapped
    positions are masked out at the end)."""
    yy = torch.arange(d1, device=device)[:, None]
    xx = torch.arange(d2, device=device)[None, :]
    return (yy - dy >= 0) & (yy - dy < d1) & (xx - dx >= 0) & (xx - dx < d2)


def _neighbor_reduce(products, valids, mode: str) -> torch.Tensor:
    """Combine the 8 (d1, d2) neighbour statistics into one image."""
    stacked = torch.stack(products)
    masks = torch.stack(valids)
    if mode == "mean":
        return (stacked * masks).sum(dim=0) / masks.sum(dim=0)
    if mode == "max":
        # the reference's accumulator starts at 0: negative values floor at 0
        return torch.where(masks, stacked, 0.0).max(dim=0).values.clamp(min=0.0)
    raise ValueError(f"mode {mode} not supported")


def _as_source(movie):
    """A ``PMDArray`` as it is, anything else through ``as_dataset``: a
    numpy array, a tensor, a ``TensorMovie``/``DeviceMovie``, a dataset or
    a file path."""
    return movie if isinstance(movie, PMDArray) else as_dataset(movie)


def _load_frames(source, a: int, b: int, device: torch.device) -> torch.Tensor:
    """(b - a, d1, d2) float32 frames of an ``_as_source`` result on
    ``device``; a ``PMDArray`` is reconstructed on its own device first."""
    if isinstance(source, PMDArray):
        frames = source.reconstruct_frames(np.arange(a, b))
        return frames.to(device=device, dtype=torch.float32)
    return read_frames_f32(source, slice(a, b), device)


def _chunk_spans(t: int, chunk_frames: int):
    return [(a, min(a + chunk_frames, t)) for a in range(0, t, chunk_frames)]


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


# -- streamed moment accumulators ----------------------------------------------

def _add_crosses(y: torch.Tensor, acc: torch.Tensor) -> None:
    """Add the 8 shifted cross-product images of ``y`` (t, d1, d2) to ``acc``."""
    for i, shift in enumerate(_SHIFTS):
        acc[i] += (y * torch.roll(y, shift, dims=(1, 2))).sum(dim=0)


def _corr_finalize(s1, s2, cross, t: int, mode: str) -> torch.Tensor:
    d1, d2 = s1.shape
    m = s1 / t
    norm = torch.sqrt(torch.clamp(s2 - t * m * m, min=0.0))
    products, valids = [], []
    for i, (dy, dx) in enumerate(_SHIFTS):
        ms = torch.roll(m, (dy, dx), dims=(0, 1))
        norms = torch.roll(norm, (dy, dx), dims=(0, 1))
        products.append((cross[i] - t * m * ms) / (norm * norms))
        valids.append(_valid_mask(d1, d2, dy, dx, s1.device))
    return _neighbor_reduce(products, valids, mode)


def _autocorr_finalize(s1, s2, c, head, tail, n: int) -> torch.Tensor:
    sa1 = s1 - head.sum(dim=0)              # frames [lag, T)
    sa2 = s2 - (head * head).sum(dim=0)
    sb1 = s1 - tail.sum(dim=0)              # frames [0, T - lag)
    sb2 = s2 - (tail * tail).sum(dim=0)
    ma, mb = sa1 / n, sb1 / n
    na = torch.sqrt(torch.clamp(sa2 - n * ma * ma, min=0.0))
    nb = torch.sqrt(torch.clamp(sb2 - n * mb * mb, min=0.0))
    return (c - n * ma * mb) / (na * nb)


def _scaled_cov_finalize(s1_t, cross_t, s1_r, s2_r, t: int, mode: str) -> torch.Tensor:
    """Neighbour covariance of the target (ddof 1, ``np.cov``) scaled by the
    raw pixels' std products (ddof 0, ``np.var``)."""
    d1, d2 = s1_t.shape
    m_t = s1_t / t
    raw_std = torch.sqrt(torch.clamp(s2_r / t - (s1_r / t) ** 2, min=0.0))
    products, valids = [], []
    for i, (dy, dx) in enumerate(_SHIFTS):
        ms = torch.roll(m_t, (dy, dx), dims=(0, 1))
        rs = torch.roll(raw_std, (dy, dx), dims=(0, 1))
        cov = (cross_t[i] - t * m_t * ms) / (t - 1)
        products.append(cov / (raw_std * rs))
        valids.append(_valid_mask(d1, d2, dy, dx, s1_t.device))
    return _neighbor_reduce(products, valids, mode)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def make_correlation_image(movie, mode: str = "max", chunk_frames: int = DEFAULT_CHUNK_FRAMES,
                           device="cuda") -> np.ndarray:
    """Per-pixel neighbour correlation: (T, d1, d2) source -> (d1, d2),
    streamed in ``chunk_frames`` chunks."""
    dev = resolve_device(device)
    movie = _as_source(movie)
    t, d1, d2 = (int(x) for x in movie.shape)
    s1, s2, cross = _zeros((d1, d2), dev), _zeros((d1, d2), dev), _zeros((8, d1, d2), dev)
    ref = None
    for a, b in _chunk_spans(t, chunk_frames):
        chunk = _load_frames(movie, a, b, dev)
        if ref is None:
            ref = chunk.mean(dim=0)
        x = chunk - ref
        s1 += x.sum(dim=0)
        s2 += (x * x).sum(dim=0)
        _add_crosses(x, cross)
    return _host(_corr_finalize(s1, s2, cross, t, mode))


def make_autocorrelation_image(movie, lag: int = 1, chunk_frames: int = DEFAULT_CHUNK_FRAMES,
                               device="cuda") -> np.ndarray:
    """Per-pixel lag-``lag`` autocorrelation, corr(movie[lag:], movie[:-lag])
    with each side centred and normalized over its own frames. A
    ``lag``-frame tail carries over between chunks, so pairs across a chunk
    boundary count once."""
    dev = resolve_device(device)
    movie = _as_source(movie)
    t, d1, d2 = (int(x) for x in movie.shape)
    if t <= lag:
        raise ValueError(f"need more than lag={lag} frames, got {t}")
    chunk_frames = max(chunk_frames, 2 * lag)
    s1, s2, c = _zeros((d1, d2), dev), _zeros((d1, d2), dev), _zeros((d1, d2), dev)
    ref = head = tail = None
    for a, b in _chunk_spans(t, chunk_frames):
        chunk = _load_frames(movie, a, b, dev)
        if ref is None:
            ref = chunk.mean(dim=0)
            head = chunk[:lag] - ref
            ext, n_tail = chunk - ref, 0
        else:
            ext, n_tail = torch.cat([tail, chunk - ref], dim=0), lag
        x = ext[n_tail:]
        s1 += x.sum(dim=0)
        s2 += (x * x).sum(dim=0)
        c += (ext[:-lag] * ext[lag:]).sum(dim=0)
        tail = ext[-lag:]
    return _host(_autocorr_finalize(s1, s2, c, head, tail, t - lag))


def _streamed_scaled_cov(original_movie, pmd_movie, mode: str, chunk_frames: int,
                         residual: bool, device) -> np.ndarray:
    dev = resolve_device(device)
    original_movie, pmd_movie = _as_source(original_movie), _as_source(pmd_movie)
    t, d1, d2 = (int(x) for x in original_movie.shape)
    s1_t, cross_t = _zeros((d1, d2), dev), _zeros((8, d1, d2), dev)
    s1_r, s2_r = _zeros((d1, d2), dev), _zeros((d1, d2), dev)
    ref_t = ref_r = None
    for a, b in _chunk_spans(t, chunk_frames):
        raw = _load_frames(original_movie, a, b, dev)
        pmd = _load_frames(pmd_movie, a, b, dev)
        target = raw - pmd if residual else pmd
        if ref_t is None:
            ref_t, ref_r = target.mean(dim=0), raw.mean(dim=0)
        xt, xr = target - ref_t, raw - ref_r
        s1_t += xt.sum(dim=0)
        s1_r += xr.sum(dim=0)
        s2_r += (xr * xr).sum(dim=0)
        _add_crosses(xt, cross_t)
    return _host(_scaled_cov_finalize(s1_t, cross_t, s1_r, s2_r, t, mode))


def make_pmd_correlation_image(original_movie, pmd_movie, mode: str = "max",
                               chunk_frames: int = DEFAULT_CHUNK_FRAMES,
                               device="cuda") -> np.ndarray:
    """Neighbour covariance of the PMD reconstruction scaled by the raw
    variances. ``pmd_movie`` is a dense (T, d1, d2) source or a
    ``PMDArray``, reconstructed chunk by chunk."""
    return _streamed_scaled_cov(original_movie, pmd_movie, mode, chunk_frames, False, device)


def make_residual_correlation_image(original_movie, pmd_movie, mode: str = "max",
                                    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
                                    device="cuda") -> np.ndarray:
    """Neighbour covariance of (raw - PMD) scaled by the raw variances: a
    white residual gives a near-zero image (the QC pass)."""
    return _streamed_scaled_cov(original_movie, pmd_movie, mode, chunk_frames, True, device)


def compute_qc_images(original_movie, pmd_movie, mode: str = "max", lag: int = 1,
                      chunk_frames: int = DEFAULT_CHUNK_FRAMES, device="cuda") -> dict:
    """All four QC images from one sweep over the movie pair: one read and
    one reconstruction per chunk. Returns ``correlation``,
    ``autocorrelation``, ``pmd_cov`` and ``residual_cov``."""
    dev = resolve_device(device)
    original_movie, pmd_movie = _as_source(original_movie), _as_source(pmd_movie)
    t, d1, d2 = (int(x) for x in original_movie.shape)
    if t <= lag:
        raise ValueError(f"need more than lag={lag} frames, got {t}")
    chunk_frames = max(chunk_frames, 2 * lag)
    s1_r, s2_r, s1_p, s1_d, c_auto = (_zeros((d1, d2), dev) for _ in range(5))
    cr_r, cr_p, cr_d = (_zeros((8, d1, d2), dev) for _ in range(3))
    refs = head = tail = None
    for a, b in _chunk_spans(t, chunk_frames):
        raw = _load_frames(original_movie, a, b, dev)
        pmd = _load_frames(pmd_movie, a, b, dev)
        first = refs is None
        if first:
            refs = (raw.mean(dim=0), pmd.mean(dim=0), (raw - pmd).mean(dim=0))
            head = raw[:lag] - refs[0]
        x, p, d = raw - refs[0], pmd - refs[1], (raw - pmd) - refs[2]
        s1_r += x.sum(dim=0)
        s2_r += (x * x).sum(dim=0)
        _add_crosses(x, cr_r)
        s1_p += p.sum(dim=0)
        _add_crosses(p, cr_p)
        s1_d += d.sum(dim=0)
        _add_crosses(d, cr_d)
        ext = x if first else torch.cat([tail, x], dim=0)
        c_auto += (ext[:-lag] * ext[lag:]).sum(dim=0)
        tail = ext[-lag:]
    return {
        "correlation": _host(_corr_finalize(s1_r, s2_r, cr_r, t, mode)),
        "autocorrelation": _host(_autocorr_finalize(s1_r, s2_r, c_auto, head, tail, t - lag)),
        "pmd_cov": _host(_scaled_cov_finalize(s1_p, cr_p, s1_r, s2_r, t, mode)),
        "residual_cov": _host(_scaled_cov_finalize(s1_d, cr_d, s1_r, s2_r, t, mode)),
    }


# ---------------------------------------------------------------------------
# Figures (matplotlib, imported where it is used)
# ---------------------------------------------------------------------------

def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _mpl_fig_to_html(fig, title: str) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    data = base64.b64encode(buf.getvalue()).decode("ascii")
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title></head><body style='text-align:center'>"
        f"<h2>{title}</h2><img src='data:image/png;base64,{data}'/>"
        "</body></html>"
    )


def make_pmd_corr_diagnostic_plot(standard_correlation_image, autocorr_image, pmd_cov_image,
                                  residual_cov_image):
    """2x2 QC panel (raw corr / raw autocorr / PMD cov / residual cov) as a
    matplotlib figure."""
    images = [
        ("Raw Corr", standard_correlation_image),
        ("Raw Autocorr", autocorr_image),
        ("Scaled Cov(UV)", pmd_cov_image),
        ("Scaled Cov(Y - UV)", residual_cov_image),
    ]
    vmax = float(np.amax(standard_correlation_image))
    plt = _pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(10, 9))
    for ax, (name, img) in zip(axes.ravel(), images):
        im = ax.imshow(np.asarray(img), vmin=0, vmax=vmax, cmap="viridis")
        ax.set_title(name)
        ax.axis("off")
    fig.colorbar(im, ax=axes.ravel().tolist(), shrink=0.8)
    fig.suptitle("Corr Images (PMD Weighted ACF(1) Image)")
    return fig


def make_pmd_component_graph(spatial, mean_img, var_img, trace, index: int, title: str):
    """Per-component QC figure: mean / var / spatial images and the trace."""
    plt = _pyplot()
    fig = plt.figure(figsize=(12, 8))
    names = ["Mean", "Var Img", f"Spatial Comp {index}"]
    for i, (name, img) in enumerate(zip(names, [mean_img, var_img, spatial])):
        ax = fig.add_subplot(2, 3, i + 1)
        ax.imshow(np.asarray(img), cmap="viridis")
        ax.set_title(name)
        ax.axis("off")
    ax = fig.add_subplot(2, 1, 2)
    ax.plot(np.asarray(trace))
    ax.set_title(f"Temporal Comp {index}")
    fig.suptitle(title)
    return fig


def plot_pmd_components(pmd_movie, folder: str, filename_prefix: str = "Component",
                        max_components: int | None = None) -> None:
    """One HTML QC page per component into ``folder`` (which must exist),
    the top ``max_components`` by singular value (all by default)."""
    if not os.path.exists(folder):
        raise ValueError(f"folder {folder} does not exist; create it first")
    u, r, s, v = pmd_movie.u, pmd_movie.r, pmd_movie.s, pmd_movie.v
    _, d1, d2 = pmd_movie.shape
    total_var = np.sum(np.square(s))
    n_render = r.shape[1] if max_components is None else min(r.shape[1], max_components)
    plt = _pyplot()
    for i in range(n_render):
        comp = u.dot(r[:, i]).reshape((d1, d2), order=pmd_movie.order)
        explained = np.square(s[i]) / total_var
        title = f"Comp {i}, Var explained {explained:3f}"
        fig = make_pmd_component_graph(
            comp, pmd_movie.mean_img, pmd_movie.var_img, v[i, :], i + 1, title
        )
        with open(os.path.join(folder, f"{filename_prefix}_{i}.html"), "w") as f:
            f.write(_mpl_fig_to_html(fig, title))
        plt.close(fig)


def construct_index(folder: str, file_prefix: str = "Component",
                    index_name: str = "index.html") -> str:
    """A prev/next iframe browser over the per-component HTML pages; returns
    its path."""

    def numerical_sort(fname):
        match = re.search(rf"{file_prefix}[_\s]*(\d+)", fname)
        return int(match.group(1)) if match else float("inf")

    html_files = sorted(
        (f for f in os.listdir(folder) if f.endswith(".html") and f != index_name),
        key=numerical_sort,
    )
    files_js = ",\n            ".join(f"'{f}'" for f in html_files)
    index_path = os.path.join(folder, index_name)
    with open(index_path, "w") as f:
        f.write(f"""<!DOCTYPE html>
<html lang="en">
<head>
  <meta charset="UTF-8">
  <title>PMD Component Browser</title>
  <style>
    body {{ font-family: sans-serif; margin: 20px; text-align: center; }}
    button {{ padding: 10px 20px; margin: 5px; font-size: 16px; }}
  </style>
</head>
<body>
  <h1>PMD Components</h1>
  <div id="content"><iframe src="" style="width:100%;height:640px;border:none"></iframe></div>
  <div>
    <button id="prev-btn" onclick="navigate(-1)">Previous</button>
    <span id="label"></span>
    <button id="next-btn" onclick="navigate(1)">Next</button>
  </div>
  <script>
    const files = [
            {files_js}
    ];
    let idx = 0;
    function load() {{
      document.getElementById('content').innerHTML =
        `<iframe src="${{files[idx]}}" style="width:100%;height:640px;border:none"></iframe>`;
      document.getElementById('label').textContent = `${{idx + 1}} / ${{files.length}}`;
      document.getElementById('prev-btn').disabled = idx === 0;
      document.getElementById('next-btn').disabled = idx === files.length - 1;
    }}
    function navigate(d) {{
      idx = Math.min(Math.max(idx + d, 0), files.length - 1);
      load();
    }}
    load();
  </script>
</body>
</html>
""")
    return index_path
