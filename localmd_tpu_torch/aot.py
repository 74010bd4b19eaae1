"""What the JAX package's ``aot.py`` knows before the statistics pass,
without its warms (counterpart of localmd_tpu/aot.py).

``normalized_init_geometry`` gives the frame range, window length and
block sizes the pipeline will use, known before any frame is read; the
pipeline computes its own through it, so the two cannot drift.

The JAX package's stage warms (``StageWarmer``, ``plan_block_stage``,
``clear_warm_registry``) have no counterpart: no warm made a cold call on
an H100 shorter (PERF.md). On threads, the warms stalled the main
thread's first launches (the CUDA driver loads a kernel's module under a
lock); on the main thread, in the statistics pass's idle waits, the
threshold Monte-Carlo and a noise batch through the block stage left the
call, but the statistics pass grew by as much, and a movie on the card
has no wait to spend. ``aot_warm`` is accepted and changes nothing.
"""

from __future__ import annotations

from localmd_tpu_torch.ops.tiling import update_block_sizes


def normalized_init_geometry(shape, frame_range, window_chunks, block_sizes):
    """(frame_range, window_chunks, b1, b2) as the pipeline will use them,
    known before the statistics pass (aot.py:79-93): the frame range clamped
    to the movie, the window length (the frame range when None) clamped to
    it, the block sizes clamped to the field of view. None of it consumes
    random draws. Raises ValueError for blocks below the minimum size
    (``update_block_sizes``)."""
    t_total, d1, d2 = (int(x) for x in shape)
    fr = min(frame_range, t_total)
    wc = frame_range if window_chunks is None else window_chunks
    wc = min(wc, fr)
    b1, b2 = update_block_sizes(tuple(block_sizes), (d1, d2))
    return fr, wc, b1, b2
