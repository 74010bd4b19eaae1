"""K2 (the V projection kernel) against its roofline, in %: per call, the
larger of the movie read once in the stream dtype, the projector read once
per K2 launch and V written once at the card's published HBM rate, and the
product's 2 t d r' operations at its published TF32 rate, summed over the
window's calls, over the device time of K2's kernels (the product, the
split-sum reduction and the projector's transpose) in the traced window.
The width r', the frames and the launches come from each call's
``vreg.k2_width``, ``vreg.k2_frames`` and ``vreg.k2_calls``; a call without
them (the cell route, or a program without the counters) gives no value."""

from pmdbench import rooflines_k2, trace

# K2's device functions (localmd_tpu_torch/csrc/v_projection.cu, .cuh)
K2_NAMES = ("vproj_wgmma_kernel", "vproj_reduce_kernel", "projector_t_kernel")


def read(run):
    prof, calls = run.get("profile"), run.get("calls")
    if not prof or not calls or any("vreg.k2_width" not in c["cache"] for c in calls):
        return None
    seconds = trace.device_seconds(prof, K2_NAMES)
    if seconds <= 0:
        return None
    _, d1, d2 = run["movie"]["shape"]
    bound = sum(rooflines_k2.k2_seconds(c["cache"]["vreg.k2_frames"], d1 * d2,
                                        c["cache"]["vreg.k2_width"], c["cache"]["stream_dtype"],
                                        run["peaks"], c["cache"]["vreg.k2_calls"])
                for c in calls)
    return 100.0 * bound / seconds
