"""The reference's ``diagnostic_plots`` names over :mod:`localmd_tpu_torch.diagnostics`
(counterpart of localmd_tpu/diagnostic_plots.py): the streamed QC images,
whose sources may be files, tensors or a ``PMDArray``, the matplotlib
figures and the one-sweep :func:`compute_qc_images`."""

from localmd_tpu_torch.diagnostics import (
    compute_qc_images,
    construct_index,
    make_autocorrelation_image,
    make_correlation_image,
    make_pmd_component_graph,
    make_pmd_corr_diagnostic_plot,
    make_pmd_correlation_image,
    make_residual_correlation_image,
    plot_pmd_components,
)

__all__ = [
    "make_pmd_corr_diagnostic_plot",
    "make_residual_correlation_image",
    "make_pmd_correlation_image",
    "make_correlation_image",
    "make_autocorrelation_image",
    "make_pmd_component_graph",
    "plot_pmd_components",
    "construct_index",
    "compute_qc_images",
]
