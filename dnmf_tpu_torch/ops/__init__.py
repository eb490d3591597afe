"""Plain PyTorch ops (quadratic deformation basis, analytic Gaussian
footprints, trilinear resampling, Jacobian regularizers, multiplicative
NMF updates, FFT registration primitives) and the hand-written kernels
(:mod:`dnmf_tpu_torch.ops.fused`)."""

from dnmf_tpu_torch.ops.basis import (
    identity_beta,
    quadratic_basis,
    quadratic_basis_points,
    voxel_grid,
    warp_points,
)
from dnmf_tpu_torch.ops.footprints import (
    evaluate_footprints,
    fused_reconstruction,
    gaussian_footprints,
    gaussian_weights,
)
from dnmf_tpu_torch.ops.gram_analytic import (
    analytic_gram_frame,
    analytic_grams,
    analytic_grams_tracked,
)
from dnmf_tpu_torch.ops.jacobian import log_det_jacobian, quadratic_jacobian
from dnmf_tpu_torch.ops.mu import (
    gram_lipschitz,
    mu_grams,
    mu_spatial_step,
    mu_temporal_step,
    nnls_temporal,
    run_mu_temporal,
)
from dnmf_tpu_torch.ops.resample import trilinear_resample

__all__ = [
    "identity_beta",
    "quadratic_basis",
    "quadratic_basis_points",
    "voxel_grid",
    "warp_points",
    "evaluate_footprints",
    "fused_reconstruction",
    "gaussian_footprints",
    "gaussian_weights",
    "analytic_gram_frame",
    "analytic_grams",
    "analytic_grams_tracked",
    "log_det_jacobian",
    "quadratic_jacobian",
    "gram_lipschitz",
    "mu_grams",
    "mu_spatial_step",
    "mu_temporal_step",
    "nnls_temporal",
    "run_mu_temporal",
    "trilinear_resample",
]
