from .elbo import (
    LOG_2PI,
    binary_cross_entropy,
    elbo_terms,
    fill_diagonal,
    gaussian_nll,
    kl_to_standard_normal,
)

__all__ = ["LOG_2PI", "binary_cross_entropy", "elbo_terms", "fill_diagonal",
           "gaussian_nll", "kl_to_standard_normal"]
