from .elbo import LOG_2PI, elbo_terms, gaussian_nll, kl_to_standard_normal

__all__ = ["LOG_2PI", "elbo_terms", "gaussian_nll", "kl_to_standard_normal"]
