from .trees import (
    correlation_ratio,
    correlation_ratio_per_param,
    sin_theta_distance,
    tree_sq_norm,
    tree_vdot,
)

__all__ = [
    "correlation_ratio",
    "correlation_ratio_per_param",
    "sin_theta_distance",
    "tree_sq_norm",
    "tree_vdot",
]
