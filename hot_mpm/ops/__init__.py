"""Numerics substrate and kernels: SVD, eigen, splines, transfers, sparse ops."""

from hot_mpm.ops.svd import svd, svd2, svd3, polar, eigh_sym  # noqa: F401
from hot_mpm.ops.bspline import (  # noqa: F401
    quadratic_bspline_weights,
    quadratic_kernel_1d,
)
