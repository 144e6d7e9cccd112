"""Constitutive models and plasticity return maps."""

from hot_mpm.models.constitutive import (  # noqa: F401
    FixedCorotated,
    NeoHookean,
    StvkHencky,
    LinearCorotated,
    MODEL_REGISTRY,
    psi_from_F,
    first_piola,
    hessian_context,
    apply_hessian,
)
from hot_mpm.models.plasticity import (  # noqa: F401
    VonMisesHencky,
    SnowPlasticity,
    DruckerPrager,
    PLASTICITY_REGISTRY,
)
