"""Device and host ops: pyramid kernels, predictors, quantizers, entropy.

The compute-path counterpart of the reference's pluggable math layer
(reference: src/interpolator.rs, src/quantizator.rs, src/utils.rs), plus
the entropy stages that back the containers.
"""

from . import entropy, predictors, pyramid, quantizers

__all__ = ["entropy", "predictors", "pyramid", "quantizers"]
