"""Three-term roofline analysis (the counterpart of ``repro.roofline``)."""

from repro_torch.roofline.analysis import (
    RooflineTerms,
    collective_bytes,
    model_flops,
    roofline_from_trace,
)

__all__ = ["RooflineTerms", "collective_bytes", "model_flops",
           "roofline_from_trace"]
