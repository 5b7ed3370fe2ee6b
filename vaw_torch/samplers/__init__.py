"""EDM sampler, classifier-free guidance and the generation driver."""

from .driver import Sampler
from .edm import ablation_sampler, build_edm_plan
from .guidance import IntervalCFG, cfg_scale_for_time

__all__ = ["Sampler", "ablation_sampler", "build_edm_plan", "IntervalCFG",
           "cfg_scale_for_time"]
