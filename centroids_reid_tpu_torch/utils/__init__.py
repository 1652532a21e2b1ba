from .preemption import PreemptionGuard
from .profiling import annotate, profile_trace, step_marker
from .seeding import seed_everything

__all__ = ["PreemptionGuard", "annotate", "profile_trace", "seed_everything",
           "step_marker"]
