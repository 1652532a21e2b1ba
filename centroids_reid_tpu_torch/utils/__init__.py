from .preemption import PreemptionGuard
from .profiling import annotate, profile_trace
from .seeding import seed_everything

__all__ = ["PreemptionGuard", "annotate", "profile_trace", "seed_everything"]
