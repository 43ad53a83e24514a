from .scheduling import (BaseScheduler, DDIMScheduler, DPMSolverMultistepScheduler,
                         EulerDiscreteScheduler, get_scheduler)

__all__ = ["BaseScheduler", "DDIMScheduler", "DPMSolverMultistepScheduler",
           "EulerDiscreteScheduler", "get_scheduler"]
