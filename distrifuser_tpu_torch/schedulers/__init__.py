from .scheduling import (BaseScheduler, DDIMScheduler, DPMSolverMultistepScheduler,
                         EulerDiscreteScheduler, FlowMatchEulerScheduler, get_scheduler)

__all__ = ["BaseScheduler", "DDIMScheduler", "DPMSolverMultistepScheduler",
           "EulerDiscreteScheduler", "FlowMatchEulerScheduler", "get_scheduler"]
