from .scheduling import BaseScheduler, DDIMScheduler, get_scheduler

__all__ = ["BaseScheduler", "DDIMScheduler", "get_scheduler"]
