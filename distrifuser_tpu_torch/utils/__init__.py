from .config import DistriConfig
from .env import resolve_device

__all__ = ["DistriConfig", "resolve_device"]
