from . import se3, sim3, camera
from .camera import PinholeCamera

__all__ = ["se3", "sim3", "camera", "PinholeCamera"]
