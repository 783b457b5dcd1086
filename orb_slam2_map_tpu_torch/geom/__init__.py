from . import se3, camera
from .camera import PinholeCamera

__all__ = ["se3", "camera", "PinholeCamera"]
