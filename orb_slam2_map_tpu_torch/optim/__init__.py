from . import pose_opt, residuals

__all__ = ["pose_opt", "residuals"]
