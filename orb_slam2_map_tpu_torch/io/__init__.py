from . import evaluate, kitti, synthetic, trajectory

__all__ = ["evaluate", "kitti", "synthetic", "trajectory"]
