from . import evaluate, synthetic

__all__ = ["evaluate", "synthetic"]
