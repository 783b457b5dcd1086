from . import background

__all__ = ["background"]
