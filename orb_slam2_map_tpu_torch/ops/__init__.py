from . import fast, matching, orb, pyramid

__all__ = ["fast", "matching", "orb", "pyramid"]
