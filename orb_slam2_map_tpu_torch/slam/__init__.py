from . import frame, mapstore, pipeline_step, search, tracking
from .mapstore import MapStore
from .tracking import Tracker, TrackingState

__all__ = [
    "frame", "mapstore", "pipeline_step", "search", "tracking",
    "MapStore", "Tracker", "TrackingState",
]
