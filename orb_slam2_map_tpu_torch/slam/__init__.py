from . import (frame, local_mapping, mapping_kernels, mapstore, pipeline_step,
               search, system, tracking)
from .mapstore import MapStore
from .system import SLAMSystem, Sensor
from .tracking import Tracker, TrackingState

__all__ = [
    "frame", "local_mapping", "mapping_kernels", "mapstore", "pipeline_step",
    "search", "system", "tracking", "MapStore", "SLAMSystem", "Sensor",
    "Tracker", "TrackingState",
]
