"""Data layer: the event model, the event store and the storage that
training reads and deploy writes (counterpart of
``predictionio_tpu/data``; property aggregation waits for the templates
that use it)."""

from predictionio_tpu_torch.data.datamap import DataMap, PropertyMap
from predictionio_tpu_torch.data.event import (
    Event,
    EventValidationError,
    validate_event,
)

__all__ = [
    "DataMap",
    "PropertyMap",
    "Event",
    "EventValidationError",
    "validate_event",
]
