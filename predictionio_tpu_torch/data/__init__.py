"""Data layer: the event model, property aggregation, the event store
and the storage that training reads and deploy writes (counterpart of
``predictionio_tpu/data``)."""

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
