"""Engine templates. Importing this package registers them."""

from predictionio_tpu_torch.models import (  # noqa: F401
    recommendation,
    similarproduct,
)
