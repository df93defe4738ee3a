"""Engine templates. Importing this package registers them, under the
JAX package's names, so the same ``examples/*/engine.json`` drives
both packages."""

from predictionio_tpu_torch.models import (  # noqa: F401
    classification,
    complementarypurchase,
    ecommerce,
    helloworld,
    leadscoring,
    recommendation,
    regression,
    similarproduct,
    textclassification,
)
