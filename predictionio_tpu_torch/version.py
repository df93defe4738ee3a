"""The port's version: the ``version`` label of ``pio_build_info``
(counterpart of ``predictionio_tpu/version.py``)."""

__version__ = "0.1.0"
