"""The port's ``pio``-style console (counterpart of
``predictionio_tpu/cli/``): ``python -m predictionio_tpu_torch.cli.main``
or the ``pio-tpu-torch`` script."""
