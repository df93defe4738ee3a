"""PyTorch/CUDA port of predictionio_tpu for one NVIDIA Hopper card.

Each module mirrors the path and public names of its counterpart in
``predictionio_tpu``; that package stays the reference the port's tests
hold it against. The port imports ``torch``, numpy and the standard
library, never ``jax`` and nothing of ``predictionio_tpu``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.

This slice serves the recommendation template: a published ALS
generation is deployed by :func:`core.workflow.load_deployment`, staged
by ``ALSAlgorithm.stage_model`` and answered by the engine server's
micro-batcher through the fused score + top-k kernel
(``csrc/fused_topk.cu``).
"""
