"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.

Dense rates without sparsity, from NVIDIA's data sheet, at the card's
full power limit (700 W for the SXM part); a card set
below it runs slower under load, so every reading is written with the
card's power limit beside it. ``float32`` is the rate outside the tensor
cores: the configurations state float32 with TF32 off.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "flops": {"float32": 67e12},
        "bytes_s": 3.35e12,
    },
}


def lookup(kind: str) -> dict | None:
    """The peaks of the card named ``kind``, or None for a card not in
    the table (its shares are then not reported)."""
    return PEAKS.get(kind)
