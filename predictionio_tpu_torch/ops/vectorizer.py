"""BinaryVectorizer: (property, value) pairs → one-hot features.

A copy of ``predictionio_tpu/ops/vectorizer.py`` (the e2 library's
``BinaryVectorizer``), kept here because the port imports nothing of the
JAX package: learn an index over observed (field, value) string pairs,
then turn property maps into fixed-width binary vectors, the features
that feed naive Bayes and linear models.
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping

import numpy as np

from predictionio_tpu_torch.utils.bimap import BiMap


class BinaryVectorizer:
    def __init__(self, pairs: Iterable[tuple[str, str]]):
        keys = np.asarray(
            sorted({f"{field}\x00{value}" for field, value in pairs}),
            dtype=np.str_,
        )
        self._map = BiMap(keys)

    @staticmethod
    def from_property_maps(
        maps: Iterable[Mapping[str, object]],
        fields: Iterable[str] | None = None,
    ) -> "BinaryVectorizer":
        wanted = set(fields) if fields is not None else None
        pairs = set()
        for pm in maps:
            for field, value in pm.items():
                if wanted is None or field in wanted:
                    pairs.add((field, str(value)))
        return BinaryVectorizer(pairs)

    @property
    def n_features(self) -> int:
        return len(self._map)

    def transform(self, pm: Mapping[str, object]) -> np.ndarray:
        """One property map → [n_features] float32 one-hot vector."""
        out = np.zeros(self.n_features, np.float32)
        for field, value in pm.items():
            idx = self._map.get(f"{field}\x00{value}")
            if idx is not None:
                out[idx] = 1.0
        return out

    def transform_batch(
        self, maps: Iterable[Mapping[str, object]]
    ) -> np.ndarray:
        rows = [self.transform(pm) for pm in maps]
        return (
            np.stack(rows)
            if rows
            else np.zeros((0, self.n_features), np.float32)
        )
