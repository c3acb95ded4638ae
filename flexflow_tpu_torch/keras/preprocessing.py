"""Keras preprocessing utilities (reference python/flexflow/keras/preprocessing/).

Only the pieces the reference examples actually use: ``sequence.pad_sequences``
and ``utils.to_categorical`` (re-exported by utils too).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class sequence:
    @staticmethod
    def pad_sequences(sequences: Sequence, maxlen: int = None,
                      dtype: str = "int32", padding: str = "pre",
                      truncating: str = "pre", value: int = 0) -> np.ndarray:
        if maxlen is None:
            maxlen = max(len(s) for s in sequences)
        out = np.full((len(sequences), maxlen), value, dtype=dtype)
        for i, s in enumerate(sequences):
            s = list(s)
            if len(s) > maxlen:
                s = s[-maxlen:] if truncating == "pre" else s[:maxlen]
            if padding == "pre":
                out[i, maxlen - len(s):] = s
            else:
                out[i, :len(s)] = s
        return out
