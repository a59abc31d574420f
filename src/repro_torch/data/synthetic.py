"""Synthetic sequence classification (the GLUE analogue of the reference's
offline tasks): class-conditioned unigram token sequences, and the model
must emit the class token at the last position. ``class_ids`` is the
label the Dirichlet partition splits on."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TaskData:
    tokens: np.ndarray            # (N, L) int32
    labels: np.ndarray            # (N, L) int32, -1 masked
    class_ids: np.ndarray         # (N,) partitioning label
    embeds: Optional[np.ndarray] = None


def seq_classification(n_examples: int, n_classes: int, seq_len: int,
                       vocab: int, seed: int = 0,
                       signal: float = 3.0) -> TaskData:
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, n_classes, n_examples)
    # Class-conditioned unigram distributions over the content vocabulary.
    content_vocab = vocab - n_classes          # last ids reserved for labels
    logits = rng.normal(size=(n_classes, content_vocab))
    boost = rng.integers(0, content_vocab,
                         (n_classes, max(2, content_vocab // 16)))
    for c in range(n_classes):
        logits[c, boost[c]] += signal
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    tokens = np.stack([rng.choice(content_vocab, size=seq_len, p=probs[c])
                       for c in cls]).astype(np.int32)
    labels = np.full((n_examples, seq_len), -1, np.int32)
    labels[:, -1] = content_vocab + cls        # predict the class token
    return TaskData(tokens=tokens, labels=labels, class_ids=cls)
