"""Synthetic federated tasks (offline stand-ins for GLUE / DomainNet /
MetaMathQA). Every task has learnable structure and a label,
``class_ids``, for the Dirichlet partition:

* ``seq_classification`` — class-conditioned unigram token sequences; the
  model must emit the class token at the last position (GLUE analogue).
* ``markov_lm`` — a mixture of random Markov chains; the chain id is the
  "type" label (MetaMathQA analogue).
* ``patch_classification`` — stub patch embeddings with class prototypes
  and a class-token target (DomainNet / ViT analogue).

All of them draw from one ``numpy`` ``default_rng`` in the JAX package's
order, so a seed gives its arrays exactly."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TaskData:
    tokens: np.ndarray            # (N, L) int32
    labels: np.ndarray            # (N, L) int32, -1 masked
    class_ids: np.ndarray         # (N,) partitioning label
    embeds: Optional[np.ndarray] = None   # (N, F, D) for patch tasks


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


def markov_lm(n_examples: int, n_types: int, seq_len: int, vocab: int,
              seed: int = 0, concentration: float = 0.1) -> TaskData:
    rng = np.random.default_rng(seed)
    types = rng.integers(0, n_types, n_examples)
    trans = rng.dirichlet(concentration * np.ones(vocab),
                          size=(n_types, vocab))
    tokens = np.empty((n_examples, seq_len), np.int32)
    for i, ty in enumerate(types):
        t = rng.integers(0, vocab)
        for j in range(seq_len):
            tokens[i, j] = t
            t = rng.choice(vocab, p=trans[ty, t])
    labels = np.concatenate([tokens[:, 1:],
                             np.full((n_examples, 1), -1, np.int32)], axis=1)
    return TaskData(tokens=tokens, labels=labels, class_ids=types)


def patch_classification(n_examples: int, n_classes: int, n_patches: int,
                         d_model: int, vocab: int, seed: int = 0,
                         signal: float = 2.0, text_len: int = 4) -> TaskData:
    """(N, n_patches, d_model) fp32 embeddings: N(0, 1) noise plus
    ``signal`` times the class prototype; ``text_len`` zero tokens after
    them, the last labelled with the class."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, n_classes, n_examples)
    protos = rng.normal(size=(n_classes, d_model))
    embeds = (rng.normal(size=(n_examples, n_patches, d_model))
              + signal * protos[cls][:, None, :]).astype(np.float32)
    tokens = np.zeros((n_examples, text_len), np.int32)   # BOS-style prompt
    labels = np.full((n_examples, text_len), -1, np.int32)
    labels[:, -1] = cls % vocab
    return TaskData(tokens=tokens, labels=labels, class_ids=cls,
                    embeds=embeds)


def accuracy_from_logits(logits_last: np.ndarray, labels_last: np.ndarray
                         ) -> float:
    return float((logits_last.argmax(-1) == labels_last).mean())
