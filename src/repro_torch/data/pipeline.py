"""Synthetic, counter-indexed data pipeline (CLUE-like tasks + LM streams)
— a copy of ``repro.data.pipeline``, numpy-only, which the port keeps as
its own: the same ``(seed, split, index)`` gives the same batch in both
packages.

No external datasets ship with the repository, so the pipeline synthesizes
statistically-learnable stand-ins for the paper's CLUE tasks:

* ``tnews``-like short-text classification (15 classes)
* ``iflytek``-like long-text classification (119 classes)
* ``afqmc``-like sentence-pair matching (2 classes)
* token-level NER tagging
* a causal-LM token stream for the assigned-architecture training cells

Every batch is a pure function of ``(seed, split, index)`` — the pipeline
holds **no state**, so checkpoint/restart resumes by fast-forwarding the
step counter (data skipping under elastic restart is free),
and every host in a multi-pod job computes its own shard of batch ``i``
without coordination.

Class signal: each class owns a sparse set of "topic" tokens; documents mix
topic tokens with uniform background noise at a class-dependent rate. A
fine-tuned classifier separates them well above chance within a few hundred
steps — enough signal for the Table-2 accuracy/latency tradeoff to be real.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    kind: str                 # 'cls' | 'match' | 'ner' | 'lm'
    n_classes: int
    vocab_size: int
    seq_len: int
    topic_tokens: int = 16    # topic tokens per class
    signal: float = 0.35      # fraction of positions carrying topic tokens
    topic_stride: int = 4     # < topic_tokens => adjacent classes OVERLAP:
    #                           small decision margins, so int8 noise can
    #                           actually flip predictions (CLUE-like)
    seed: int = 0


TASKS = {
    "tnews": dict(kind="cls", n_classes=15),
    "iflytek": dict(kind="cls", n_classes=119),
    "afqmc": dict(kind="match", n_classes=2),
    "ner": dict(kind="ner", n_classes=7),
    "lm": dict(kind="lm", n_classes=0),
}


def make_task(name: str, vocab_size: int, seq_len: int = 64,
              seed: int = 0) -> TaskSpec:
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r}; have {sorted(TASKS)}")
    t = TASKS[name]
    return TaskSpec(name=name, kind=t["kind"], n_classes=t["n_classes"],
                    vocab_size=vocab_size, seq_len=seq_len, seed=seed)


def _rng(spec: TaskSpec, split: str, index: int) -> np.random.Generator:
    h = hashlib.sha256(
        f"{spec.name}|{spec.seed}|{split}|{index}".encode()).digest()
    return np.random.Generator(np.random.PCG64(int.from_bytes(h[:8], "little")))


def _topics(spec: TaskSpec) -> np.ndarray:
    """(n_classes, topic_tokens) fixed per task; reserved ids start at 10.
    Classes are overlapping windows over a shared token pool (stride <
    topic_tokens), so neighbours share topics and margins stay small."""
    g = np.random.Generator(np.random.PCG64(spec.seed + 7))
    n = max(spec.n_classes, 1)
    stride = min(max(spec.topic_stride, 1), spec.topic_tokens)
    pool_size = (n - 1) * stride + spec.topic_tokens
    pop = max(spec.vocab_size - 10, 2)
    pool = 10 + g.choice(pop, size=pool_size, replace=pop < pool_size)
    return np.stack([pool[c * stride: c * stride + spec.topic_tokens]
                     for c in range(n)])


def _doc(g, spec: TaskSpec, label: int, length: int,
         topics: np.ndarray) -> np.ndarray:
    toks = g.integers(10, spec.vocab_size, size=length)
    mask = g.random(length) < spec.signal
    toks[mask] = g.choice(topics[label], size=int(mask.sum()))
    return toks


def get_batch(spec: TaskSpec, index: int, batch_size: int,
              split: str = "train") -> dict:
    """Batch ``index`` of ``split`` as numpy arrays (tokens/segments/labels).
    Deterministic; train and dev are disjoint generator streams."""
    g = _rng(spec, split, index)
    topics = _topics(spec)
    S = spec.seq_len
    if spec.kind == "lm":
        # block-structured LM stream: repeated motifs + noise, so loss can
        # actually go down
        motifs = _topics(dataclasses.replace(spec, n_classes=32))
        tokens = np.empty((batch_size, S), np.int64)
        for b in range(batch_size):
            row, pos = [], 0
            while pos < S:
                m = motifs[g.integers(32)]
                row.extend(m[: min(len(m), S - pos)])
                pos += len(m)
                if pos < S:
                    row.append(int(g.integers(10, spec.vocab_size)))
                    pos += 1
            tokens[b] = row[:S]
        return {"tokens": tokens.astype(np.int32)}
    if spec.kind == "cls":
        labels = g.integers(spec.n_classes, size=batch_size)
        tokens = np.stack([_doc(g, spec, int(l), S, topics) for l in labels])
        return {"tokens": tokens.astype(np.int32),
                "segments": np.zeros((batch_size, S), np.int32),
                "labels": labels.astype(np.int32)}
    if spec.kind == "match":
        labels = g.integers(2, size=batch_size)
        half = S // 2
        # matching discriminates same-vs-different topic: topics must be
        # DISJOINT here or the task carries no signal
        n_topic = max(spec.n_classes, 8)
        topics8 = _topics(dataclasses.replace(
            spec, n_classes=n_topic, topic_stride=spec.topic_tokens))
        tokens = np.empty((batch_size, S), np.int64)
        segments = np.zeros((batch_size, S), np.int64)
        segments[:, half:] = 1
        for b in range(batch_size):
            ta = int(g.integers(n_topic))
            tb = ta if labels[b] == 1 else int((ta + 1 + g.integers(
                n_topic - 1)) % n_topic)
            tokens[b, :half] = _doc(g, spec, ta, half, topics8)
            tokens[b, half:] = _doc(g, spec, tb, S - half, topics8)
        return {"tokens": tokens.astype(np.int32),
                "segments": segments.astype(np.int32),
                "labels": labels.astype(np.int32)}
    if spec.kind == "ner":
        tokens = g.integers(10, spec.vocab_size, size=(batch_size, S))
        # tag = bucket of the token id (deterministic token->tag map + noise)
        labels = (tokens * 2654435761 % spec.n_classes).astype(np.int64)
        flip = g.random((batch_size, S)) < 0.05
        labels[flip] = g.integers(spec.n_classes, size=int(flip.sum()))
        return {"tokens": tokens.astype(np.int32),
                "segments": np.zeros((batch_size, S), np.int32),
                "labels": labels.astype(np.int32)}
    raise ValueError(spec.kind)


def eval_accuracy(predict_fn, spec: TaskSpec, *, batches: int = 8,
                  batch_size: int = 64, split: str = "dev") -> float:
    """Dev-set accuracy of ``predict_fn(batch)->class ids`` (the metric the
    SAMP allocator consumes)."""
    correct = total = 0
    for i in range(batches):
        batch = get_batch(spec, i, batch_size, split)
        pred = np.asarray(predict_fn(batch))
        correct += int((pred == batch["labels"]).sum())
        total += int(np.prod(batch["labels"].shape))
    return correct / max(total, 1)
