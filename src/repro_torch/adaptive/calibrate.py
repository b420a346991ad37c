"""Cluster-conditional calibration and per-cluster autotune (port of
``repro.adaptive.calibrate``).

* :func:`fit_cluster_model`: the fitting a model needs (k-means over
  pooled embeddings for :class:`EmbeddingKMeans`, the identity for the
  parameter-free models) and a host-side embedder bound to the params;
* :func:`batch_clusters`: per-batch per-row cluster-id vectors, the
  ``clusters=`` argument of :func:`repro_torch.quant.ptq.capture_stats`;
* :func:`clustered_synthetic_batches`: a synthetic calibration stream that
  covers every cluster. Its tokens come from a ``torch.Generator`` seeded
  per batch, so they are not the JAX package's ``jax.random`` bits; the
  lengths, batch counts, classes and errors are the same;
* :func:`autotune_planset`: one search per cluster over that cluster's
  stats; the winners assemble into a :class:`PlanSet`.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.adaptive.clusters import (ClusterModel, EmbeddingKMeans,
                                           TaskLabel, pooled_embeddings)
from repro_torch.core.plan import PlanSet


def single_row_embedder(params: dict, cfg, backend=None) -> Callable:
    """``tokens -> (D,)`` pooled embedding of one request (zero segments),
    through ``backend`` on the params' device."""
    def embed(tokens):
        batch = {"tokens": np.asarray([list(tokens)], np.int32)}
        if cfg.num_segments:
            batch["segments"] = np.zeros_like(batch["tokens"])
        return pooled_embeddings(params, batch, cfg, backend=backend)[0]
    return embed


def fit_cluster_model(model: ClusterModel, params: dict,
                      batches: Sequence[dict], cfg, *,
                      backend=None) -> ClusterModel:
    """Calibration-time fitting: EmbeddingKMeans learns its centroids from
    the pooled embeddings of the calibration stream and gets a host-side
    embedder bound; parameter-free models pass through unchanged."""
    if isinstance(model, EmbeddingKMeans):
        if not model.fitted:
            pools = np.concatenate(
                [pooled_embeddings(params, b, cfg, backend=backend)
                 for b in batches])
            model.fit(pools)
        if model._embed is None:
            model.bind(single_row_embedder(params, cfg, backend))
    return model


def batch_clusters(model: ClusterModel, batches: Sequence[dict], *,
                   batch_classes: Optional[Sequence] = None) -> list:
    """Per-row cluster ids for every batch. ``batch_classes`` optionally
    carries one traffic class (or a per-row list) per batch for TaskLabel
    models."""
    out = []
    for i, b in enumerate(batches):
        tc = batch_classes[i] if batch_classes is not None else None
        if isinstance(tc, str):
            tc = [tc] * np.asarray(b["tokens"]).shape[0]
        out.append(model.assign_rows(b, traffic_classes=tc))
    return out


def clustered_synthetic_batches(cfg, model: ClusterModel, *,
                                batches_per_cluster: int = 2,
                                batch_size: int = 2, seed: int = 0,
                                max_len: int = 64):
    """Synthetic calibration batches covering every cluster of ``model``:
    ``(batches, batch_classes)``, numpy int32 tokens (and zero segments).
    LengthBuckets gets one stream per length bin at a representative
    in-bin length; every other model gets per-cluster streams at the
    default length, tagged per cluster for TaskLabel. Batch j of cluster c
    draws from a generator seeded ``seed + 1000 c + j``."""

    def make(seq_len: int, s: int) -> dict:
        gen = torch.Generator().manual_seed(s)
        b = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (batch_size, seq_len), generator=gen,
                                     dtype=torch.int32).numpy()}
        if cfg.num_segments:
            b["segments"] = np.zeros((batch_size, seq_len), np.int32)
        return b

    lengths = None
    if getattr(model, "edges", None):               # LengthBuckets, K >= 2
        edges = list(model.edges)
        lengths = []
        for i in range(model.num_clusters):
            if i < len(edges):
                lengths.append(min(edges[i], max_len))
            else:
                lengths.append(min(max(edges[-1] + 8, edges[-1] * 2),
                                   max_len))
        if len(set(lengths)) != len(lengths):
            raise ValueError(f"max_len={max_len} cannot cover every length "
                             f"bucket of edges={edges}")
    batches, classes = [], []
    for c in range(model.num_clusters):
        seq = lengths[c] if lengths is not None else min(32, max_len)
        for j in range(batches_per_cluster):
            batches.append(make(seq, seed + c * 1000 + j))
            classes.append(model.label_for(c)
                           if isinstance(model, TaskLabel) else None)
    return batches, classes


def autotune_planset(engine, params: dict, cluster_stats: Mapping, *,
                     eval_fn: Callable, latency_fn: Callable,
                     strategy: str = "prefix_grid",
                     max_latency: Optional[float] = None,
                     min_accuracy: Optional[float] = None,
                     prefer: Optional[str] = None,
                     **strategy_kw):
    """One search per cluster -> PlanSet of the per-cluster winners.

    ``engine`` is a :class:`~repro_torch.core.samp.SAMPEngine`;
    ``cluster_stats`` the cluster-keyed dict from
    ``capture_stats(clusters=...)``. Every cluster runs the same strategy
    over its own stats, so clusters can land different plans. Returns
    ``(planset, details)`` with ``details[cid] = (points, recommendations,
    chosen)``."""
    members, details = [], {}
    for cid in sorted(cluster_stats):
        points = engine.search(strategy, params, cluster_stats[cid], eval_fn,
                               latency_fn, **strategy_kw)
        recs = engine.recommend(points, max_latency=max_latency,
                                min_accuracy=min_accuracy)
        if not recs:
            raise ValueError(f"cluster {cid}: search produced no quantized "
                             f"candidates to recommend from")
        if prefer is None:
            chosen = next((r for r in recs
                           if r.mode_name == "quant_ffn_only"), recs[0])
        else:
            chosen = next((r for r in recs if r.mode_name == prefer), None)
            if chosen is None:
                raise KeyError(f"cluster {cid}: prefer={prefer!r} matches "
                               f"no recommended mode; have "
                               f"{[r.mode_name for r in recs]}")
        members.append((cid, chosen.point.plan))
        details[cid] = (points, recs, chosen)
    planset = PlanSet(tuple(members), default=min(details))
    return planset, details
