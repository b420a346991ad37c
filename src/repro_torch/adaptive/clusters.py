"""Cluster models, the input side of input-adaptive precision (port of
``repro.adaptive.clusters``).

A :class:`ClusterModel` partitions traffic into K clusters; each cluster
gets its own calibration statistics and its own member plan in a
:class:`~repro_torch.core.plan.PlanSet`. Three implementations cover the
three signals a deployment has at admission time:

* :class:`LengthBuckets`: sequence-length bins, known before any compute;
* :class:`TaskLabel`: an explicit traffic-class tag from the caller;
* :class:`EmbeddingKMeans`: k-means over mean-pooled input embeddings,
  fitted in numpy during calibration (the JAX package's Lloyd iterations,
  so the centroids are the same bits on the same embeddings); at serve
  time :meth:`EmbeddingKMeans.assign_embedded` is a nearest-centroid argmin
  in torch on the caller's device.

Every model serializes through ``to_dict`` / :func:`cluster_model_from_dict`
into the same JSON the JAX package writes, so either package loads the
other's model, and ``fingerprint()`` hashes that canonical JSON.
"""
from __future__ import annotations

import bisect
import hashlib
import json
from typing import Mapping, Optional, Sequence

import numpy as np
import torch


class ClusterModel:
    """Protocol base: ``assign`` one request, ``assign_rows`` a batch."""

    kind = "base"

    @property
    def num_clusters(self) -> int:
        raise NotImplementedError

    def assign(self, tokens: Sequence[int], *,
               traffic_class: Optional[str] = None) -> int:
        """Cluster id for one request at admission time."""
        raise NotImplementedError

    def assign_rows(self, batch: Mapping, *,
                    traffic_classes: Optional[Sequence[str]] = None
                    ) -> np.ndarray:
        """Per-row cluster ids (B,) for one calibration batch."""
        tokens = np.asarray(batch["tokens"])
        classes = traffic_classes or [None] * tokens.shape[0]
        return np.asarray([self.assign(list(row), traffic_class=tc)
                           for row, tc in zip(tokens, classes)], np.int64)

    def fit(self, embeddings: np.ndarray) -> "ClusterModel":
        """Calibration-time fitting; the identity for parameter-free
        models."""
        return self

    def to_dict(self) -> dict:
        raise NotImplementedError

    def fingerprint(self) -> str:
        """sha256 over the canonical JSON form, stable across save and
        load and across the two packages."""
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode("utf-8")).hexdigest()

    def describe(self) -> str:
        return f"{self.kind} K={self.num_clusters} #{self.fingerprint()[:12]}"


class LengthBuckets(ClusterModel):
    """Cluster by request length: ``edges=(8, 32)`` makes three clusters,
    len <= 8, 8 < len <= 32 and len > 32, numbered by bin. Empty ``edges``
    is the trivial K=1 model."""

    kind = "length"

    def __init__(self, edges: Sequence[int] = ()):
        edges = tuple(int(e) for e in edges)
        if any(e <= 0 for e in edges) or list(edges) != sorted(set(edges)):
            raise ValueError(f"edges must be strictly increasing positive "
                             f"ints, got {edges}")
        self.edges = edges

    @property
    def num_clusters(self) -> int:
        return len(self.edges) + 1

    def assign(self, tokens, *, traffic_class=None) -> int:
        return bisect.bisect_left(self.edges, len(tokens))

    def assign_rows(self, batch, *, traffic_classes=None) -> np.ndarray:
        tokens = np.asarray(batch["tokens"])
        # dense calibration rows are full-width; a per-row "lengths" vector
        # (padded batches) overrides the row width
        if "lengths" in batch:
            lengths = np.asarray(batch["lengths"]).reshape(-1)
        else:
            lengths = np.full((tokens.shape[0],), tokens.shape[1])
        return np.asarray([bisect.bisect_left(self.edges, int(n))
                           for n in lengths], np.int64)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "edges": list(self.edges)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "LengthBuckets":
        return cls(d["edges"])


class TaskLabel(ClusterModel):
    """Cluster by explicit traffic-class tag: cluster id i serves label
    ``labels[i]``; unknown or missing tags route to ``default``."""

    kind = "task"

    def __init__(self, labels: Sequence[str], default: int = 0):
        labels = tuple(str(x) for x in labels)
        if not labels:
            raise ValueError("TaskLabel needs at least one label")
        if len(set(labels)) != len(labels):
            raise ValueError(f"duplicate labels in {labels}")
        if not 0 <= int(default) < len(labels):
            raise ValueError(f"default {default} out of range for "
                             f"{len(labels)} labels")
        self.labels = labels
        self.default = int(default)
        self._index = {name: i for i, name in enumerate(labels)}

    @property
    def num_clusters(self) -> int:
        return len(self.labels)

    def assign(self, tokens, *, traffic_class=None) -> int:
        return self._index.get(traffic_class, self.default)

    def label_for(self, cluster: int) -> str:
        return self.labels[cluster]

    def to_dict(self) -> dict:
        return {"kind": self.kind, "labels": list(self.labels),
                "default": self.default}

    @classmethod
    def from_dict(cls, d: Mapping) -> "TaskLabel":
        return cls(d["labels"], d.get("default", 0))


class EmbeddingKMeans(ClusterModel):
    """Cluster by content: k-means over mean-pooled input embeddings.

    ``fit`` runs Lloyd's algorithm in numpy (seeded init, fixed iteration
    count: calibration must be reproducible). :meth:`assign_embedded` is a
    torch nearest-centroid argmin on the device of its input; the host-side
    :meth:`assign` needs an embedding function bound through :meth:`bind`
    (the router binds the deployment's own embedding table)."""

    kind = "kmeans"

    def __init__(self, k: int, centroids=None, *, seed: int = 0,
                 iters: int = 10):
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        self.k = int(k)
        self.seed = int(seed)
        self.iters = int(iters)
        self.centroids = (None if centroids is None
                          else np.asarray(centroids, np.float32))
        if self.centroids is not None and self.centroids.shape[0] != self.k:
            raise ValueError(f"{self.centroids.shape[0]} centroids for k="
                             f"{self.k}")
        self._embed = None

    @property
    def num_clusters(self) -> int:
        return self.k

    @property
    def fitted(self) -> bool:
        return self.centroids is not None

    def fit(self, embeddings: np.ndarray) -> "EmbeddingKMeans":
        x = np.asarray(embeddings, np.float32)
        if x.ndim != 2 or x.shape[0] < self.k:
            raise ValueError(f"need >= k={self.k} pooled embeddings to fit, "
                             f"got shape {x.shape}")
        rng = np.random.default_rng(self.seed)
        c = x[rng.choice(x.shape[0], self.k, replace=False)].copy()
        for _ in range(self.iters):
            d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)
            ids = d2.argmin(1)
            for j in range(self.k):
                rows = x[ids == j]
                if len(rows):           # empty clusters keep their centroid
                    c[j] = rows.mean(0)
        self.centroids = c
        return self

    def _require_fit(self):
        if self.centroids is None:
            raise ValueError("EmbeddingKMeans is unfitted: call fit() on "
                             "pooled calibration embeddings first")

    def assign_embedded(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest-centroid ids for pooled embeddings ``x`` (..., D), on
        ``x``'s device."""
        self._require_fit()
        c = torch.as_tensor(self.centroids, device=x.device)
        d2 = torch.sum((x.to(torch.float32)[..., None, :] - c) ** 2, dim=-1)
        return torch.argmin(d2, dim=-1)

    def bind(self, embed_fn) -> "EmbeddingKMeans":
        """Attach ``embed_fn(tokens) -> (D,) pooled embedding`` for
        host-side admission."""
        self._embed = embed_fn
        return self

    def assign(self, tokens, *, traffic_class=None) -> int:
        self._require_fit()
        if self._embed is None:
            raise ValueError("EmbeddingKMeans has no bound embedder; call "
                             "bind(embed_fn) (the router does this from "
                             "the deployment params)")
        x = np.asarray(self._embed(tokens), np.float32)
        d2 = ((self.centroids - x[None]) ** 2).sum(-1)
        return int(d2.argmin())

    def assign_rows(self, batch, *, traffic_classes=None) -> np.ndarray:
        self._require_fit()
        if self._embed is None:
            raise ValueError("EmbeddingKMeans has no bound embedder")
        tokens = np.asarray(batch["tokens"])
        return np.asarray([self.assign(list(row)) for row in tokens],
                          np.int64)

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "k": self.k, "seed": self.seed,
             "iters": self.iters}
        if self.centroids is not None:
            # float32 -> repr round-trips exactly through JSON
            d["centroids"] = [[float(v) for v in row]
                              for row in self.centroids]
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "EmbeddingKMeans":
        return cls(d["k"], d.get("centroids"), seed=d.get("seed", 0),
                   iters=d.get("iters", 10))


CLUSTER_MODELS = {m.kind: m for m in
                  (LengthBuckets, TaskLabel, EmbeddingKMeans)}


def cluster_model_from_dict(d: Mapping) -> ClusterModel:
    """Inverse of ``to_dict`` for any registered model (bundle loading)."""
    kind = d.get("kind")
    if kind not in CLUSTER_MODELS:
        raise ValueError(f"unknown cluster model kind {kind!r}; have "
                         f"{sorted(CLUSTER_MODELS)}")
    return CLUSTER_MODELS[kind].from_dict(d)


def pooled_embeddings(params, batch: Mapping, cfg, *,
                      backend=None) -> np.ndarray:
    """Mean-pooled input embeddings (B, D) float32, the feature space
    :class:`EmbeddingKMeans` fits and assigns in: the embedding table alone
    (no transformer layer), through ``T.embed_inputs`` on ``backend`` and
    the params' device (on the card the fused backend launches
    ``fused_embed``)."""
    from repro_torch.kernels.backend import get_backend
    from repro_torch.models import transformer as T
    device = params["embed"]["tok"].device
    inputs = {k: torch.as_tensor(np.asarray(v, np.int32), device=device)
              for k, v in batch.items() if k in ("tokens", "segments")}
    positions = torch.arange(inputs["tokens"].shape[1], dtype=torch.int32,
                             device=device)
    with torch.inference_mode():
        x = T.embed_inputs(params, inputs, cfg, positions=positions,
                           backend=get_backend(backend))
        return torch.mean(x.to(torch.float32), dim=1).cpu().numpy()
