"""Input-adaptive precision: cluster-conditional calibration and routing
(port of ``repro.adaptive``).

Requests are assigned to one of K clusters (by length, traffic class or
embedding geometry), calibration aggregates amax statistics per cluster,
autotune searches a plan per cluster, and the serving engines route every
request to its cluster's quantized tree and cached callables.
"""
from repro_torch.adaptive.calibrate import (autotune_planset, batch_clusters,
                                            clustered_synthetic_batches,
                                            fit_cluster_model)
from repro_torch.adaptive.clusters import (CLUSTER_MODELS, ClusterModel,
                                           EmbeddingKMeans, LengthBuckets,
                                           TaskLabel, cluster_model_from_dict,
                                           pooled_embeddings)
from repro_torch.adaptive.router import (ClusterEntry, PlanRouter,
                                         bind_embedder, build_router)
from repro_torch.core.plan import PlanSet, load_plan_or_planset

__all__ = [
    "CLUSTER_MODELS", "ClusterEntry", "ClusterModel", "EmbeddingKMeans",
    "LengthBuckets", "PlanRouter", "PlanSet", "TaskLabel",
    "autotune_planset", "batch_clusters", "bind_embedder", "build_router",
    "cluster_model_from_dict", "clustered_synthetic_batches",
    "fit_cluster_model", "load_plan_or_planset", "pooled_embeddings",
]
