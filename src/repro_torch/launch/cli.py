"""Shared CLI surface for the serving entrypoints (port of
``repro.launch.cli``).

``launch/serve.py`` (the synchronous one-shot CLI) and
``launch/server.py`` (the HTTP/SSE front-end) serve the same deployments,
so they must parse the same deployment flags the same way. This module is
the single definition of that surface — ``--arch / --task / --policy /
--plan / --clusters / --strategy / --max-latency / --backend / --mesh /
--slots / --max-len / --seed / --page-size / --kv-dtype``, the JAX CLIs'
flags with their defaults and choices — plus ``--device``, which picks the
card (the full config) or the CPU (the reduced config the JAX CLIs serve).
:func:`parse_cluster_model` turns the ``--clusters`` spec string into a
:class:`~repro_torch.adaptive.clusters.ClusterModel`.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device


def add_serving_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The deployment flags every serving entrypoint shares."""
    ap.add_argument("--arch", required=True)
    ap.add_argument("--task", default=None,
                    help="lm (decode engine) | tnews|iflytek|afqmc|ner "
                         "(encoder engine); default: lm when the arch "
                         "decodes, tnews otherwise")
    ap.add_argument("--policy", default="float",
                    help="float | ffn[K] | full[K]")
    ap.add_argument("--plan", default=None,
                    help="path to a saved PrecisionPlan or PlanSet JSON "
                         "(overrides --policy/--strategy; a PlanSet needs "
                         "--clusters with a matching cluster count)")
    ap.add_argument("--clusters", default=None,
                    help="input-adaptive precision: route requests to "
                         "per-cluster plans. 'length:8,16' (length bins), "
                         "'task:chat,search' (X-SAMP-Traffic-Class "
                         "labels), 'kmeans:3' (embedding k-means). "
                         "Calibration turns cluster-conditional; --policy "
                         "deploys the same plan per cluster (per-cluster "
                         "scales), --plan may name a PlanSet")
    ap.add_argument("--strategy", default=None,
                    choices=("prefix_grid", "greedy", "latency_budget"),
                    help="pick the plan with a search strategy instead of "
                         "--policy")
    ap.add_argument("--max-latency", type=float, default=None,
                    help="latency ceiling (roofline seconds) for "
                         "--strategy latency_budget")
    ap.add_argument("--backend", default="reference",
                    choices=("reference", "fused", "auto"),
                    help="compute backend for quantized blocks: reference "
                         "PyTorch ops, fused CUDA kernels, or auto (fused "
                         "on CUDA, reference on the CPU)")
    ap.add_argument("--mesh", default="1,1",
                    help="serving mesh as 'dp,tp' (data-parallel x tensor-"
                         "parallel ranks); 1,1 = unmeshed. Both serving "
                         "entrypoints spawn dp*tp ranks, round-robin on "
                         "the cards (gloo where they share one)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch slots / encoder micro-batch size")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page; switches the decode caches "
                         "to the paged layout (pages allocated on demand, "
                         "freed on completion/cancel). Required for "
                         "--kv-dtype int8_*")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("float", "int8_per_head", "int8_per_token"),
                    help="KV-cache page scheme for every full-attention "
                         "layer; int8_per_head needs a plan calibrated "
                         "with KV stats, int8_per_token quantizes "
                         "dynamically at decode time. Default: the plan's "
                         "per-layer kv_cache schemes")
    ap.add_argument("--device", default="cuda",
                    help="cuda serves the full config on the card (an "
                         "error where there is none); cpu serves the "
                         "reduced config through the kernels' plain "
                         "versions")
    return ap


def check_mesh(spec: str) -> tuple[int, int]:
    """Validate ``--mesh`` as the JAX CLIs parse it (two integers >= 1);
    returns ``(dp, tp)``."""
    from repro_torch.launch.mesh import parse_mesh
    return parse_mesh(spec)


def serving_config(args):
    """The deployment's ``(config, device)``: the full config on the card,
    the reduced one on the CPU. A missing card exits; it never falls back
    to the CPU."""
    check_mesh(args.mesh)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None
    cfg = get_config(args.arch)
    return (cfg.reduced() if device.type == "cpu" else cfg), device


def parse_cluster_model(spec):
    """Parse a ``--clusters`` spec into a ClusterModel (None -> None).

    ``length:8,16`` -> LengthBuckets((8, 16)); ``task:chat,search`` ->
    TaskLabel(("chat", "search")); ``kmeans:3`` -> EmbeddingKMeans(3).
    """
    if spec is None:
        return None
    from repro_torch.adaptive import EmbeddingKMeans, LengthBuckets, TaskLabel
    kind, _, rest = spec.partition(":")
    try:
        if kind == "length":
            return LengthBuckets(tuple(int(x) for x in rest.split(",") if x))
        if kind == "task":
            return TaskLabel(tuple(x for x in rest.split(",") if x))
        if kind == "kmeans":
            return EmbeddingKMeans(int(rest))
    except (ValueError, TypeError) as e:
        raise SystemExit(f"--clusters {spec!r}: {e}")
    raise SystemExit(f"--clusters {spec!r}: unknown model {kind!r}; use "
                     f"length:<edges> | task:<labels> | kmeans:<K>")


def resolve_task(cfg, task):
    """Default/validate ``--task`` against the architecture: ``lm`` needs
    a decode-capable config; encoder-only configs default to ``tnews``."""
    if task is None:
        return "lm" if cfg.supports_decode else "tnews"
    if task == "lm" and not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: pass --task "
                         f"tnews|iflytek|afqmc|ner")
    return task
