"""Plan linter CLI: validate a PrecisionPlan or PlanSet JSON before deploy
(port of ``repro.toolkit.plan_lint``; ``--arch`` resolves through the
port's own config registry).

    PYTHONPATH=src python -m repro_torch.toolkit.plan_lint plan.json
    PYTHONPATH=src python -m repro_torch.toolkit.plan_lint plan.json --arch bert-base
    PYTHONPATH=src python -m repro_torch.toolkit.plan_lint planset.json --layers 12

The file kind is sniffed from the ``planset_version`` key — single-plan
files lint exactly as before. Checks, in order:

* the file parses as JSON and round-trips through
  :meth:`PrecisionPlan.from_dict` / :meth:`PlanSet.from_dict` (schema
  version, block names, weight / activation scheme enums, calibrator
  names, float dtype; for plansets additionally: unique non-negative
  cluster ids, a member for the default cluster, uniform layer counts,
  and each member's own schema — kv_cache schemes are v2-only, unknown
  fields rejected per member);
* re-serialization is content-identical (``fingerprint()`` of the loaded
  object equals the fingerprint of its canonical re-emission — catches
  silently-dropped unknown keys);
* with ``--arch`` (registry name; ``--reduced`` for the reduced test
  shape) or ``--layers N``: the layer count (every member's, for a
  planset) matches the target architecture.

Exit status 0 = clean (fingerprint printed), 1 = invalid.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Union

from repro_torch.core.plan import PlanSet, PrecisionPlan


def lint(path: str, *, num_layers: int | None = None,
         arch_family: str | None = None, is_moe: bool | None = None,
         log=print) -> Union[PrecisionPlan, PlanSet]:
    """Validate the plan/planset file; raises ValueError on any
    violation. ``arch_family``/``is_moe`` (from ``--arch``) put the
    target architecture into schema-violation messages and reject
    ``experts``/``router``/``shared_ffn`` families aimed at a dense
    config."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: not valid JSON: {e}") from e
    kind = PlanSet if (isinstance(raw, dict)
                       and "planset_version" in raw) else PrecisionPlan
    try:
        plan = kind.from_dict(raw, arch_family=arch_family)
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"{path}: schema violation: {e}") from e
    reloaded = kind.from_json(plan.to_json())
    if reloaded.fingerprint() != plan.fingerprint():
        raise ValueError(f"{path}: {kind.__name__} does not round-trip "
                         f"canonically")
    if num_layers is not None and plan.num_layers != num_layers:
        raise ValueError(f"{path}: plan has {plan.num_layers} layers, "
                         f"target architecture has {num_layers}")
    if is_moe is False:
        plans = ([p for _, p in plan.members]
                 if isinstance(plan, PlanSet) else [plan])
        if any(lp.has_families for p in plans for lp in p.layers):
            fam = f" {arch_family!r}" if arch_family else ""
            raise ValueError(
                f"{path}: plan sets MoE block families "
                f"(experts/router/shared_ffn) but the target "
                f"architecture family{fam} has no expert layers")
    log(f"{path}: OK — {plan.describe()}")
    log(f"fingerprint {plan.fingerprint()}")
    return plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.toolkit.plan_lint",
        description="validate a PrecisionPlan JSON (schema + layer count)")
    ap.add_argument("plan", help="path to the plan JSON file")
    ap.add_argument("--arch", default=None,
                    help="architecture registry name to check the layer "
                         "count against")
    ap.add_argument("--reduced", action="store_true",
                    help="with --arch: use the reduced (test) shape")
    ap.add_argument("--layers", type=int, default=None,
                    help="expected layer count (alternative to --arch)")
    args = ap.parse_args(argv)

    num_layers, arch_family, is_moe = args.layers, None, None
    if args.arch is not None:
        from repro_torch.configs import get_config
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        num_layers = cfg.num_layers
        arch_family = cfg.family
        is_moe = cfg.moe is not None
    try:
        lint(args.plan, num_layers=num_layers, arch_family=arch_family,
             is_moe=is_moe)
    except ValueError as e:
        print(f"plan_lint: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
