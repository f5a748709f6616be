#!/usr/bin/env python
"""grovelint over the PyTorch port: the port's static analysis and the
generated-artifact drift checks (the port's counterpart of scripts/lint.py).

Two stages, both on by default:

1. **Static analysis**: the port's rule engine (grove_tpu_torch/analysis,
   GL001..GL022; GL005 checks torch hygiene) over every .py in
   grove_tpu_torch/. A suppression needs `-- justification`.
2. **Drift checks** (skip with --no-check): `deploy/crds/*.yaml`, the chart
   copies under `deploy/charts/grove-tpu/crds/` and `docs/api-reference.md`
   must equal, byte for byte, what the port's cluster/crdgen and
   cluster/apidocs render from its api/types.py.

Exit-code contract: 0 clean, 1 violations or drift, 2 internal error.

Usage: python scripts/torch_lint.py [--json] [--no-check] [--rules GL001,GL007]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def drift_problems() -> list:
    """Byte-compare the generated artifacts against the port's generators."""
    import yaml

    from grove_tpu_torch.cluster.apidocs import render_api_reference
    from grove_tpu_torch.cluster.crdgen import CRD_KINDS, generate_crd

    problems = []
    for kind in CRD_KINDS:
        crd = generate_crd(kind)
        want = yaml.safe_dump(crd, sort_keys=False, default_flow_style=False)
        name = f"{crd['metadata']['name']}.yaml"
        for rel in (Path("deploy/crds") / name, Path("deploy/charts/grove-tpu/crds") / name):
            path = ROOT / rel
            if not path.exists():
                if "charts" in str(rel) and not path.parent.exists():
                    continue  # chart copies are optional in a trimmed tree
                problems.append(f"{rel}: missing (run `python -m grove_tpu_torch crds --output-dir`)")
                continue
            if path.read_text() != want:
                problems.append(f"{rel}: stale: the port's crdgen renders it otherwise")
    ref = ROOT / "docs/api-reference.md"
    if not ref.exists():
        problems.append("docs/api-reference.md: missing")
    elif ref.read_text() != render_api_reference():
        problems.append("docs/api-reference.md: stale: the port's apidocs renders it otherwise")
    return problems


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", action="store_true", help="emit the JSON report")
    parser.add_argument("--no-check", action="store_true",
                        help="skip the CRD/api-docs drift checks (analysis only)")
    parser.add_argument("--rules", help="comma-separated rule ids to run (default: all)")
    args = parser.parse_args(argv)

    from grove_tpu_torch.analysis.engine import default_rules, run_repo_lint

    rules = default_rules()
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",")}
        rules = [r for r in rules if r.id in wanted]
        if not rules:
            print(f"no rules match {args.rules!r}", file=sys.stderr)
            return 2

    report = run_repo_lint(ROOT, rules)
    drift = [] if args.no_check else drift_problems()

    if args.json:
        doc = report.as_json()
        doc["drift"] = drift
        doc["ok"] = doc["ok"] and not drift
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print(report.render_human())
        for p in drift:
            print(f"drift: {p}")
        if not args.no_check:
            print(f"drift checks: {len(drift)} problem(s)" if drift else "drift checks: clean")
    return 0 if (report.ok and not drift) else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # internal error: a distinct exit code
        print(f"grovelint internal error: {e}", file=sys.stderr)
        sys.exit(2)
