"""Render docs/metrics.md — the inventory of every registered metric
family — from services/metrics.SchedulerMetrics itself.

Hand-maintained metric docs rot the moment a PR adds a family; this
renderer walks the live registry (name, type, labels, help text), so
the doc IS the code's registration list:

  python -m armada_tpu_torch.tools.gen_metrics_doc           # print the rendered doc
  python -m armada_tpu_torch.tools.gen_metrics_doc --write   # regenerate docs/metrics.md
  python -m armada_tpu_torch.tools.gen_metrics_doc --check   # exit 1 on drift

This is the port's counterpart of the repo's tools/gen_metrics_doc.py,
rendering from the port's services/metrics.py: the port registers the
JAX package's families, so both render the one docs/metrics.md. It
needs prometheus_client, which the card's machine lacks.
"""

from __future__ import annotations

import argparse
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DOC_PATH = os.path.join(REPO, "docs", "metrics.md")

HEADER = """\
# Metric inventory

Every metric family registered by `services/metrics.SchedulerMetrics`,
GENERATED by `tools/gen_metrics_doc.py --write` — edit the registration
in `services/metrics.py`, not this file. `tests/test_docs_gaps.py`
fails when this inventory drifts from the registry.

Liveness is enforced by `tests/test_metrics_liveness.py`: labeled
families must carry samples after a short sim (or sit on its audited
exempt list), unlabeled families must have their mutators CALLED
during the sweep — registered-but-dead gauges fail tier-1.

| family | type | labels | description |
|---|---|---|---|
"""


def families() -> list[tuple[str, str, str, str]]:
    from ..services.metrics import HAVE_PROMETHEUS, SchedulerMetrics

    if not HAVE_PROMETHEUS:  # pragma: no cover - prometheus is present here
        raise SystemExit("prometheus_client unavailable")
    m = SchedulerMetrics()
    rows = []
    for attr, metric in sorted(vars(m).items()):
        collect = getattr(metric, "collect", None)
        if collect is None:
            continue
        family = next(iter(collect()))
        labels = ",".join(getattr(metric, "_labelnames", ()) or ())
        doc = " ".join(family.documentation.split())
        rows.append((family.name, family.type, labels, doc))
    rows.sort()
    return rows


def render() -> str:
    out = [HEADER]
    for name, kind, labels, doc in families():
        out.append(f"| `{name}` | {kind} | {labels or '-'} | {doc} |\n")
    return "".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    doc = render()
    if args.write:
        with open(DOC_PATH, "w") as f:
            f.write(doc)
        print(f"wrote {DOC_PATH} ({len(doc)} bytes)")
        return 0
    if args.check:
        try:
            with open(DOC_PATH) as f:
                current = f.read()
        except OSError:
            print("docs/metrics.md missing; run "
                  "python -m armada_tpu_torch.tools.gen_metrics_doc --write")
            return 1
        if current != doc:
            print(
                "docs/metrics.md is stale vs the registered families; run "
                "python -m armada_tpu_torch.tools.gen_metrics_doc --write"
            )
            return 1
        print("docs/metrics.md up to date")
        return 0
    print(doc, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
