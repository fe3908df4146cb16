"""Prometheus exposition lint CLI.

    python -m repro_torch.obs metrics.json   # a JSON document whose
                                             # "prometheus" field holds
                                             # the exposition
    python -m repro_torch.obs metrics.prom   # raw text exposition

JSON inputs carry the exposition in their ``prometheus`` field; anything
else is linted as raw text.  Exits nonzero listing every problem found,
so a malformed metric name or a histogram missing its ``_count`` series
fails the caller instead of breaking whichever scraper meets it first.
"""

from __future__ import annotations

import json
import sys

from repro_torch.obs.metrics import lint_prometheus


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    path = argv[0]
    with open(path) as f:
        raw = f.read()
    text = raw
    if path.endswith(".json"):
        doc = json.loads(raw)
        text = doc.get("prometheus")
        if not isinstance(text, str):
            print(f"{path}: no 'prometheus' text field in JSON document",
                  file=sys.stderr)
            return 1
    problems = lint_prometheus(text)
    n_samples = sum(
        1 for ln in text.splitlines() if ln.strip() and not ln.startswith("#"))
    if problems:
        print(f"{path}: {len(problems)} exposition problem(s):",
              file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    print(f"{path}: prometheus exposition clean ({n_samples} samples)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
