"""Render docs/architecture.md's "Known gaps" section from the tracked
checklist docs/known_gaps.yaml.

The gaps list rotted twice when it was hand-maintained prose; now the
YAML is the single source of truth and this renderer is deterministic,
so tests/test_docs_gaps.py can assert the doc matches the checklist
byte-for-byte.

  python -m armada_tpu_torch.tools.gen_known_gaps           # print the rendered section
  python -m armada_tpu_torch.tools.gen_known_gaps --write   # splice it into the doc
  python -m armada_tpu_torch.tools.gen_known_gaps --check   # exit 1 on drift

This is the port's counterpart of the repo's tools/gen_known_gaps.py,
over the same checklist and doc; `yaml` is needed only where the
checklist is read.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
YAML_PATH = os.path.join(REPO, "docs", "known_gaps.yaml")
DOC_PATH = os.path.join(REPO, "docs", "architecture.md")

HEADING = "## Known gaps vs the reference (tracked)"
SECTION_RE = re.compile(r"## Known gaps.*?(?=\n## |\Z)", re.DOTALL)


def load_gaps(path: str = YAML_PATH) -> list[dict]:
    import yaml

    with open(path) as f:
        gaps = yaml.safe_load(f)["gaps"]
    for g in gaps:
        assert g["status"] in ("open", "closed"), g
        assert re.fullmatch(r"[a-z0-9-]+", g["id"]), g
        assert "::" in g["closer"], f"closer must be a pytest node id: {g}"
    assert len({g["id"] for g in gaps}) == len(gaps), "duplicate gap ids"
    return gaps


def _wrap(prefix: str, text: str) -> str:
    # Never split words/hyphens: pytest node ids and `code` spans must
    # survive wrapping intact.
    return textwrap.fill(
        f"{prefix} {text}", width=72, subsequent_indent="  ",
        break_long_words=False, break_on_hyphens=False,
    )


def render(gaps: list[dict]) -> str:
    """The full section, heading through last bullet, no trailing \\n."""
    open_gaps = [g for g in gaps if g["status"] == "open"]
    closed = [g for g in gaps if g["status"] == "closed"]
    out = [
        HEADING,
        "",
        textwrap.fill(
            "Generated from `docs/known_gaps.yaml` by "
            "`tools/gen_known_gaps.py --write` — edit the YAML, not this "
            "section. `tests/test_docs_gaps.py` fails when this rendering "
            "drifts from the checklist, when an open gap's closer test "
            "exists and passes, or when a closed gap's closing test is "
            "missing.",
            width=72,
        ),
        "",
    ]
    for g in open_gaps:
        out.append(_wrap(f"- <!-- gap:{g['id']} -->", g["claim"]))
    out += [
        "",
        "Closed (each names the test that closes it):",
        "",
    ]
    for g in closed:
        out.append(
            _wrap(
                f"- <!-- closed-gap:{g['id']} -->",
                f"{g['claim']} Closed by `{g['closer']}`.",
            )
        )
    return "\n".join(out)


def spliced_doc(section: str) -> str:
    with open(DOC_PATH) as f:
        doc = f.read()
    assert SECTION_RE.search(doc), "doc lost its Known gaps section"
    return SECTION_RE.sub(lambda _: section + "\n", doc, count=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--write", action="store_true")
    mode.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    section = render(load_gaps())
    if args.write:
        new = spliced_doc(section)
        with open(DOC_PATH, "w") as f:
            f.write(new)
        return 0
    if args.check:
        with open(DOC_PATH) as f:
            current = SECTION_RE.search(f.read())
        if current and current.group(0).rstrip("\n") == section:
            return 0
        print("docs/architecture.md 'Known gaps' drifted; rerun --write")
        return 1
    print(section)
    return 0


if __name__ == "__main__":
    sys.exit(main())
