"""Example-drift comparison, the port of ``test_utils/examples.py``.

Every by-feature example must stay line for line in step with the
complete example, so that a feature's demo cannot drift from the script
that puts all features together: a function's source lines are taken
from the base example (``nlp_example.py``), the complete example and the
feature example, and the feature's new lines (those not in the base) must
all appear among the complete example's new lines. Lines holding a
``TESTING_`` environment guard are test plumbing and are left out.

The port's examples keep their shared helpers in ``nlp_example.py`` and
end ``training_function`` where the next top-level ``def`` starts (the
reference's end at ``def compute_dtype``); ``main`` runs to
``if __name__``.
"""

from __future__ import annotations

import os
from typing import List, Optional


def extract_function(lines: List[str], name: str) -> List[str]:
    """Source lines of ``def <name>`` up to its end: the next top-level
    ``def`` for ``training_function``, ``if __name__`` for ``main``."""
    if name not in ("training_function", "main"):
        raise ValueError(f"unsupported function {name!r}: choose 'training_function' or 'main'")
    out, started = [], False
    for line in lines:
        if not started:
            if line.startswith(f"def {name}("):
                started = True
                out.append(line)
            continue
        if line.startswith("if __name__") or (name == "training_function"
                                              and line.startswith("def ")):
            return out
        out.append(line)
    return out


def clean_lines(lines: List[str]) -> List[str]:
    """Drop comments, blank lines and ``TESTING_``-guarded lines; strip
    indentation (a feature script may nest shared code differently, under
    an ``if args.with_tracking:`` branch, say)."""
    return [
        line.strip()
        for line in lines
        if not line.lstrip().startswith("#") and line.strip() != "" and "TESTING_" not in line
    ]


def compare_against_test(complete_filename: str, feature_filename: str, parser_only: bool,
                         base_filename: Optional[str] = None) -> List[str]:
    """Lines of ``feature_filename`` that are covered by neither the base
    example nor the complete example: an empty list means no drift.
    ``parser_only`` compares ``main``, else ``training_function``.
    ``base_filename`` defaults to ``nlp_example.py`` beside the complete
    example."""
    if base_filename is None:
        base_filename = os.path.join(os.path.dirname(os.path.abspath(complete_filename)),
                                     "nlp_example.py")
    name = "main" if parser_only else "training_function"
    with open(complete_filename) as f:
        complete = clean_lines(extract_function(f.readlines(), name))
    with open(base_filename) as f:
        base = clean_lines(extract_function(f.readlines(), name))
    with open(feature_filename) as f:
        feature = clean_lines(extract_function(f.readlines(), name))

    feature_new = [line for line in feature if line not in base]
    complete_new = [line for line in complete if line not in base]
    return [line for line in feature_new if line not in complete_new]
