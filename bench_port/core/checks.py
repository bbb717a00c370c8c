"""The comparison that decides `correct`: every number compared beside its
limit. A number that is not finite, or is missing, fails."""
from __future__ import annotations

import math
import sys
from typing import Dict


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every limit; a limit whose number the
    run did not produce reads as NaN."""
    return {name: {"value": float(values.get(name, math.nan)), "limit": float(limit)}
            for name, limit in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def print_checks(checks: Dict[str, dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        ok = "ok" if math.isfinite(c["value"]) and c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr, flush=True)
