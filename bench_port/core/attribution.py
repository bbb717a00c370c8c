"""The program's own spans and counters, and the profiled window's idle time
charged to its spans.

The program records spans and counters while a profiler runs
(`recsys_examples_torch.utils.observability`), so after a traced run its
`snapshot()` holds the profiled window's. A program without that tracer
gives None here, and the readers that need it read nothing.

An idle gap, a stretch of the window in which no operation ran on the
card, is charged to the innermost of the program's spans open when the host
launched the operation that ends the gap: the span under which the host
issued the work the card was waiting for. The reduced trace keeps no
window start, so the gap before the first operation and the one after the
last are left together as `EDGES`; an operation launched under none of the
program's spans charges its gap to `NO_SPAN`."""
from __future__ import annotations

from typing import Dict, Iterable, Optional

from bench_port.core.trace import Trace

NO_SPAN = "(no span)"
EDGES = "(window edges)"


def program_snapshot() -> Optional[dict]:
    """{"spans": [...], "counters": {...}} as the program recorded them, or
    None where it has no tracer or recorded nothing."""
    try:
        from recsys_examples_torch.utils import observability

        snap = observability.snapshot()
    except (ImportError, AttributeError):
        return None
    return snap if snap.get("spans") or snap.get("counters") else None


def spans_named(snap: Optional[dict], name: str) -> list:
    return [s for s in (snap or {}).get("spans", ()) if s["name"] == name]


def idle_by_span(trace: Trace, known: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Idle seconds of the window by the span charged with them (see the
    module's docstring). `known`: the names that count as the program's
    spans (every host scope when None); an operation's innermost scope among
    them takes its gap."""
    known = None if known is None else set(known)
    out: Dict[str, float] = {}
    end = None
    gaps = 0.0
    for k in sorted(trace.kernels, key=lambda k: k.start_us):
        if end is not None and k.start_us > end:
            scopes = [s for s in k.scopes if known is None or s in known]
            label = scopes[-1] if scopes else NO_SPAN
            gap = (k.start_us - end) * 1e-6
            out[label] = out.get(label, 0.0) + gap
            gaps += gap
        end = k.start_us + k.dur_us if end is None else max(end, k.start_us + k.dur_us)
    rest = trace.window_s - trace.busy_s - gaps
    if rest > 0:
        out[EDGES] = out.get(EDGES, 0.0) + rest
    return out


def idle_ms(r, snap: Optional[dict], prefix: str, per: float) -> Optional[float]:
    """Idle milliseconds charged to the program's spans whose names start
    with `prefix`, over `per` (steps or generates); None where the program
    recorded no such span."""
    if r.trace is None or snap is None or not per:
        return None
    names = {s["name"] for s in snap["spans"]}
    if not any(n.startswith(prefix) for n in names):
        return None
    charged = idle_by_span(r.trace, names)
    return 1e3 * sum(v for k, v in charged.items() if k.startswith(prefix)) / per
