"""dynamicemb/: device milliseconds of phases A and C (every dynamic table's
forward and backward, CUDA events around each call) per train step."""


def read(r):
    calls = [v for k, v in r.spans.items()
             if k.endswith(".forward") or k.endswith(".backward")]
    steps = r.counters.get("span_steps", 0)
    if not steps or not any(calls):
        return None
    return sum(sum(v) for v in calls) / steps
