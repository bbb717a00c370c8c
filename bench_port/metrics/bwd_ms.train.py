"""Trainer (`GRTrainer.train_step`, span `train/backward`): device
milliseconds of the operations launched while the host ran the backward
pass and the gradient reduction, autograd's own thread included, per
profiled train step (the program's `train/step` spans)."""
from bench_port.core.attribution import program_snapshot, spans_named


def read(r):
    steps = len(spans_named(program_snapshot(), "train/step"))
    if r.trace is None or not steps:
        return None
    return 1e3 * r.trace.device_seconds(scope_prefix="train/backward") / steps
