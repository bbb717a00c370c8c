"""`correct` on tiny cells on the CPU, under each cell's own limits: a sound
run passes; a run with its timed path broken underneath fails, once for
each fault the cell can have; the control (the reference with its products'
operands in fp8, in the program's place) fails. The harness's look for a
card is skipped: the program runs its CPU paths."""
import numpy as np
import pytest
import torch

from bench_port import run
from bench_port.core import weights as wts
from bench_port.core.checks import judge, passed
from bench_port.core.runctx import RunContext
from bench_port.drivers import train
from bench_port.families import hstu_ranking, qwen3_sid
from bench_port.tests import tiny
from bench_port.tools import calibrate

SEED = 2**31 + 12345


def test_hstu_sound_run_is_correct():
    res = run.execute(tiny.hstu(), SEED, 0.5, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["train_tokens_per_s"]["value"] > 0


def _unchanged_step(self, batch):
    """A step that returns its state unchanged: the loss is computed, then
    the params and table rows are put back."""
    saved = [p.detach().clone() for p in self.state.model.parameters()]
    tabs = [(s.table.values.clone(), s.table.opt.clone()) for s in self.state.sparse.values()]
    m = self.trainer.train_step(self.state, batch)[1]
    with torch.no_grad():
        for p, s in zip(self.state.model.parameters(), saved):
            p.copy_(s)
        for s, (v, o) in zip(self.state.sparse.values(), tabs):
            s.table.values.copy_(v)
            s.table.opt.copy_(o)
    return m


def _half_batch_stage(orig):
    def stage(self, b):
        return orig(self, hstu_ranking.half_batch(b, self.cfg))
    return stage


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_hstu_faults_are_not_correct(fault, monkeypatch):
    if fault == "unchanged_state":
        monkeypatch.setattr(hstu_ranking.Program, "step", _unchanged_step)
    else:
        monkeypatch.setattr(hstu_ranking.Program, "stage",
                            _half_batch_stage(hstu_ranking.Program.stage))
    res = run.execute(tiny.hstu(), SEED, 0.3, False, device="cpu")
    assert not res["correct"], res["checks"]


def test_hstu_control_is_not_correct():
    c = tiny.hstu()
    ctx = RunContext(workload=c.workload, config=c.config, seed=SEED, seconds=0,
                     trace=False, device="cpu")
    fam, _, pool, _ = train.build(ctx)
    want = train.reference(ctx, fam, pool)
    got = train.reference(ctx, fam, pool, lowp=True)
    numbers = train.compare(got, want, c.workload["exclude_below"])
    numbers["table_overflow"] = 0.0
    assert not passed(judge(numbers, c.workload["limits"])), numbers


@pytest.mark.parametrize("name", ["qwen3_sid_ctx1k", "qwen3_sid_beam256"])
def test_qwen3_sound_run_is_correct(name):
    res = run.execute(tiny.qwen3(name), SEED, 0.5, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", ["qwen3_sid_ctx1k", "qwen3_sid_beam256"])
def test_qwen3_altered_token_is_not_correct(name, monkeypatch):
    """A token altered where it is produced: the engine's last step of each
    request's best path is moved to another token."""
    from recsys_examples_torch.inference.sid_serving.engine import Qwen3ServingEngine

    orig = Qwen3ServingEngine.generate

    def generate(self, contexts):
        paths, scores = orig(self, contexts)
        paths = paths.copy()
        paths[:, 0, -1] = (paths[:, 0, -1] + 1) % self.model.config.vocab_size
        return paths, scores

    monkeypatch.setattr(Qwen3ServingEngine, "generate", generate)
    res = run.execute(tiny.qwen3(name), SEED, 0.3, False, device="cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["qwen3_sid_ctx1k", "qwen3_sid_beam256"])
def test_qwen3_control_is_not_correct(name):
    c = tiny.qwen3(name)
    ctx = RunContext(workload=c.workload, config=c.config, seed=SEED, seconds=0,
                     trace=False, device="cpu")
    readings = dict(calibrate.serve_seed(ctx, control=True, ticks=2))
    assert not passed(judge({k: v for k, v in readings["control"].items()
                             if k in c.workload["limits"]},
                            {"score_gap": c.workload["limits"]["score_gap"]})), readings


def test_weights_repeat_from_the_seed():
    spec = qwen3_sid.param_spec(tiny.qwen3("qwen3_sid_ctx1k").config)
    a = wts.make(spec, SEED, "cpu")
    b = wts.make(spec, SEED, "cpu")
    c = wts.make(spec, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed_tokens.weight"], c["embed_tokens.weight"])


def test_pool_deals_the_same_lengths_to_every_seed():
    c = tiny.hstu()
    p1 = hstu_ranking.make_pool(c.workload, c.config, 1)
    p2 = hstu_ranking.make_pool(c.workload, c.config, SEED)
    l1 = np.sort(np.concatenate([b["hist"] for b in p1]))
    l2 = np.sort(np.concatenate([b["hist"] for b in p2]))
    assert (l1 == l2).all()
    assert not all((a["hist"] == b["hist"]).all() for a, b in zip(p1, p2))
