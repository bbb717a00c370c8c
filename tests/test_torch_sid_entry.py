"""The port's SID-GR training entry against the JAX package's, on tiny gin
files in random and file mode (tests/test_sid_sequence_dataset.py's
`test_entry_file_mode` setup, dropout 0 as both shipped configs): both
`main`s on the CPU, the port from the JAX run's initial params (carried
over by `convert.py`). Held: the `iter i: loss=` lines within 1e-5 (they
print 5 decimals), the final params within rtol 1e-4 and atol 1e-6 (the
attention's key bias, whose gradient is rounding noise, within Adam's step
bound of its start on both sides), and `LAST_EVAL` within 1e-6. Then `sid_eval_metrics` against JAX on paths with
a hit at every rank, and the port's dropout: one generator seeded once, so
two steps draw different masks (the JAX entry passes one key to every
step)."""
import logging
import re

import jax
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.data import sid_sequence_dataset as tds
from recsys_examples_torch.models.sid_gr import SIDGRModel as TModel
from recsys_examples_torch.modules import sid_eval_metrics as t_met
from recsys_examples_torch.modules import transformer as t_transformer
from recsys_examples_torch.training import pretrain_sid_gr as t_sid
from recsys_examples_torch.utils import gin_config as tgin
from recsys_examples_tpu.models.sid_gr import SIDGRModel as JModel
from recsys_examples_tpu.modules import sid_eval_metrics as j_met
from recsys_examples_tpu.training import pretrain_sid_gr as j_sid
from recsys_examples_tpu.utils import gin_config as jgin

PARAM_TOL = dict(rtol=1e-4, atol=1e-6)

TINY = [
    "SIDTrainerArgs.max_train_iters = 3",
    "SIDTrainerArgs.log_interval = 1",
    "SIDTrainerArgs.batch_size = 4",
    "SIDTrainerArgs.max_history_items = 8",
    "SIDTrainerArgs.eval_iters = 2",
    "SIDNetworkArgs.num_hierarchies = 3",
    "SIDNetworkArgs.codebook_size = 8",
    "SIDNetworkArgs.hidden_size = 32",
    "SIDNetworkArgs.num_layers = 1",
    "SIDNetworkArgs.num_heads = 2",
    "SIDNetworkArgs.head_dim = 16",
    "SIDNetworkArgs.ffn_hidden = 64",
    "SIDNetworkArgs.beam_width = 4",
]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def losses(self):
        return [float(x) for line in self.lines
                for x in re.findall(r"^iter \d+: loss=(\S+)", line)]


@pytest.fixture
def lines():
    out = {}
    for pkg in ("recsys_examples_tpu", "recsys_examples_torch"):
        out[pkg] = _Lines()
        logging.getLogger(pkg).addHandler(out[pkg])
    yield out
    for pkg, h in out.items():
        logging.getLogger(pkg).removeHandler(h)


def write_interactions(path, n_users, n_items, seed):
    """tests/test_sid_sequence_dataset.py's interaction log, as csv."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("user_id,item_id,timestamp\n")
        for u in range(n_users):
            for t in np.sort(rng.integers(0, 10_000, size=rng.integers(2, 9))):
                f.write(f"{u},{int(rng.integers(0, n_items))},{int(t)}\n")


def file_gin(tmp_path):
    """tests/test_sid_sequence_dataset.py's file-mode setup: a log through
    the preprocessor, an RQ mapping of 40 items into 8 x 8 x 8."""
    raw, seq = tmp_path / "inter.csv", tmp_path / "seq.npz"
    write_interactions(str(raw), n_users=24, n_items=40, seed=3)
    tds.preprocess_interactions(str(raw), str(seq))
    mapping = tds.build_rq_sid_mapping(np.random.default_rng(0).normal(size=(40, 6)),
                                       [8, 8, 8], iters=5, seed=0)
    np.save(tmp_path / "map.npy", mapping)
    return [f'SIDDatasetArgs.dataset_name = "file"',
            f'SIDDatasetArgs.sequence_path = "{seq}"',
            f'SIDDatasetArgs.sid_mapping_path = "{tmp_path / "map.npy"}"',
            "SIDTrainerArgs.eval_interval = 2"]


@pytest.mark.parametrize("mode", ["random", "file"])
def test_main_matches_jax(tmp_path, monkeypatch, lines, mode):
    cfg = tmp_path / "sid.gin"
    cfg.write_text("\n".join(TINY + (file_gin(tmp_path) if mode == "file" else [])))
    init, run_eval, captured = JModel.init, j_sid.run_eval, {}

    def capture(self, rngs, batch, **kw):
        # jitted: an eager flax init compiles op by op
        out = jax.jit(lambda r, b: init(self, r, b, **kw))(rngs, batch)
        captured["params"] = jax.tree.map(lambda x: np.asarray(x, np.float32), out["params"])
        return out

    def jitted_eval(model, params, ta, na, eval_batches=None):
        """The JAX entry's eval with its beam decode jitted (eager, it takes
        most of the test's time); metrics are held to a tolerance."""
        decode = jax.jit(lambda p, b: model.apply(
            {"params": p}, b, method=JModel.generate_beam_decode))

        class Jitted:
            def apply(self, variables, batch, method):
                return decode(variables["params"], batch)

        return run_eval(Jitted(), params, ta, na, eval_batches=eval_batches)

    monkeypatch.setattr(JModel, "init", capture)
    monkeypatch.setattr(j_sid, "run_eval", jitted_eval)
    jgin.clear_config()
    want = j_sid.main(["--gin-config-file", str(cfg)])
    sd = convert.dense_state_dict(captured["params"])
    monkeypatch.setattr(TModel, "init_weights",
                        lambda self, g: (self.load_state_dict(sd), self)[1])
    tgin.clear_config()
    model = t_sid.main(["--gin-config-file", str(cfg), "--device", "cpu"])
    tgin.clear_config()
    jgin.clear_config()

    got_l = lines["recsys_examples_torch"].losses()
    want_l = lines["recsys_examples_tpu"].losses()
    assert len(got_l) == len(want_l) == 3 and np.isfinite(got_l).all()
    np.testing.assert_allclose(got_l, want_l, rtol=0, atol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(convert.flax_params(model.state_dict())))
    init_p = dict(jax.tree_util.tree_leaves_with_path(captured["params"]))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(got) == len(flat)
    for path, w in flat:
        name = jax.tree_util.keystr(path)
        if name.endswith("['attn']['k']['bias']"):
            # softmax is blind to a shift shared by every key, so this
            # gradient is 0 in exact arithmetic and rounding noise in both
            # packages; Adam scales noise to steps of up to lr each
            for p in (got[path], np.asarray(w)):
                assert np.abs(p - init_p[path]).max() <= 3 * 1e-3 * (1 + 1e-5), name
            continue
        np.testing.assert_allclose(got[path], np.asarray(w), **PARAM_TOL, err_msg=name)
    assert list(t_sid.LAST_EVAL) == list(j_sid.LAST_EVAL) == [
        "recall@1", "ndcg@1", "recall@5", "ndcg@5", "recall@10", "ndcg@10", "mrr"]
    for k, v in j_sid.LAST_EVAL.items():
        np.testing.assert_allclose(t_sid.LAST_EVAL[k], v, rtol=0, atol=1e-6, err_msg=k)
    evals = [line for line in lines["recsys_examples_torch"].lines if line.startswith("eval: ")]
    assert len(evals) == (2 if mode == "file" else 1)
    assert len(t_sid.LAST_STEP_MS) == 3


def test_sid_eval_metrics_match_jax():
    """Paths with the target at every rank 1..W and rows with none."""
    rng = np.random.default_rng(0)
    B, W, H = 12, 10, 3
    paths = rng.integers(0, 5, size=(B, W, H))
    target = rng.integers(5, 9, size=(B, H))       # out of the paths' range
    for b in range(W):
        paths[b, b] = target[b]                       # first hit at rank b + 1
    paths[3, 7] = target[3]                           # a later duplicate hit
    want = j_met.sid_eval_metrics(paths, target, ks=(1, 5, 10))
    got = t_met.sid_eval_metrics(torch.from_numpy(paths), torch.from_numpy(target),
                                 ks=(1, 5, 10))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
    rank = t_met.sid_rank(torch.from_numpy(paths), torch.from_numpy(target))
    assert rank.dtype == torch.int32
    assert rank.tolist() == list(range(1, W + 1)) + [0, 0]
    np.testing.assert_array_equal(rank.numpy(), np.asarray(j_met.sid_rank(paths, target)))


def test_two_steps_draw_different_dropout_masks(tmp_path, monkeypatch):
    """At dropout > 0 the entry's generator is seeded once, so the second
    step's masks differ from the first's (the JAX entry reuses one key)."""
    masks = []
    real = t_transformer.apply_dropout

    def spy(x, rate, generator, *a, **kw):
        out = real(x, rate, generator, *a, **kw)
        masks.append((out != 0) | (x == 0))
        return out

    monkeypatch.setattr(t_transformer, "apply_dropout", spy)
    cfg = tmp_path / "sid.gin"
    cfg.write_text("\n".join(TINY + ["SIDTrainerArgs.max_train_iters = 2",
                                     "SIDNetworkArgs.dropout = 0.3"]))
    tgin.clear_config()
    t_sid.main(["--gin-config-file", str(cfg), "--device", "cpu"])
    tgin.clear_config()
    per_step = len(masks) // 2
    assert per_step == 2       # one layer: after attention and after the FFN
    for a, b in zip(masks[:per_step], masks[per_step:]):
        assert a.shape == b.shape and not torch.equal(a, b)
        kept = a.float().mean().item()
        assert 0.5 < kept < 0.9
