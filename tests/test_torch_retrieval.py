"""Two-tower retrieval of the PyTorch port against the JAX package, in fp32:
the retrieval view of MovieLens and ``synthesize_ml1m``'s rank-power corpus
(equal array for array, before any model runs); ``DeviceData`` with dict
and None labels; the ops of ``ops/retrieval.py``; the in-batch loss and its
gradients in every option combination; ``Tower`` and ``TwoTower`` through
``two_tower_from_flax``; ``retrieval_loss`` with its three label forms,
``RetrievalEval``; ``Adagrad`` against ``optax.adagrad``; an epoch of
``fit_device`` with dict labels against JAX's ``Trainer``; the ported
example at a tiny size; and the parts that raise until the port has its
parallelism.

Tolerances: fp32 on both sides, sums in other orders. Losses and tower
outputs rtol 1e-5; gradients as ``test_torch_ranking.assert_grads_close``
(rtol 1e-4, and 1e-6 of the largest gradient of their tensor); the ops'
outputs rtol 1e-6 (one fp32 operation on the same inputs, or exact);
Adagrad's weights and accumulators rtol 1e-6 after five steps (the same
fp32 operations in optax's order; rsqrt may differ by an ulp); an epoch of
fit_device: losses, final weights and val_loss rtol 1e-4 (the trajectories
drift apart by roundings step by step), in-batch accuracies within one hit
in 10^3. Hard-negative mining keeps the top k of each row, so its cases
check first that no two scores at the k-th place lie within the fp32
roundings (the data is tie-free there).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_recommenders_torch import convert
from deep_recommenders_torch.datasets import movielens as t_ml
from deep_recommenders_torch.examples import train_two_tower_on_movielens
from deep_recommenders_torch.models import retrieval as tret
from deep_recommenders_torch.ops import retrieval as tops
from deep_recommenders_torch.training import (
    Adagrad,
    DeviceData,
    RetrievalEval,
    Trainer,
    retrieval_loss,
)
from deep_recommenders_tpu.datasets import movielens as j_ml
from deep_recommenders_tpu.models import retrieval as jret
from deep_recommenders_tpu.ops import retrieval as jops
from deep_recommenders_tpu.training import evaluation as j_eval
from deep_recommenders_tpu.training.data import DeviceData as JDeviceData
from deep_recommenders_tpu.training.data import gather_rows as j_gather
from deep_recommenders_tpu.training.trainer import Trainer as JTrainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ranking as base  # noqa: E402

torch.set_num_threads(1)

B, D, HIDDEN, OUT = 32, 8, (12,), 6
USER_KEYS = ("user_id", "user_gender", "user_age", "user_occupation")
ITEM_KEYS = ("movie_id", "movie_genres", "movie_genres__wt")


def t(x):
    return torch.from_numpy(np.array(x))


# -- data ---------------------------------------------------------------------

def test_rank_power_corpus_equals_jax_exactly():
    """synthesize_ml1m's rank-power branch consumes the generator as JAX's:
    every column equal, and other than the Zipf corpus."""
    got = t_ml.synthesize_ml1m(3000, seed=7, movie_popularity="rank-power")
    want = j_ml.synthesize_ml1m(3000, seed=7, movie_popularity="rank-power")
    zipf = t_ml.synthesize_ml1m(3000, seed=7)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert not np.array_equal(got["MovieID"], zipf["MovieID"])
    with pytest.raises(ValueError):
        t_ml.synthesize_ml1m(10, movie_popularity="uniform")


def test_retrieval_view_equals_jax_exactly():
    """The retrieval view of the rank-power corpus: each split's pair arrays
    (the movie_genres__wt weights with the movie side), ids, raw MovieIDs,
    the shuffled batches, the two towers' specs."""
    kw = dict(batch_size=64, num_ratings=5000, seed=3,
              movie_popularity="rank-power")
    got = t_ml.MovielensRanking(**kw)
    want = j_ml.MovielensRanking(cache_dir=None, **kw)
    for split in ("train", "test"):
        g_user, g_item, g_ids = got.retrieval_arrays(split)
        w_user, w_item, w_ids = want.retrieval_arrays(split)
        assert tuple(g_user) == tuple(w_user) == USER_KEYS
        assert tuple(g_item) == tuple(w_item) == ITEM_KEYS
        for g, w in ((g_user, w_user), (g_item, w_item)):
            for key in w:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        np.testing.assert_array_equal(g_ids, w_ids)
        np.testing.assert_array_equal(got.raw_movie_ids(split),
                                      want.raw_movie_ids(split))
    got_b = list(got.retrieval_batches(epochs=2, shuffle_seed=5))
    want_b = list(want.retrieval_batches(epochs=2, shuffle_seed=5))
    assert len(got_b) == len(want_b) > 2
    for (gu, gi), (wu, wi) in zip(got_b, want_b):
        for g, w in ((gu, wu), (gi, wi)):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])
    test_b = list(got.retrieval_batches(split="test"))
    for (gu, _), (wu, _) in zip(test_b,
                                want.retrieval_batches(split="test")):
        np.testing.assert_array_equal(gu["user_id"], wu["user_id"])
    assert [f.name for f in got.user_specs()] == list(USER_KEYS)
    assert [f.name for f in got.item_specs()] == list(ITEM_KEYS[:2])


@pytest.mark.parametrize("labels", ["dict", "none"])
def test_device_data_with_dict_and_no_labels(rng, labels):
    """Labels as a dict of arrays (the example's candidate ids and sampling
    probabilities) or None: rows gathered as JAX's gather_rows gathers
    them; the example count from the labels, else the features."""
    user = {"user_id": rng.integers(0, 9, 40).astype(np.int32)}
    item = {"movie_id": rng.integers(0, 9, 40).astype(np.int32)}
    lab = {"candidate_ids": item["movie_id"],
           "sampling_prob": rng.random(40).astype(np.float32)}
    lab = lab if labels == "dict" else None
    data = DeviceData.from_numpy((user, item), lab, 8, device="cpu")
    assert data.num_examples == 40 and data.steps_per_epoch == 5
    assert data.device == torch.device("cpu")
    rows = np.array([3, 0, 39, 7], np.int64)
    got_f, got_l = data.gather(t(rows))
    want_f, want_l = j_gather((user, item), lab, jnp.asarray(rows))
    np.testing.assert_array_equal(got_f[1]["movie_id"].numpy(),
                                  want_f[1]["movie_id"])
    if labels == "none":
        assert got_l is None and want_l is None
    else:
        for key in lab:
            np.testing.assert_array_equal(got_l[key].numpy(), want_l[key])


# -- ops ----------------------------------------------------------------------

def test_ops_match_jax(rng):
    """hard_negative_mining, remove_accidental_negatives and
    sampling_probability_correction on the same inputs: exact, but for the
    log's rounding (rtol 1e-6)."""
    b, n = 6, 20
    logits = rng.normal(size=(b, n)).astype(np.float32)
    labels = np.eye(b, n, dtype=np.float32)
    for num in (4, 30):
        got = tops.hard_negative_mining(t(logits), t(labels), num)
        want = jops.hard_negative_mining(jnp.asarray(logits),
                                         jnp.asarray(labels), num)
        assert got[0].shape == (b, min(num + 1, n))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids = np.array([7, 8, 7, 9, 8, 1], np.int32)
    sq = logits[:, :b]
    got = tops.remove_accidental_negatives(t(sq), t(labels[:, :b]), t(ids))
    want = jops.remove_accidental_negatives(
        jnp.asarray(sq), jnp.asarray(labels[:, :b]), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 2] < -1e35 and got[2, 0] < -1e35 and got[1, 4] < -1e35
    np.testing.assert_array_equal(np.diag(got.numpy()), np.diag(sq))
    p = rng.random(n).astype(np.float32) * 0.5
    p[3] = 0.0  # clamped at 1e-12
    got = tops.sampling_probability_correction(t(logits), t(p))
    want = jops.sampling_probability_correction(jnp.asarray(logits),
                                                jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert tops.MAX_FLOAT == float(jops.MAX_FLOAT)
    assert tops.MIN_FLOAT == float(jops.MIN_FLOAT)


def test_loss_removes_accidental_negatives_without_labels(rng):
    """The loss's accidental-negative step, which reads the diagonal and
    builds no label matrix, equals remove_accidental_negatives with labels =
    eye bit for bit, on ids with duplicates."""
    b = 12
    logits = rng.normal(size=(b, b)).astype(np.float32)
    ids = rng.integers(0, 4, b).astype(np.int32)
    want = tops.remove_accidental_negatives(
        t(logits), torch.eye(b), t(ids))
    got = tops._remove_diagonal_duplicates(t(logits), t(ids))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (got.numpy() < -1e35).sum() == (
        (ids[:, None] == ids[None, :]).sum() - b) > 0


# name -> the loss's options (ids, p, sw stand for the arrays).
LOSS_OPTIONS = {
    "plain": {},
    "logq": {"candidate_sampling_probability": "p"},
    "accidental": {"candidate_ids": "ids"},
    "hard": {"num_hard_negatives": 5},
    "temperature": {"temperature": 0.1},
    "sample_weight": {"sample_weight": "sw"},
    "accidental_temperature": {"candidate_ids": "ids", "temperature": 0.1},
    "hard_accidental_logq": {"candidate_ids": "ids", "num_hard_negatives": 3,
                             "candidate_sampling_probability": "p"},
    "all": {"candidate_ids": "ids", "num_hard_negatives": 4,
            "candidate_sampling_probability": "p", "sample_weight": "sw",
            "temperature": 0.2},
}


def loss_inputs(rng, b=B, d=16):
    q = rng.normal(size=(b, d)).astype(np.float32)
    c = rng.normal(size=(b, d)).astype(np.float32)
    arrays = {"ids": rng.integers(0, 8, b).astype(np.int32),
              "p": (rng.random(b) * 0.1 + 1e-3).astype(np.float32),
              "sw": rng.random(b).astype(np.float32)}
    return q, c, arrays


def assert_hard_negatives_tie_free(q, c, arrays, kw):
    """Test-data precondition for hard-negative mining: each row's k-th and
    (k+1)-th adjusted scores (fp64) lie farther apart than 4 D u max
    sum|q c| (the two sides' fp32 scores may each miss by D u sum|q c|)."""
    k = kw.get("num_hard_negatives")
    if k is None:
        return
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    s = q64 @ c64.T
    if "candidate_sampling_probability" in kw:
        s = s - np.log(arrays["p"].astype(np.float64))
    if "candidate_ids" in kw:
        ids = arrays["ids"]
        s = np.where(ids[:, None] == ids[None, :], -1e30, s)
    s = s + np.eye(len(s)) * 1e30
    top = -np.sort(-s, axis=1)[:, k:k + 2]
    gap = 4 * q.shape[1] * 2.0**-24 * (np.abs(q64) @ np.abs(c64).T).max()
    assert (top[:, 0] - top[:, 1] > gap).all(), "the test data has a tie"


@pytest.mark.parametrize("name", sorted(LOSS_OPTIONS))
def test_in_batch_loss_and_grads_match_jax(rng, name):
    """The loss and its gradients in q and c against JAX's, each option
    combination; finite (the MIN_FLOAT entries over a temperature of 0.1
    are about -3.4e37)."""
    q, c, arrays = loss_inputs(rng)
    kw = LOSS_OPTIONS[name]
    assert_hard_negatives_tie_free(q, c, arrays, kw)
    j_kw = {k: jnp.asarray(arrays[v]) if isinstance(v, str) else v
            for k, v in kw.items()}
    t_kw = {k: t(arrays[v]) if isinstance(v, str) else v
            for k, v in kw.items()}
    want, (want_q, want_c) = jax.value_and_grad(
        lambda a, b: jops.in_batch_retrieval_loss(a, b, **j_kw),
        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(c))
    tq, tc = t(q).requires_grad_(), t(c).requires_grad_()
    loss = tops.in_batch_retrieval_loss(tq, tc, **t_kw)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    base.assert_grads_close({"q": tq.grad.numpy(), "c": tc.grad.numpy()},
                            {"q": t(want_q), "c": t(want_c)})


# -- towers -------------------------------------------------------------------

def tower_batches(rng, b=B):
    batch, _ = base.make_batch(rng, b)
    user = {k: batch[k] for k in USER_KEYS}
    item = {k: batch[k] for k in ITEM_KEYS}
    return user, item


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: t(v) for k, v in batch.items()}


def flax_two_tower(rng, user, item, l2_normalize=True):
    """flax's TwoTower and its initial weights, biases drawn normal (flax
    zero-initialises them) so that they count."""
    specs = j_ml.default_movielens_features()
    model = jret.TwoTower(specs[:4], specs[4:], embedding_dim=D,
                          hidden=HIDDEN, output_dim=OUT,
                          l2_normalize=l2_normalize)
    params = jax.tree.map(np.array, model.init(jax.random.PRNGKey(0),
                                               jb(user), jb(item)))

    def fill(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                fill(value)
            elif key == "bias":
                tree[key] = rng.normal(0, 0.3, value.shape).astype(
                    np.float32)

    fill(params["params"])
    return model, params


def port_two_tower(params, l2_normalize=True):
    specs = t_ml.default_movielens_features()
    model = tret.TwoTower(specs[:4], specs[4:], embedding_dim=D,
                          hidden=HIDDEN, output_dim=OUT,
                          l2_normalize=l2_normalize)
    model.load_state_dict(convert.two_tower_from_flax(params))
    return model


@pytest.mark.parametrize("l2_normalize", [True, False])
def test_towers_match_flax(rng, l2_normalize):
    """Each tower's output (a single Tower's as well) and the gradients of
    a weighted sum of both against flax, through two_tower_from_flax."""
    user, item = tower_batches(rng)
    j_model, params = flax_two_tower(rng, user, item, l2_normalize)
    t_model = port_two_tower(params, l2_normalize)
    wq = rng.normal(size=(B, OUT)).astype(np.float32)
    wc = rng.normal(size=(B, OUT)).astype(np.float32)

    def j_obj(p):
        qe, ce = j_model.apply(p, jb(user), jb(item))
        return jnp.sum(qe * wq) + jnp.sum(ce * wc)

    want_q, want_c = j_model.apply(params, jb(user), jb(item))
    want_grads = jax.grad(j_obj)(params)
    qe, ce = t_model(tb(user), tb(item))
    for g, w in ((qe, want_q), (ce, want_c)):
        assert g.shape == (B, OUT) and g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    if l2_normalize:
        np.testing.assert_allclose(qe.detach().norm(dim=-1).numpy(), 1.0,
                                   rtol=1e-6)
    ((qe * t(wq)).sum() + (ce * t(wc)).sum()).backward()
    base.assert_grads_close(base.torch_grads(t_model),
                            convert.two_tower_from_flax(
                                jax.tree.map(np.asarray, want_grads)))
    # One tower alone, as flax's Tower.
    specs = t_ml.default_movielens_features()
    tower = tret.Tower(specs[4:], D, HIDDEN, OUT, l2_normalize)
    j_tower = jret.Tower(j_ml.default_movielens_features()[4:], D, HIDDEN,
                         OUT, l2_normalize)
    tower_params = {"params": params["params"]["candidate_tower"]}
    tower.load_state_dict(convert.two_tower_from_flax(tower_params))
    np.testing.assert_allclose(
        tower(tb(item)).detach().numpy(),
        np.asarray(j_tower.apply(tower_params, jb(item))), rtol=1e-5,
        atol=1e-6)


LABEL_FORMS = ("none", "ids", "dict")


def _labels(form, item, rng):
    ids = item["movie_id"] % 7  # duplicates in the batch
    if form == "none":
        return None
    if form == "ids":
        return ids
    return {"candidate_ids": ids,
            "sampling_prob": (rng.random(B) * 0.1 + 1e-3).astype(np.float32)}


def _j_labels(labels):
    if isinstance(labels, dict):
        return {k: jnp.asarray(v) for k, v in labels.items()}
    return None if labels is None else jnp.asarray(labels)


def _t_labels(labels):
    if isinstance(labels, dict):
        return {k: t(v) for k, v in labels.items()}
    return None if labels is None else t(labels)


@pytest.mark.parametrize("form", LABEL_FORMS)
def test_retrieval_loss_label_forms_match_jax(rng, form):
    """retrieval_loss on a TwoTower with Retrieval(temperature=0.2,
    remove_accidental_negatives=...) for each label form: None (plain),
    candidate ids, and {"candidate_ids", "sampling_prob"} (log-Q): the loss
    and every gradient against JAX's."""
    user, item = tower_batches(rng)
    labels = _labels(form, item, rng)
    j_model, params = flax_two_tower(rng, user, item)
    t_model = port_two_tower(params)
    remove = form != "none"
    j_task = jret.Retrieval(temperature=0.2,
                            remove_accidental_negatives=remove)
    t_task = tret.Retrieval(temperature=0.2,
                            remove_accidental_negatives=remove)
    j_fn = j_eval.retrieval_loss(j_model, j_task)
    want, want_grads = jax.value_and_grad(
        lambda p: j_fn(p, (jb(user), jb(item)), _j_labels(labels)))(params)
    loss = retrieval_loss(t_model, t_task)((tb(user), tb(item)),
                                           _t_labels(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    base.assert_grads_close(base.torch_grads(t_model),
                            convert.two_tower_from_flax(
                                jax.tree.map(np.asarray, want_grads)))


def test_retrieval_eval_matches_jax(rng):
    """RetrievalEval over two batches: val_loss (the task's loss without
    accidental-negative removal, per example) and the in-batch top-k
    accuracies against JAX's (hit counts equal)."""
    user, item = tower_batches(rng, 2 * B)
    j_model, params = flax_two_tower(rng, user, item)
    t_model = port_two_tower(params)
    task = dict(temperature=0.5, remove_accidental_negatives=True)
    j_spec = j_eval.RetrievalEval(j_model, jret.Retrieval(**task))
    t_spec = RetrievalEval(t_model, tret.Retrieval(**task))
    state, j_state = t_spec.init(), j_spec.init()
    for rows in (slice(0, B), slice(B, 2 * B)):
        u = {k: v[rows] for k, v in user.items()}
        i = {k: v[rows] for k, v in item.items()}
        state = t_spec.update((tb(u), tb(i)), None, state)
        j_state = j_spec.update(params, (jb(u), jb(i)), None, j_state)
    np.testing.assert_array_equal(state["topk"]["hits"].numpy(),
                                  np.asarray(j_state["topk"]["hits"]))
    got, want = t_spec.compute(state), j_spec.compute(j_state)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    for key in want:
        if key != "val_loss":
            assert got[key] == pytest.approx(want[key], abs=1e-7), key


# -- the optimizer ------------------------------------------------------------

@pytest.mark.parametrize("initial", [0.1, 0.0])
def test_adagrad_matches_optax(rng, initial):
    """Five steps of Adagrad(0.05) against optax.adagrad on seeded
    gradients (some exactly 0: with an initial accumulator of 0 those
    elements stay put, optax's where(acc > 0, ...)): weights and
    accumulators; a state_dict round trip resumes the same run bit for
    bit."""
    shapes = {"a": (5, 3), "b": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              * (rng.random(s) < 0.7) for k, s in shapes.items()}
             for _ in range(5)]
    opt = optax.adagrad(0.05, initial_accumulator_value=initial)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = opt.init(j_params)
    for g in grads:
        updates, j_state = opt.update({k: jnp.asarray(v)
                                       for k, v in g.items()}, j_state)
        j_params = optax.apply_updates(j_params, updates)

    def run(steps, state=None):
        ps = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
        o = Adagrad(list(ps.values()), 0.05,
                    initial_accumulator_value=initial)
        if state is not None:
            for p, v in zip(ps.values(), state[0].values()):
                p.data.copy_(v)
            o.load_state_dict(state[1])
        for g in steps:
            for k, p in ps.items():
                p.grad = t(g[k])
            o.step()
        return ps, o

    ps, o = run(grads)
    for i, k in enumerate(shapes):
        np.testing.assert_allclose(ps[k].detach().numpy(),
                                   np.asarray(j_params[k]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(
            o.state[ps[k]]["sum_of_squares"].numpy(),
            np.asarray(j_state[0].sum_of_squares[k]), rtol=1e-6)
    first, o_first = run(grads[:2])
    saved = ({k: p.detach().clone() for k, p in first.items()},
             o_first.state_dict())
    resumed, _ = run(grads[2:], saved)
    for k in shapes:
        assert torch.equal(resumed[k], ps[k])


# -- training -----------------------------------------------------------------

TT_BATCH = 128


def _tt_data(ds, split):
    user, item, ids = ds.retrieval_arrays(split)
    _, inverse, counts = np.unique(ids, return_inverse=True,
                                   return_counts=True)
    labels = {"candidate_ids": ids,
              "sampling_prob": (counts[inverse] / len(ids)).astype(
                  np.float32)}
    return (user, item), labels


@pytest.fixture(scope="module")
def jax_tt_epoch():
    """One JAX fit_device epoch of the example's setup (Adagrad 0.05,
    temperature 0.1, accidental negatives removed, log-Q) on a small
    rank-power corpus with dict labels: the initial and final weights and
    the epoch's summary."""
    ds = j_ml.MovielensRanking(batch_size=TT_BATCH, num_ratings=8000, seed=42,
                               movie_popularity="rank-power", cache_dir=None)
    model = jret.TwoTower(ds.user_specs(), ds.item_specs(), embedding_dim=D,
                          hidden=HIDDEN, output_dim=OUT)
    task = jret.Retrieval(temperature=0.1, remove_accidental_negatives=True)
    trainer = JTrainer(model, optax.adagrad(0.05),
                       loss_fn=j_eval.retrieval_loss(model, task),
                       eval_spec=j_eval.RetrievalEval(model, task), seed=0)
    train = JDeviceData.from_numpy(*_tt_data(ds, "train"), TT_BATCH)
    test = JDeviceData.from_numpy(*_tt_data(ds, "test"), TT_BATCH)
    init = trainer.init(train.gather(train.permutation(None, 0)[:TT_BATCH])[0])
    result = trainer.fit_device(train, test, epochs=1, shuffle_seed=7,
                                verbose=False)
    return (jax.tree.map(np.asarray, init.params),
            jax.tree.map(np.asarray, result["state"].params),
            result["history"][0])


def test_fit_device_epoch_with_dict_labels_matches_jax(jax_tt_epoch):
    """The same epoch in the port from the same initial weights: the last
    step's loss, the final weights, val_loss and the in-batch accuracies."""
    init, final, want = jax_tt_epoch
    ds = t_ml.MovielensRanking(batch_size=TT_BATCH, num_ratings=8000, seed=42,
                               movie_popularity="rank-power")
    model = tret.TwoTower(ds.user_specs(), ds.item_specs(), embedding_dim=D,
                          hidden=HIDDEN, output_dim=OUT)
    model.load_state_dict(convert.two_tower_from_flax(init))
    task = tret.Retrieval(temperature=0.1, remove_accidental_negatives=True)
    trainer = Trainer(model, Adagrad(model.parameters(), 0.05),
                      loss_fn=retrieval_loss(model, task),
                      eval_spec=RetrievalEval(model, task), device="cpu")
    train = DeviceData.from_numpy(*_tt_data(ds, "train"), TT_BATCH,
                                  device="cpu")
    test = DeviceData.from_numpy(*_tt_data(ds, "test"), TT_BATCH,
                                 device="cpu")
    result = trainer.fit_device(train, test, epochs=1, shuffle_seed=7,
                                verbose=False)
    got = result["history"][0]
    assert len(result["step_losses"]) == train.steps_per_epoch > 10
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    for key in want:
        if key.startswith("top_"):
            assert got[key] == pytest.approx(want[key], abs=1e-3), key
    for name, value in convert.two_tower_from_flax(final).items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   value.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_two_tower_example_on_the_cpu(capsys):
    """The ported example at a tiny size: its epochs' val_loss finite, the
    full-corpus accuracies in [0, 1] and rising with k, the corpus size
    and the chance rate printed."""
    result = train_two_tower_on_movielens.main([
        "--num-ratings", "6000", "--epochs", "2", "--batch-size", "128",
        "--embedding-dim", "8", "--output-dim", "8", "--device", "cpu"])
    assert len(result["history"]) == 2
    assert all(np.isfinite(h["val_loss"]) for h in result["history"])
    acc = [result["metrics"][f"top_{k}_categorical_accuracy"]
           for k in (1, 5, 10, 50, 100)]
    assert all(0.0 <= a <= 1.0 for a in acc) and acc == sorted(acc)
    text = capsys.readouterr().out
    assert f"N = {result['corpus_size']} movies" in text
    assert "val_loss by epoch" in text and "retrieval metrics" in text


def test_parts_without_parallelism_raise(monkeypatch):
    """Pod-wide negatives and the meshed towers need a mesh: ``axis_name``
    without one takes the default mesh, which needs a process group
    (RuntimeError here; tests/test_torch_parallel_models.py runs them on
    one), and anything but a ("data", "model") DeviceMesh is refused with
    TypeError; accidental-negative removal without ids and a compute dtype
    other than bf16 raise ValueError, as JAX's; the example runs on the
    card by default, which raises without one."""
    q = torch.zeros(4, 3)
    with pytest.raises(RuntimeError, match="process group"):
        tret.Retrieval(axis_name="data")(q, q)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tret.Retrieval(axis_name="data", mesh=object())(q, q)
    with pytest.raises(RuntimeError, match="process group"):
        tops.in_batch_retrieval_loss(q, q, axis_name="data")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tops.pod_retrieval_loss(q, q, object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tret.TwoTower(t_ml.default_movielens_features()[:1],
                      t_ml.default_movielens_features()[4:5], mesh=object())
    with pytest.raises(ValueError):
        tret.Retrieval(remove_accidental_negatives=True)(q, q)
    with pytest.raises(ValueError):
        tret.Retrieval(compute_dtype=torch.float16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_two_tower_on_movielens.main(["--num-ratings", "100"])
