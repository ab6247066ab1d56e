"""The port's ``AUC(from_logits=)`` and ``BinaryCTREval(auc=, pr=)``
against the JAX package's, on the CPU, on inputs drawn by numpy from a
seed: the metric states (integer counts in fp32) equal, the summaries to
fp32 roundoff. The meshed merge of a non-default metric runs in
tests/test_torch_bf16_table.py's two gloo processes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_recommenders_torch.convert import deepfm_from_flax
from deep_recommenders_torch.datasets.movielens import (
    default_movielens_features as t_features,
)
from deep_recommenders_torch.models.ranking import DeepFM as TDeepFM
from deep_recommenders_torch.training import metrics as tm
from deep_recommenders_torch.training.evaluation import (
    BinaryCTREval as TBinaryCTREval,
)
from deep_recommenders_tpu.datasets.movielens import (
    default_movielens_features as j_features,
)
from deep_recommenders_tpu.models.ranking import DeepFM as JDeepFM
from deep_recommenders_tpu.training import metrics as jm
from deep_recommenders_tpu.training.evaluation import (
    BinaryCTREval as JBinaryCTREval,
)

torch.set_num_threads(1)

B, D, HIDDEN = 96, 8, (16, 8)


def _scores(rng, n=500):
    labels = (rng.random(n) < 0.4).astype(np.float32)
    logits = (rng.normal(0, 2.5, n) + 1.5 * labels).astype(np.float32)
    return labels, logits


def _t_state(state):
    return {k: v.numpy() for k, v in state.items()}


def _j_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_auc_fields_are_jax_s():
    assert ([f.name for f in dataclasses.fields(tm.AUC)]
            == [f.name for f in dataclasses.fields(jm.AUC)]
            == ["num_thresholds", "from_logits"])
    assert tm.AUC() == tm.AUC(200, False)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tm.AUC().from_logits = True


@pytest.mark.parametrize("from_logits", [False, True])
@pytest.mark.parametrize("num_thresholds", [200, 500])
def test_auc_update_and_compute_match_jax(from_logits, num_thresholds):
    """From logits, the sigmoid inside the update; from probabilities
    (some pushed past [0, 1], which the update clips), as they are."""
    rng = np.random.default_rng(num_thresholds + from_logits)
    labels, logits = _scores(rng)
    if from_logits:
        preds = logits
    else:
        preds = (1 / (1 + np.exp(-logits))).astype(np.float32)
        preds[:10] += 0.5
        preds[10:20] -= 0.5
    t_auc = tm.AUC(num_thresholds, from_logits)
    j_auc = jm.AUC(num_thresholds, from_logits)
    got = t_auc.update(t_auc.init(), torch.from_numpy(labels),
                       torch.from_numpy(preds[:, None]))
    want = j_auc.update(j_auc.init(), jnp.asarray(labels),
                        jnp.asarray(preds[:, None]))
    _assert_states_equal(_t_state(got), _j_state(want))
    np.testing.assert_allclose(float(t_auc.compute(got)),
                               float(j_auc.compute(want)), rtol=1e-6)


@pytest.mark.parametrize("from_logits", [False, True])
def test_auc_merge_of_two_states_matches_jax(from_logits):
    rng = np.random.default_rng(40 + from_logits)
    t_auc, j_auc = tm.AUC(300, from_logits), jm.AUC(300, from_logits)
    parts = []
    for _ in range(2):
        labels, logits = _scores(rng, 300)
        preds = logits if from_logits else 1 / (1 + np.exp(-logits))
        preds = preds.astype(np.float32)
        parts.append((
            t_auc.update(t_auc.init(), torch.from_numpy(labels),
                         torch.from_numpy(preds)),
            j_auc.update(j_auc.init(), jnp.asarray(labels),
                         jnp.asarray(preds))))
    got = t_auc.merge(parts[0][0], parts[1][0])
    want = j_auc.merge(parts[0][1], parts[1][1])
    _assert_states_equal(_t_state(got), _j_state(want))
    np.testing.assert_allclose(float(t_auc.compute(got)),
                               float(j_auc.compute(want)), rtol=1e-6)


def test_auc_from_logits_is_auc_of_the_sigmoid():
    labels, logits = _scores(np.random.default_rng(5))
    y, z = torch.from_numpy(labels), torch.from_numpy(logits)
    a = tm.AUC(from_logits=True)
    b = tm.AUC()
    got = a.update(a.init(), y, z)
    want = b.update(b.init(), y, torch.sigmoid(z))
    _assert_states_equal(_t_state(got), _t_state(want))
    # raw logits through the clipping update give another, wrong, value
    clipped = b.update(b.init(), y, z)
    assert float(b.compute(clipped)) != float(b.compute(want))


def _batch(rng, b=B):
    feats = {
        "user_id": rng.integers(0, 6040, b),
        "user_gender": rng.integers(0, 3, b),
        "user_age": rng.integers(0, 8, b),
        "user_occupation": rng.integers(0, 22, b),
        "movie_id": rng.integers(0, 3952, b),
        "movie_genres": rng.integers(0, 19, (b, 6)),
    }
    feats = {k: v.astype(np.int32) for k, v in feats.items()}
    feats["movie_genres__wt"] = (rng.random((b, 6)) < 0.5).astype(np.float32)
    labels = (rng.random((b, 1)) < 0.5).astype(np.float32)
    return feats, labels


def test_binary_ctr_eval_defaults_are_jax_s():
    model = TDeepFM(t_features(), D, HIDDEN)
    spec = TBinaryCTREval(model)
    assert spec.auc == tm.AUC() and spec.pr == tm.PrecisionRecall()
    custom = TBinaryCTREval(model, auc=tm.AUC(num_thresholds=500),
                            pr=tm.PrecisionRecall(threshold=0.3))
    assert custom.auc.num_thresholds == 500 and custom.pr.threshold == 0.3


def test_binary_ctr_eval_with_non_default_metrics_matches_jax():
    """``AUC(num_thresholds=500)`` and ``PrecisionRecall(threshold=0.3)``
    over two batches on converted DeepFM weights: the merged state's AUC
    and P/R counts equal JAX's, the summary to fp32 roundoff."""
    rng = np.random.default_rng(11)
    batches = [_batch(rng) for _ in range(2)]
    j_model = JDeepFM(j_features(), embedding_dim=D, hidden=HIDDEN)
    params = j_model.init(jax.random.PRNGKey(0), {
        k: jnp.asarray(v) for k, v in batches[0][0].items()})
    params = jax.tree.map(np.asarray, params)
    lin = params["params"]["linear"]
    for k in ("weights", "bias"):
        lin[k] = rng.normal(0, 0.5, lin[k].shape).astype(np.float32)
    t_model = TDeepFM(t_features(), D, HIDDEN)
    t_model.load_state_dict(deepfm_from_flax(params))
    t_eval = TBinaryCTREval(t_model, auc=tm.AUC(num_thresholds=500),
                            pr=tm.PrecisionRecall(threshold=0.3))
    j_eval = JBinaryCTREval(j_model, auc=jm.AUC(num_thresholds=500),
                            pr=jm.PrecisionRecall(threshold=0.3))
    t_state, j_state = t_eval.init(), j_eval.init()
    for feats, labels in batches:
        t_state = t_eval.update({k: torch.from_numpy(v)
                                 for k, v in feats.items()},
                                torch.from_numpy(labels), t_state)
        j_state = j_eval.update(params, {k: jnp.asarray(v)
                                         for k, v in feats.items()},
                                jnp.asarray(labels), j_state)
    for part in ("auc", "pr"):
        _assert_states_equal(_t_state(t_state[part]),
                             _j_state(j_state[part]))
    got, want = t_eval.compute(t_state), j_eval.compute(j_state)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert 0.0 < got["precision"] < 1.0 and got["auc"] != 0.5
