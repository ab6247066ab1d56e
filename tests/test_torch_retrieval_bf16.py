"""The two-tower loss with ``compute_dtype=torch.bfloat16`` against JAX's
``compute_dtype=jnp.bfloat16``, with each rounding site pinned.

JAX computes the score product as ``einsum(q.astype(bf16), c.astype(bf16),
preferred_element_type=float32)``: the operands rounded to bf16, exact
products, unrounded fp32 sums; its transpose rounds each operand's
gradient to bf16 before the cast back to fp32. The port multiplies the
bf16-rounded operands in fp32 (``ops/retrieval._scores``), and autograd
rounds the gradients at the casts. JAX's side runs in a subprocess with
``--xla_allow_excess_precision=false`` (otherwise XLA on the CPU may skip
a bf16 rounding that feeds a dot), as ``test_torch_din.py`` does.

Bounds, both sides summing the same exact products in other orders:
- the loss within rtol 2e-6, about B u (u = 2^-24, B = 32 rows summed
  after each row's own fp32 sums; the differences seen are a few ulps);
- each operand's gradient a bf16 value, as JAX's, equal to JAX's but for
  at most 2% of the elements (where the two fp32 sums before the rounding
  straddle a bf16 rounding boundary), and those within one bf16 step.
Pinned: the port with its scores rounded to bf16 (a bf16 matmul's output)
or with fp32 operands misses JAX's loss by more than 10 times that;
with the operands rounded but the gradient left unrounded (a
straight-through cast) its gradients are not bf16 values, and more than
half of their elements differ from JAX's.
The whole TwoTower in bf16 (``Retrieval(compute_dtype=bfloat16)``): the
loss to rtol 1e-5, and every gradient within 2^-12 of JAX's by relative
Frobenius error (the towers run fp32 behind the same bf16 roundings).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_recommenders_torch import convert
from deep_recommenders_torch.ops import retrieval as tops
from deep_recommenders_torch.models import retrieval as tret
from deep_recommenders_torch.training import retrieval_loss
from deep_recommenders_tpu.ops import retrieval as jops
from deep_recommenders_tpu.models import retrieval as jret
from deep_recommenders_tpu.training import evaluation as j_eval

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ranking as base  # noqa: E402
import test_torch_retrieval as tr  # noqa: E402
from test_torch_ranking_bf16 import _flat, _nest  # noqa: E402

torch.set_num_threads(1)

BF16 = torch.bfloat16
B, D = 32, 16
CASES = {
    "plain": {},
    "temperature_logq_accidental": {
        "temperature": 0.1, "candidate_sampling_probability": "p",
        "candidate_ids": "ids"},
    "hard_sample_weight": {"num_hard_negatives": 20, "sample_weight": "sw",
                           "temperature": 0.2},
}


def case_inputs(name):
    rng = np.random.default_rng(400 + sorted(CASES).index(name))
    return tr.loss_inputs(rng, B, D)


def jax_side(path):
    """Everything the tests read of JAX, run in the subprocess: per case
    the bf16 loss and gradients and the fp32 loss; the bf16 TwoTower's
    weights, batch, loss and gradients."""
    out = {}
    for name, kw in CASES.items():
        q, c, arrays = case_inputs(name)
        j_kw = {k: jnp.asarray(arrays[v]) if isinstance(v, str) else v
                for k, v in kw.items()}

        def loss(a, b, dtype=jnp.bfloat16):
            return jops.in_batch_retrieval_loss(a, b, compute_dtype=dtype,
                                                **j_kw)

        value, (dq, dc) = jax.value_and_grad(loss, argnums=(0, 1))(
            jnp.asarray(q), jnp.asarray(c))
        fields = {"loss": value, "dq": dq, "dc": dc,
                  "loss_fp32": loss(jnp.asarray(q), jnp.asarray(c), None)}
        out.update({f"{name}|{k}": np.asarray(v, np.float32)
                    for k, v in fields.items()})
    rng = np.random.default_rng(500)
    user, item = tr.tower_batches(rng)
    model, params = tr.flax_two_tower(rng, user, item)
    task = jret.Retrieval(temperature=0.1, compute_dtype=jnp.bfloat16)
    fn = j_eval.retrieval_loss(model, task)
    value, grads = jax.value_and_grad(
        lambda p: fn(p, (tr.jb(user), tr.jb(item)), None))(params)
    fields = {"loss": value}
    fields.update({"params/" + k: v
                   for k, v in _flat(params["params"]).items()})
    fields.update({"grads/" + k: v
                   for k, v in _flat(grads["params"]).items()})
    out.update({f"two_tower|{k}": np.asarray(v, np.float32)
                for k, v in fields.items()})
    np.savez(path, **out)


_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
import test_torch_retrieval_bf16
test_torch_retrieval_bf16.jax_side(sys.argv[1])
"""


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    path = tmp_path_factory.mktemp("retrieval_bf16") / "jax.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root,
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c", _SCRIPT, str(path)], check=True,
                   cwd=root, env=env, timeout=600)
    results = {}
    for key, value in np.load(path).items():
        name, field = key.split("|")
        results.setdefault(name, {})[field] = value
    return results


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(BF16).float().numpy()


LOSS_RTOL = 2e-6


def _variant(name):
    """The port's score product, or a planted departure from JAX's."""
    if name == "scores_rounded":
        return lambda a, b, dt: (a.to(BF16) @ b.to(BF16).T).float()
    if name == "fp32_operands":
        return lambda a, b, dt: a @ b.T

    def straight_through(x):
        return x + (x.to(BF16).float() - x).detach()

    return lambda a, b, dt: straight_through(a) @ straight_through(b).T


def _port(name, monkeypatch, variant=None):
    q, c, arrays = case_inputs(name)
    kw = CASES[name]
    tr.assert_hard_negatives_tie_free(_bf16(q), _bf16(c), arrays, kw)
    if variant is not None:
        monkeypatch.setattr(tops, "_scores", _variant(variant))
    t_kw = {k: torch.from_numpy(arrays[v]) if isinstance(v, str) else v
            for k, v in kw.items()}
    tq = torch.from_numpy(q).requires_grad_()
    tc = torch.from_numpy(c).requires_grad_()
    loss = tops.in_batch_retrieval_loss(tq, tc, compute_dtype=BF16, **t_kw)
    loss.backward()
    monkeypatch.undo()
    return loss.item(), tq.grad.numpy(), tc.grad.numpy()


def _grad_errors(got, want):
    """(largest error in bf16 steps of |want|, share of elements that
    differ from JAX's)."""
    step = np.abs(want) * 2.0**-7 + 1e-30  # one bf16 step at |want|
    return (np.abs(got - want) / step).max(), float(np.mean(got != want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_loss_and_grads_match_jax(jax_bf16, monkeypatch, name):
    """The bf16 loss and gradients against JAX's within the bounds, and
    each rounding site pinned by a planted variant (module docstring)."""
    want = jax_bf16[name]
    for key in ("dq", "dc"):  # JAX rounds the operands' gradients to bf16
        np.testing.assert_array_equal(_bf16(want[key]), want[key])
    loss, dq, dc = _port(name, monkeypatch)
    bound = LOSS_RTOL * abs(float(want["loss"]))
    assert abs(loss - float(want["loss"])) <= bound, (loss, want["loss"])
    assert abs(float(want["loss"]) - float(want["loss_fp32"])) > 10 * bound
    for got, key in ((dq, "dq"), (dc, "dc")):
        np.testing.assert_array_equal(_bf16(got), got)
        steps, differ = _grad_errors(got, want[key])
        assert steps <= 1.0 and differ <= 0.02, (key, steps, differ)
    for variant in ("scores_rounded", "fp32_operands"):
        planted = _port(name, monkeypatch, variant)[0]
        assert abs(planted - float(want["loss"])) > 10 * bound, variant
    _, dq, dc = _port(name, monkeypatch, "grad_unrounded")
    assert not np.array_equal(_bf16(dq), dq)
    assert min(_grad_errors(dq, want["dq"])[1],
               _grad_errors(dc, want["dc"])[1]) > 0.5


def test_two_tower_bf16_matches_jax(jax_bf16):
    """TwoTower with Retrieval(temperature=0.1, compute_dtype=bfloat16)
    through retrieval_loss: fp32 weights; the loss and every gradient
    against JAX's bf16 path on the same weights."""
    fields = jax_bf16["two_tower"]
    rng = np.random.default_rng(500)
    user, item = tr.tower_batches(rng)
    params = {"params": _nest({k[len("params/"):]: v
                               for k, v in fields.items()
                               if k.startswith("params/")})}
    model = tr.port_two_tower(params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    task = tret.Retrieval(temperature=0.1, compute_dtype=BF16)
    loss = retrieval_loss(model, task)((tr.tb(user), tr.tb(item)), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(fields["loss"]), rtol=1e-5)
    want = convert.two_tower_from_flax({"params": _nest(
        {k[len("grads/"):]: v for k, v in fields.items()
         if k.startswith("grads/")})})
    got = base.torch_grads(model)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        value = value.numpy()
        err = np.linalg.norm(got[key] - value)
        assert err <= 2.0**-12 * np.linalg.norm(value), (key, err)
