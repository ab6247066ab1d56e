"""A table stored in bf16 (``EmbeddingCollection(param_dtype=torch.bfloat16)``)
against the JAX package's ``EmbeddingCollection(param_dtype=jnp.bfloat16)``,
on the CPU: the lookup, its table gradient, DeepFM's composition over such
a table (``tests/torch_bf16_table_worker.Composition`` and its flax twin
here), optax's Adam in bf16, the converter, checkpoints, ``model_io`` and
the mesh.

JAX's side runs in a subprocess with ``--xla_allow_excess_precision=false``
appended to ``XLA_FLAGS``, so that XLA on the CPU rounds every bf16
operation as the port does.

The table gradient. K1 sums a row's bf16 updates in fp32 and rounds the sum
once (the TPU kernel's function; its plain version on the CPU does the
same); JAX's CPU scatter adds in bf16 and rounds after every add. So a row
with L updates is the same bits in both when L <= 2 (the fp32 sum of two
bf16 values is exact), and otherwise within L / 2 bf16 ulps of
S = sum |update|: JAX's L - 1 roundings and the port's one each move the
row by at most half an ulp of S, and the port's fp32 sum adds at most
(L - 1) u_fp32 S.
"""

import os
import socket
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

from deep_recommenders_torch import convert
from deep_recommenders_torch.datasets.movielens import (
    default_movielens_features as t_features,
)
from deep_recommenders_torch.embedding.engine import EmbeddingCollection
from deep_recommenders_torch.models.common import Dense
from deep_recommenders_torch.serving import model_io
from deep_recommenders_torch.training import (
    Adam,
    Trainer,
    binary_cross_entropy,
    restore_checkpoint,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_bf16_table_worker import (  # noqa: E402
    LEARNING_RATE,
    Composition,
    eval_spec,
)

torch.set_num_threads(1)

BF16 = torch.bfloat16
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
D, HIDDEN = 16, (256, 32)
B_LOOKUP, B_STEP, STEPS = 512, 256, 3
BITS = "~bf16"  # key suffix of a bf16 array stored as its int16 bits
# The composition after STEPS Adam steps: no table element more than one
# bf16 ulp from JAX's, and at most this share one ulp off. Measured on
# these inputs: none (0 of 160,704 elements); the share leaves room for a
# row cotangent that the fp32 head, summing in another order, rounds to
# the other bf16 neighbour.
ADAM_ONE_ULP_SHARE = 1e-3


# -- inputs, made by numpy from seeds -----------------------------------------

def make_batch(rng, b, unique=False, hot=False):
    """The six MovieLens features and labels. ``unique``: every user and
    movie id once (each lookup row one update); ``hot``: a third of the
    users and a fifth of the movies on one id each."""
    if unique:
        users = rng.permutation(6040)[:b]
        movies = rng.permutation(3952)[:b]
    else:
        users = rng.integers(0, 6040, b)
        movies = rng.integers(0, 3952, b)
    if hot:
        users[rng.random(b) < 1 / 3] = 17
        movies[rng.random(b) < 0.2] = 5
    feats = {
        "user_id": users,
        "user_gender": rng.integers(0, 3, b),
        "user_age": rng.integers(0, 8, b),
        "user_occupation": rng.integers(0, 22, b),
        "movie_id": movies,
        "movie_genres": rng.integers(0, 19, (b, 6)),
    }
    feats = {k: v.astype(np.int32) for k, v in feats.items()}
    feats["movie_genres__wt"] = (rng.random((b, 6)) < 0.5).astype(np.float32)
    labels = (rng.random((b, 1)) < 0.5).astype(np.float32)
    return feats, labels


def lookup_inputs(kind):
    rng = np.random.default_rng({"unique": 1, "hot": 2}[kind])
    batch, _ = make_batch(rng, B_LOOKUP, unique=kind == "unique",
                          hot=kind == "hot")
    cotangent = rng.normal(0, 1, (B_LOOKUP, 6, D)).astype(np.float32)
    return batch, cotangent


def step_inputs(i):
    return make_batch(np.random.default_rng(10 + i), B_STEP)


def adam_inputs():
    rng = np.random.default_rng(3)
    p0 = rng.normal(0, 0.25, 4096).astype(np.float32)
    grads = [(rng.normal(0, 1e-3, 4096) * (rng.random(4096) < 0.7))
             .astype(np.float32) for _ in range(STEPS)]
    return p0, grads


# -- JAX's side ---------------------------------------------------------------

def _jax_modules():
    import flax.linen as nn
    import jax.numpy as jnp
    from deep_recommenders_tpu.datasets.movielens import (
        default_movielens_features as j_features,
    )
    from deep_recommenders_tpu.embedding.engine import (
        EmbeddingCollection as JEmbeddingCollection,
    )
    from deep_recommenders_tpu.embedding.engine import (
        LinearTerms,
        fused_embedding_linear,
    )
    from deep_recommenders_tpu.models.common import MLP
    from deep_recommenders_tpu.ops.fm import fm_interaction

    class JComposition(nn.Module):
        """DeepFM's composition (deepfm.py:54-66) over a bf16 table."""

        def setup(self):
            self.linear = LinearTerms(j_features())
            self.embeddings = JEmbeddingCollection(
                j_features(), D, param_dtype=jnp.bfloat16, shard=False)
            self.deep = MLP(HIDDEN, output_dim=1)

        def fused(self, batch):
            return fused_embedding_linear(self.embeddings, self.linear,
                                          batch)

        def __call__(self, batch, training=False):
            stacked, lin = self.fused(batch)
            first_order = lin.sum(axis=1, keepdims=True) + self.linear.bias
            deep = self.deep(stacked.reshape(stacked.shape[0], -1),
                             training=training)
            return (first_order + fm_interaction(stacked)
                    + deep.astype(jnp.float32))

    return JComposition, JEmbeddingCollection(j_features(), D,
                                              param_dtype=jnp.bfloat16,
                                              shard=False)


def _store(out, key, value):
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":
        out[key + BITS] = value.view(np.int16)
    else:
        out[key] = value.astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def jax_side(path):
    """Everything the tests read of JAX, run in the subprocess."""
    import jax
    import jax.numpy as jnp
    import optax
    from deep_recommenders_tpu.training import metrics as jm
    from deep_recommenders_tpu.training.evaluation import (
        BinaryCTREval as JBinaryCTREval,
    )
    from deep_recommenders_tpu.training.losses import binary_cross_entropy \
        as j_bce

    out = {}
    comp_cls, ec = _jax_modules()
    for kind in ("unique", "hot"):
        batch, cot = lookup_inputs(kind)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = ec.init(jax.random.PRNGKey(0), jb)
        rows, vjp = jax.vjp(lambda p: ec.apply(p, jb), params)
        (grad,) = vjp(jnp.asarray(cot, jnp.bfloat16))
        _store(out, f"ec/{kind}/table", params["params"]["table"])
        _store(out, f"ec/{kind}/rows", rows)
        _store(out, f"ec/{kind}/grad", grad["params"]["table"])

    model = comp_cls()
    batch, labels = step_inputs(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = model.init(jax.random.PRNGKey(1), jb)
    params = jax.tree.map(np.array, params)
    # flax zero-initialises the linear terms: draw them so that they count.
    lin = params["params"]["linear"]
    rng = np.random.default_rng(4)
    for k in ("weights", "bias"):
        lin[k] = rng.normal(0, 0.1, lin[k].shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, params)
    for k, v in _flat(params["params"]).items():
        _store(out, f"init/{k}", v)
    stacked, first_order = model.apply(params, jb, method=comp_cls.fused)
    _store(out, "fused/stacked", stacked)
    _store(out, "fused/first_order", first_order)

    def loss_fn(p, b, y):
        return j_bce(model.apply(p, b), y)

    opt = optax.adam(LEARNING_RATE)

    @jax.jit
    def train_step(p, s, b, y):
        loss, g = jax.value_and_grad(loss_fn)(p, b, y)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, g

    _store(out, "logits", model.apply(params, jb))
    j_eval = JBinaryCTREval(model, auc=jm.AUC(num_thresholds=500),
                            pr=jm.PrecisionRecall(threshold=0.3))
    metric_state, q = j_eval.init(), B_STEP // 4
    for i in range(4):
        metric_state = j_eval.update(
            params, {k: v[i * q:(i + 1) * q] for k, v in jb.items()},
            jnp.asarray(labels[i * q:(i + 1) * q]), metric_state)
    for k, v in j_eval.compute(metric_state).items():
        out[f"eval/{k}"] = np.float64(v)
    state = opt.init(params)
    assert state[0].mu["params"]["embeddings"]["table"].dtype == jnp.bfloat16
    for i in range(STEPS):
        batch, labels = step_inputs(i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params, state, loss, grads = train_step(params, state, jb,
                                                jnp.asarray(labels))
        _store(out, f"step{i}/loss", loss)
        for k, v in _flat(grads["params"]).items():
            _store(out, f"step{i}/grad/{k}", v)
        for k, v in _flat(params["params"]).items():
            _store(out, f"step{i}/param/{k}", v)

    p0, grads = adam_inputs()
    p = jnp.asarray(p0, jnp.bfloat16)
    s = opt.init(p)
    update = jax.jit(opt.update)
    for i, g in enumerate(grads):
        u, s = update(jnp.asarray(g, jnp.bfloat16), s, p)
        p = optax.apply_updates(p, u)
        _store(out, f"adam/{i}/param", p)
        _store(out, f"adam/{i}/mu", s[0].mu)
        _store(out, f"adam/{i}/nu", s[0].nu)
    np.savez(path, **out)


_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
import test_torch_bf16_table
test_torch_bf16_table.jax_side(sys.argv[1])
"""


def _load(path):
    out = {}
    for key, value in np.load(path).items():
        if key.endswith(BITS):
            out[key[:-len(BITS)]] = torch.from_numpy(value).view(BF16)
        else:
            out[key] = torch.from_numpy(value)
    return out


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("bf16_table") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c", _SCRIPT, str(path)], check=True,
                   cwd=REPO, env=env, timeout=600)
    return _load(path)


def _nest(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _as_numpy_tree(tree):
    """Tensors as the numpy arrays ``jax.tree.map(np.asarray, params)``
    gives: a bf16 leaf as ``ml_dtypes.bfloat16``."""
    import ml_dtypes

    if isinstance(tree, dict):
        return {k: _as_numpy_tree(v) for k, v in tree.items()}
    if tree.dtype == BF16:
        return tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return tree.numpy()


def port_state(jax_results, prefix="init/"):
    """The flax tree under ``prefix`` through the port's converter."""
    return convert.deepfm_from_flax(
        _as_numpy_tree(_nest(jax_results, prefix)))


def port_model(jax_results):
    model = Composition(t_features(), D, HIDDEN)
    model.load_state_dict(port_state(jax_results))
    return model


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def bits(t):
    return t.detach().view(torch.int16)


def ulp_bf16(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(x)) - 7)


def update_counts(batch, cotangent):
    """Per row of the fused table: the number of updates L and S = sum
    |update| in fp64, each update a row's bf16 cotangent (B, F, C) (over
    its bag's mean divisor and weight, for the genres)."""
    specs = t_features()
    offsets = np.cumsum([0] + [s.cardinality for s in specs])[:-1]
    g = np.abs(torch.from_numpy(cotangent).to(BF16).double().numpy())
    v = offsets[-1] + specs[-1].cardinality
    count, mag = np.zeros(v), np.zeros((v, g.shape[-1]))
    for f, (s, off) in enumerate(zip(specs, offsets)):
        ids = batch[s.name] + off
        if s.is_multi:
            wt = batch[s.name + "__wt"]
            denom = np.maximum(wt.sum(-1), 1.0) if s.combiner == "mean" \
                else np.ones(len(wt))
            for j in range(ids.shape[1]):
                on = wt[:, j] != 0
                np.add.at(count, ids[on, j], 1)
                np.add.at(mag, ids[on, j], g[on, f] / denom[on, None])
        else:
            np.add.at(count, ids, 1)
            np.add.at(mag, ids, g[:, f])
    return count[:, None], mag


def assert_within_update_bound(got, want, count, mag):
    """Rows of at most 2 updates bit for bit, every other element within
    L / 2 bf16 ulps of S plus the fp32 sum's (L - 1) u_fp32 S."""
    got, want = got.double().numpy(), want.double().numpy()
    few = (count <= 2).reshape(-1)
    assert np.array_equal(got[few], want[few])
    bound = (count / 2 * ulp_bf16(mag * (1 + 2.0**-7))
             + np.maximum(count - 1, 0) * 2.0**-24 * mag)
    assert (np.abs(got - want) <= bound).all()


# -- the module ---------------------------------------------------------------

def test_param_dtype_draws_in_fp32_then_casts_and_checks_its_argument():
    specs = t_features()
    fp32 = EmbeddingCollection(specs, D,
                               generator=torch.Generator().manual_seed(5))
    bf16 = EmbeddingCollection(specs, D, param_dtype=BF16,
                               generator=torch.Generator().manual_seed(5))
    assert fp32.table.dtype == torch.float32 and bf16.table.dtype == BF16
    assert torch.equal(bits(bf16.table), bits(fp32.table.to(BF16)))
    # compute_table: the parameter itself unless a cast is asked for.
    assert bf16.compute_table() is bf16.table
    same = EmbeddingCollection(specs, D, param_dtype=BF16,
                               compute_dtype=BF16)
    assert same.compute_table() is same.table
    cast = EmbeddingCollection(specs, D, compute_dtype=BF16)
    assert cast.compute_table().dtype == BF16
    for bad in (torch.float16, torch.float64, None):
        with pytest.raises(ValueError, match="param_dtype"):
            EmbeddingCollection(specs, D, param_dtype=bad)


def test_converter_keeps_bf16_leaves(jax_results):
    state = port_state(jax_results)
    assert state["embeddings.table"].dtype == BF16
    assert torch.equal(bits(state["embeddings.table"]),
                       bits(jax_results["init/embeddings/table"]))
    assert all(v.dtype == torch.float32 for k, v in state.items()
               if k != "embeddings.table")
    # transposed and non-contiguous bf16 leaves keep their bits too
    import ml_dtypes

    a = np.arange(12, dtype=np.float32).reshape(3, 4).astype(
        ml_dtypes.bfloat16)
    t = convert._tensor(a.T)
    assert t.dtype == BF16 and torch.equal(t.float(),
                                           torch.arange(12.).reshape(3, 4).T)


@pytest.mark.parametrize("kind", ["unique", "hot"])
def test_lookup_forward_matches_jax_bit_for_bit(jax_results, kind):
    batch, _ = lookup_inputs(kind)
    ec = EmbeddingCollection(t_features(), D, param_dtype=BF16)
    with torch.no_grad():
        ec.table.copy_(jax_results[f"ec/{kind}/table"])
    rows = ec(tbatch(batch))
    assert rows.dtype == BF16
    assert torch.equal(bits(rows), bits(jax_results[f"ec/{kind}/rows"]))


def test_fused_pass_matches_jax_bit_for_bit(jax_results):
    """``fused_embedding_linear`` over a bf16 table: the fp32 linear
    weights cast to bf16 beside it, the rows bf16, the first-order terms
    upcast to fp32."""
    from deep_recommenders_torch.embedding.engine import (
        fused_embedding_linear,
    )

    model = port_model(jax_results)
    stacked, first_order = fused_embedding_linear(
        model.embeddings, model.linear, tbatch(step_inputs(0)[0]))
    assert stacked.dtype == BF16 and first_order.dtype == torch.float32
    assert torch.equal(bits(stacked), bits(jax_results["fused/stacked"]))
    assert torch.equal(first_order.detach(),
                       jax_results["fused/first_order"])


@pytest.mark.parametrize("kind", ["unique", "hot"])
def test_table_gradient_against_jax_scatter(jax_results, kind):
    """Unique ids: every row of the lookup features takes one update, and
    the whole gradient is JAX's bit for bit. Hot rows: the stated bound;
    the hot user's row differs from JAX's and lies nearer the exact sum.
    (The small-vocab rows, summed by the one-hot matmul's transpose in
    fp32 on both sides, come out the same bits here.)"""
    batch, cot = lookup_inputs(kind)
    ec = EmbeddingCollection(t_features(), D, param_dtype=BF16)
    with torch.no_grad():
        ec.table.copy_(jax_results[f"ec/{kind}/table"])
    ec(tbatch(batch)).backward(torch.from_numpy(cot).to(BF16))
    got, want = ec.table.grad, jax_results[f"ec/{kind}/grad"]
    assert got.dtype == BF16
    count, mag = update_counts(batch, cot)
    assert_within_update_bound(got, want, count, mag)
    if kind == "unique":
        assert torch.equal(bits(got), bits(want))
        return
    hot = 17  # user 17, the hot user id (row 17: user_id's offset is 0)
    assert count[hot, 0] > 100
    exact = torch.zeros(count.shape[0], D, dtype=torch.float64)
    ids = torch.from_numpy(batch["user_id"]).long()
    exact.index_add_(0, ids, torch.from_numpy(cot[:, 0]).to(BF16).double())
    assert not torch.equal(bits(got[hot]), bits(want[hot]))
    assert ((got[hot].double() - exact[hot]).abs().sum()
            < (want[hot].double() - exact[hot]).abs().sum())


def test_dense_promotes_mixed_dtypes_as_flax():
    """flax's ``nn.Dense(dtype=None)`` promotes a bf16 input against fp32
    parameters to fp32; the port's Dense did ``nn.Linear.forward`` on the
    mixed pair, which raises."""
    import flax.linen as nn
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0, 1, (32, 24)).astype(np.float32))
    x = x.to(BF16)
    dense = Dense(24, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        dense.bias.normal_(generator=torch.Generator().manual_seed(1))
    params = {"params": {"kernel": jnp.asarray(dense.weight.detach().T),
                         "bias": jnp.asarray(dense.bias.detach())}}
    want = nn.Dense(8).apply(params, jnp.asarray(x.float()).astype(
        jnp.bfloat16))
    got = dense(x)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    # the same input in fp32 gives the same fp32 result
    assert torch.equal(got, dense(x.float()))


# -- the composition and Adam -------------------------------------------------

def test_composition_logits_and_loss_match_jax(jax_results):
    """The rows are JAX's bits; the fp32 head sums them in another order,
    so the logits agree to fp32 roundoff."""
    model = port_model(jax_results)
    batch, labels = step_inputs(0)
    logits = model(tbatch(batch))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               jax_results["logits"].numpy(),
                               rtol=1e-5, atol=1e-6)
    loss = binary_cross_entropy(logits, torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), jax_results["step0/loss"].item(),
                               rtol=1e-6)


def test_composition_gradients_match_jax(jax_results):
    """The dense gradients to a relative Frobenius error of 1e-4 (fp32
    sums in other orders); the fused gradient (the bf16 table's and the
    linear weights') within ``assert_fused_gradient_near``'s bound."""
    model = port_model(jax_results)
    batch, labels = step_inputs(0)
    tb = tbatch(batch)
    cot = fused_cotangent(model, tb, labels)
    binary_cross_entropy(model(tb), torch.from_numpy(labels)).backward()
    want = convert.deepfm_from_flax(_as_numpy_tree(
        _nest(jax_results, "step0/grad/")))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    assert got["embeddings.table"].dtype == BF16
    for key, value in want.items():
        if key not in ("embeddings.table", "linear.weights"):
            err = torch.linalg.norm(got[key] - value)
            assert err <= 1e-4 * torch.linalg.norm(value), key
    assert_fused_gradient_near(got, want, batch, cot, halves=False)


def fused_cotangent(model, tb, labels):
    """The bf16 cotangent of the composition's fused (B, F, D + 1) rows:
    the rows' own and, in column D, the first-order terms' fp32 cotangent
    rounded to bf16 as their upcast's backward rounds it. fp32 numpy."""
    seen = {}
    worker = sys.modules[Composition.__module__].__dict__
    real = worker["fused_embedding_linear"]

    def spy(e, lin, b):
        stacked, first = real(e, lin, b)
        stacked.register_hook(lambda g: seen.setdefault("rows", g))
        first.register_hook(lambda g: seen.setdefault("first", g))
        return stacked, first

    worker["fused_embedding_linear"] = spy
    try:
        loss = binary_cross_entropy(model(tb), torch.from_numpy(labels))
        torch.autograd.grad(loss, [model.embeddings.table])
    finally:
        worker["fused_embedding_linear"] = real
    first = seen["first"].to(BF16)[..., None]
    return torch.cat([seen["rows"], first], -1).float().numpy()


def assert_fused_gradient_near(got, want, batch, cot, halves):
    """The bf16 table's gradient and the linear weights' (column D of the
    same fused gradient, upcast) within the docstring's bound, with one
    bf16 ulp of S more per update for a cotangent that the fp32 head,
    summing in another order, rounds to the other bf16 neighbour; a mean
    over two data halves adds one rounding of each half (``halves``). At
    most 1e-3 of the elements of rows with one update differ at all."""
    count, mag = update_counts(batch, cot)
    ulp = ulp_bf16(mag * (1 + 2.0**-7))
    bound = ((1.5 * count + (1.0 if halves else 0.0)) * ulp
             + count * 2.0**-24 * mag)
    g = np.concatenate([got["embeddings.table"].double().numpy(),
                        got["linear.weights"].double().numpy()], 1)
    w = np.concatenate([want["embeddings.table"].double().numpy(),
                        want["linear.weights"].double().numpy()], 1)
    assert (np.abs(g - w) <= bound).all()
    one = (count == 1).reshape(-1)
    assert (g[one] != w[one]).mean() <= 1e-3


def test_adam_follows_optax_in_bf16_bit_for_bit(jax_results):
    """The port's Adam on a bf16 parameter is optax.adam's sequence of bf16
    roundings: the parameter and both moments JAX's bits after every step.
    torch.optim.Adam's order is not: elements more than one ulp off."""
    p0, grads = adam_inputs()
    ours = torch.nn.Parameter(torch.from_numpy(p0).to(BF16))
    theirs = torch.nn.Parameter(torch.from_numpy(p0).to(BF16))
    opt = Adam([ours], lr=LEARNING_RATE)
    torch_opt = torch.optim.Adam([theirs], lr=LEARNING_RATE)
    for i, g in enumerate(grads):
        ours.grad = torch.from_numpy(g).to(BF16)
        theirs.grad = ours.grad.clone()
        opt.step()
        torch_opt.step()
        state = opt.state[ours]
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == BF16
        assert torch.equal(bits(ours), bits(jax_results[f"adam/{i}/param"]))
        assert torch.equal(bits(state["exp_avg"]),
                           bits(jax_results[f"adam/{i}/mu"]))
        assert torch.equal(bits(state["exp_avg_sq"]),
                           bits(jax_results[f"adam/{i}/nu"]))
    want = jax_results[f"adam/{STEPS - 1}/param"].double().numpy()
    off = np.abs(theirs.detach().double().numpy() - want) / ulp_bf16(want)
    assert off.max() > 1


def test_adam_on_fp32_parameters_is_torch_adam():
    rng = np.random.default_rng(8)
    p0 = torch.from_numpy(rng.normal(0, 1, (40, 3)).astype(np.float32))
    ours, theirs = torch.nn.Parameter(p0.clone()), torch.nn.Parameter(
        p0.clone())
    opt = Adam([ours], lr=1e-2, betas=(0.8, 0.99), eps=1e-7)
    ref = torch.optim.Adam([theirs], lr=1e-2, betas=(0.8, 0.99), eps=1e-7)
    for _ in range(3):
        g = torch.from_numpy(rng.normal(0, 1, (40, 3)).astype(np.float32))
        ours.grad, theirs.grad = g, g.clone()
        opt.step()
        ref.step()
    assert torch.equal(ours, theirs)
    assert torch.equal(opt.state[ours]["exp_avg_sq"],
                       ref.state[theirs]["exp_avg_sq"])


def _train(model, steps=STEPS):
    trainer = Trainer(model, Adam(model.parameters(), lr=LEARNING_RATE),
                      device="cpu")
    losses = []
    for i in range(steps):
        batch, labels = step_inputs(i)
        losses.append(trainer.train_step(tbatch(batch),
                                          torch.from_numpy(labels)))
    return trainer, losses


def test_composition_adam_steps_match_optax(jax_results):
    """Three steps of the port's Adam against optax.adam in JAX's step: the
    losses to rtol 1e-5, the fp32 parameters to a relative Frobenius error
    of 1e-5, and the bf16 table no element more than one ulp off and at
    most ``ADAM_ONE_ULP_SHARE`` of them one ulp off (the updates follow
    optax's order, so only the gradients' last bits differ)."""
    model = port_model(jax_results)
    trainer, losses = _train(model)
    for i, loss in enumerate(losses):
        np.testing.assert_allclose(loss.item(),
                                   jax_results[f"step{i}/loss"].item(),
                                   rtol=1e-5)
    want = convert.deepfm_from_flax(_as_numpy_tree(
        _nest(jax_results, f"step{STEPS - 1}/param/")))
    got = dict(model.named_parameters())
    for key, value in want.items():
        if key != "embeddings.table":
            err = torch.linalg.norm(got[key].detach() - value)
            assert err <= 1e-5 * torch.linalg.norm(value), key
    table = got["embeddings.table"].detach()
    assert table.dtype == BF16
    state = trainer.optimizer.state[got["embeddings.table"]]
    assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == BF16
    want_t = want["embeddings.table"]
    moved = (bits(table) != bits(jax_results["init/embeddings/table"]))
    assert moved.float().mean() > 0.01
    ulps = ((table.double() - want_t.double()).abs().numpy()
            / ulp_bf16(want_t.double().numpy()))
    assert ulps.max() <= 1
    assert (ulps > 0).mean() <= ADAM_ONE_ULP_SHARE


# -- checkpoints and model_io -------------------------------------------------

def test_checkpoint_round_trip_keeps_bf16_bits(jax_results, tmp_path):
    model = port_model(jax_results)
    trainer, _ = _train(model, steps=1)
    save_train_state(str(tmp_path / "ckpt"), model, trainer.optimizer)
    fresh = Composition(t_features(), D, HIDDEN)
    opt = Adam(fresh.parameters(), lr=LEARNING_RATE)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        restore_train_state(str(tmp_path / "ckpt"), fresh, opt)
    assert fresh.embeddings.table.dtype == BF16
    assert torch.equal(bits(fresh.embeddings.table),
                       bits(model.embeddings.table))
    saved = trainer.optimizer.state[model.embeddings.table]
    restored = opt.state[fresh.embeddings.table]
    for k in ("exp_avg", "exp_avg_sq"):
        assert restored[k].dtype == BF16
        assert torch.equal(bits(restored[k]), bits(saved[k]))
    assert restored["step"] == saved["step"]


def test_fp32_checkpoint_into_bf16_table_is_rounded_as_jax_and_warns(
        tmp_path):
    """JAX's restore (Orbax, with the template's dtypes) rounds an fp32
    array into a bf16 template without a word; the port rounds it the same
    way, to the same bits, and warns."""
    import jax.numpy as jnp
    from deep_recommenders_tpu.training import checkpoints as jck

    rng = np.random.default_rng(9)
    value = rng.normal(0, 0.3, (64, 17)).astype(np.float32)
    jck.save_checkpoint(str(tmp_path / "jax"), {"t": jnp.asarray(value)})
    want = jck.restore_checkpoint(str(tmp_path / "jax"),
                                  {"t": jnp.zeros((64, 17), jnp.bfloat16)})
    save_checkpoint(str(tmp_path / "port"), {"t": torch.from_numpy(value)})
    with pytest.warns(UserWarning, match="saved torch.float32, restored as "
                                         "torch.bfloat16"):
        got = restore_checkpoint(str(tmp_path / "port"),
                                 {"t": torch.zeros(64, 17, dtype=BF16)})
    assert got["t"].dtype == BF16
    assert np.array_equal(got["t"].view(torch.int16).numpy(),
                          np.asarray(want["t"]).view(np.int16))

    # a trainer's fp32 checkpoint read into the bf16 model warns too
    fp32 = Composition(t_features(), D, HIDDEN, param_dtype=torch.float32)
    save_train_state(str(tmp_path / "train"), fp32,
                     Adam(fp32.parameters(), lr=LEARNING_RATE))
    bf16 = Composition(t_features(), D, HIDDEN)
    with pytest.warns(UserWarning, match="embeddings.table"):
        restore_train_state(str(tmp_path / "train"), bf16,
                            Adam(bf16.parameters(), lr=LEARNING_RATE))
    assert torch.equal(bits(bf16.embeddings.table),
                       bits(fp32.embeddings.table.to(BF16)))


def test_model_io_stores_param_dtype_by_name(jax_results, tmp_path):
    """A config holding ``param_dtype`` saves it as its name and
    ``decode_config`` (``load_model``'s decoding) reads it back; the bf16
    table's state round-trips bit for bit. Any other dtype is refused."""
    from deep_recommenders_torch.models.common import records_config

    Recorded = records_config(type("Recorded", (Composition,), {}))
    model = Recorded(t_features(), D, HIDDEN)
    model.load_state_dict(port_state(jax_results))
    path = model_io.save_model(str(tmp_path / "m"), model)
    import json

    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)["config"]
    assert config["param_dtype"] == "bfloat16"
    kwargs = model_io.decode_config(config)
    assert kwargs["param_dtype"] is BF16
    assert kwargs["specs"] == tuple(t_features())
    rebuilt = Recorded(**kwargs)
    rebuilt.load_state_dict(restore_checkpoint(os.path.join(path, "params")))
    assert rebuilt.embeddings.table.dtype == BF16
    assert torch.equal(bits(rebuilt.embeddings.table),
                       bits(model.embeddings.table))
    with pytest.raises(ValueError, match="param_dtype"):
        model_io.decode_config({"param_dtype": "float16"})
    with pytest.raises(TypeError, match="param_dtype"):
        model_io.model_config(types.SimpleNamespace(constructor_args=dict(
            model.constructor_args, param_dtype=torch.float16)))


# -- the mesh -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_run(jax_results, tmp_path_factory):
    """The two workers once: returns each rank's results."""
    tmp = tmp_path_factory.mktemp("bf16_mesh")
    batch, labels = step_inputs(0)
    torch.save({"specs": t_features(), "state": port_state(jax_results),
                "batch": tbatch(batch), "labels": torch.from_numpy(labels)},
               tmp / "inputs.pt")
    ports = [str(_free_port()), str(_free_port())]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_bf16_table_worker.py"),
         *ports, str(rank), str(tmp), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outputs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out
    return [torch.load(tmp / f"rank{r}.pt") for r in range(2)]


def _unmeshed_step(jax_results):
    model = port_model(jax_results)
    trainer = Trainer(model, Adam(model.parameters(), lr=LEARNING_RATE),
                      device="cpu")
    batch, labels = step_inputs(0)
    loss = trainer.train_step(tbatch(batch), torch.from_numpy(labels))
    return loss, {k: p.grad for k, p in model.named_parameters()}, {
        k: p.detach() for k, p in model.named_parameters()}


def test_meshed_eval_merges_non_default_metrics(jax_results, mesh_run):
    """``BinaryCTREval(auc=AUC(num_thresholds=500),
    pr=PrecisionRecall(threshold=0.3))`` at (data=2, model=1): the merged
    summary equals the unmeshed one on the same weights and batches, and
    JAX's eval of its composition, to fp32 roundoff."""
    model = port_model(jax_results)
    trainer = Trainer(model, Adam(model.parameters()), device="cpu",
                      eval_spec=eval_spec(model))
    batch, labels = step_inputs(0)
    tb, tl = tbatch(batch), torch.from_numpy(labels)
    q = B_STEP // 4  # each rank's two eval batches, in rank order
    want = trainer.evaluate(lambda: [
        ({k: v[i * q:(i + 1) * q] for k, v in tb.items()},
         tl[i * q:(i + 1) * q]) for i in range(4)])
    assert trainer.eval_spec.auc.num_thresholds == 500
    for got in (mesh_run[0]["eval"], mesh_run[1]["eval"]):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(got[k], jax_results[f"eval/{k}"],
                                       rtol=1e-6, err_msg=k)


def test_data_all_reduce_of_a_bf16_gradient(jax_results, mesh_run):
    """(data=2, model=1): each rank's K1 rounds its half's rows once, the
    all-reduce sums the two bf16 gradients in fp32 and the mean is rounded
    once: the fused gradient within ``assert_fused_gradient_near``'s bound
    of the unmeshed step's, the dense ones to rtol 1e-5, both ranks the
    same bits, the table gradient bf16."""
    loss, grads, _ = _unmeshed_step(jax_results)
    r0, r1 = mesh_run
    np.testing.assert_allclose(r0["2x1/loss"].item(), loss.item(),
                               rtol=1e-6)
    batch, labels = step_inputs(0)
    cot = fused_cotangent(port_model(jax_results), tbatch(batch), labels)
    got = {}
    for key, want in grads.items():
        got[key] = r0[f"2x1/grad/{key}"]
        assert torch.equal(got[key], r1[f"2x1/grad/{key}"])
        assert got[key].dtype == want.dtype
        if key not in ("embeddings.table", "linear.weights"):
            np.testing.assert_allclose(got[key].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
    assert_fused_gradient_near(got, grads, batch, cot, halves=True)


def test_model_sharded_first_step_is_the_unmeshed_step(jax_results,
                                                       mesh_run):
    """(data=1, model=2): every row lives on one shard and the other
    shard's partial is zero, so the bf16 all-reduce over "model" adds
    exact zeros, and each shard's K1 sees its rows' updates in the same
    order: the loss, every gradient and every parameter after the step are
    the unmeshed step's bits, the table still bf16."""
    loss, grads, params = _unmeshed_step(jax_results)
    for r in mesh_run:
        assert r["1x2/loss"].item() == loss.item()
        for key in grads:
            assert r[f"1x2/grad/{key}"].dtype == grads[key].dtype
            assert torch.equal(r[f"1x2/grad/{key}"], grads[key]), key
            assert torch.equal(r[f"1x2/param/{key}"], params[key]), key
    assert mesh_run[0]["1x2/param/embeddings.table"].dtype == BF16
