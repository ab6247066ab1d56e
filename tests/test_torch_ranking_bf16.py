"""bf16 compute (``compute_dtype=torch.bfloat16``) of the port's CTR models
against the JAX package's ``compute_dtype=jnp.bfloat16``, on the CPU, on
weights converted from flax: DeepFM, xDeepFM (the fused stack and the
layered CIN), FM, FNN, Wide & Deep (both branches, with crosses) and DCN
(stacked, parallel, low rank), as JAX's tests/test_mixed_precision.py lists
them. Also K1's bf16 function: its summation order on the CPU, and the
bf16 lookup's table gradient against JAX's CPU scatter.

JAX's side runs in a subprocess with ``--xla_allow_excess_precision=false``
appended to ``XLA_FLAGS``: XLA on the CPU otherwise may skip bf16 roundings
that the port makes. Both sides then round the same values to bf16 at the
same places and sum in fp32 in other orders, so now and then an
intermediate rounds to the other bf16 neighbour (2^-8 relative). Each
tolerance is set beside the distance between JAX's bf16 and fp32 results
on the same weights, which is what a port that kept fp32 would show.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deep_recommenders_torch import convert
from deep_recommenders_torch.datasets.movielens import (
    default_movielens_features as t_features,
)
from deep_recommenders_torch.models import ranking as tr
from deep_recommenders_torch.ops import embedding_kernels as ek
from deep_recommenders_torch.training import binary_cross_entropy as t_bce

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ranking as base  # noqa: E402

torch.set_num_threads(1)

BF16 = torch.bfloat16
D, HIDDEN = base.D, base.HIDDEN
U_BF16 = 2.0**-8  # unit roundoff of bf16 (8 significant bits)


def _jax_models():
    """DeepFM and the two xDeepFMs beside test_torch_ranking's models."""
    import jax.numpy as jnp
    from deep_recommenders_tpu.datasets.movielens import (
        default_movielens_features as j_features,
    )
    from deep_recommenders_tpu.models import ranking as jr

    def j(dt):
        return None if dt is None else jnp.bfloat16

    return {
        "deepfm": lambda dt: jr.DeepFM(j_features(), D, HIDDEN,
                                       compute_dtype=j(dt)),
        "xdeepfm_fused": lambda dt: jr.XDeepFM(
            j_features(), D, (8, 8), "relu", HIDDEN, compute_dtype=j(dt)),
        "xdeepfm_layered": lambda dt: jr.XDeepFM(
            j_features(), D, (8,), "relu", HIDDEN, compute_dtype=j(dt)),
        **{k: (lambda f: lambda dt: f(dt)[0])(f)
           for k, f in base.MODELS.items()},
    }


PORT = {
    "deepfm": lambda: tr.DeepFM(t_features(), D, HIDDEN, compute_dtype=BF16),
    "xdeepfm_fused": lambda: tr.XDeepFM(t_features(), D, (8, 8), "relu",
                                        HIDDEN, compute_dtype=BF16),
    "xdeepfm_layered": lambda: tr.XDeepFM(t_features(), D, (8,), "relu",
                                          HIDDEN, compute_dtype=BF16),
    **{k: (lambda f: lambda: f(BF16)[1])(f) for k, f in base.MODELS.items()},
}
NAMES = sorted(PORT)
CONVERT = {"deepfm": convert.deepfm_from_flax,
           "xdeepfm_fused": convert.xdeepfm_from_flax,
           "xdeepfm_layered": convert.xdeepfm_from_flax}
# K1's bf16 inputs: g (N, 17) into V rows, ids with a hot row.
LOOKUP_N, LOOKUP_C, LOOKUP_V = 3000, 17, 40


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _inputs(i):
    rng = np.random.default_rng(100 + i)
    batch, labels = base.make_batch(rng)
    return rng, batch, labels


def _lookup_inputs():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, LOOKUP_V, LOOKUP_N).astype(np.int32)
    ids[rng.random(LOOKUP_N) < 0.3] = 5  # a hot row of ~900 updates
    g = rng.normal(0, 1, (LOOKUP_N, LOOKUP_C)).astype(np.float32)
    return ids, g


def jax_side(path):
    """Everything the tests read of JAX, run in the subprocess: for each
    model its flax weights, bf16 and fp32 logits, bf16 loss and gradients;
    and the bf16 lookup's table gradient."""
    import jax
    import jax.numpy as jnp
    from deep_recommenders_tpu.ops import embedding_kernels as jek
    from deep_recommenders_tpu.training.losses import binary_cross_entropy

    out = {}
    models = _jax_models()
    for i, name in enumerate(NAMES):
        rng, batch, labels = _inputs(i)
        model = models[name](BF16)
        params = base.flax_params(model, batch, rng)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss(p):
            return binary_cross_entropy(model.apply(p, jb),
                                        jnp.asarray(labels))

        value, grads = jax.value_and_grad(loss)(params)
        logits = model.apply(params, jb)
        assert logits.dtype == jnp.float32
        fields = {"logits": logits, "logits_fp32":
                  models[name](None).apply(params, jb), "loss": value}
        for key, v in _flat(params["params"]).items():
            fields["params/" + key] = v
        for key, v in _flat(grads["params"]).items():
            fields["grads/" + key] = v
        out.update({f"{name}|{k}": np.asarray(v, np.float32)
                    for k, v in fields.items()})
    ids, g = _lookup_inputs()
    table = jnp.zeros((LOOKUP_V, LOOKUP_C), jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: jek.lookup(t, jnp.asarray(ids)), table)
    (dt,) = vjp(jnp.asarray(g, jnp.bfloat16))
    assert dt.dtype == jnp.bfloat16
    out["lookup|table_grad"] = np.asarray(dt.astype(jnp.float32))
    np.savez(path, **out)


_SCRIPT = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
import test_torch_ranking_bf16
test_torch_ranking_bf16.jax_side(sys.argv[1])
"""


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("ranking_bf16") / "jax.npz"
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


def _port(name, jax_fields):
    """The port's bf16 model on JAX's weights, and the batch."""
    _, batch, labels = _inputs(NAMES.index(name))
    params = {"params": _nest({k[len("params/"):]: v
                               for k, v in jax_fields.items()
                               if k.startswith("params/")})}
    model = PORT[name]()
    model.load_state_dict(CONVERT.get(name, convert.ranking_from_flax)(
        params))
    return model, base.torch_batch(batch), torch.from_numpy(labels)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_model_keeps_fp32_params_logits_and_grads(name):
    """As JAX's tests/test_mixed_precision.py:42-56: parameters, the
    returned logits and the gradients stay fp32, and are finite."""
    model = PORT[name]()
    _, batch, labels = _inputs(NAMES.index(name))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    logits = model(base.torch_batch(batch))
    assert logits.dtype == torch.float32 and logits.shape == (base.B, 1)
    assert bool(torch.isfinite(logits).all())
    t_bce(logits, torch.from_numpy(labels)).backward()
    for p in model.parameters():
        assert p.grad is None or (p.grad.dtype == torch.float32
                                  and bool(torch.isfinite(p.grad).all()))


@pytest.mark.parametrize("name", NAMES)
def test_bf16_logits_and_loss_match_jax(jax_results, name):
    """The logits within a hundredth of the largest distance between JAX's
    bf16 and fp32 logits (most are equal bit for bit; a flipped rounding
    moves a logit by a bf16 ulp of one small term), and the loss, an fp32
    mean of those logits' terms, to rtol 1e-6."""
    fields = jax_results[name]
    model, batch, labels = _port(name, fields)
    with torch.no_grad():
        logits = model(batch)
        loss = t_bce(logits, labels)
    gap = np.abs(fields["logits"] - fields["logits_fp32"]).max()
    err = np.abs(logits.numpy() - fields["logits"]).max()
    assert gap > 0 and err <= 0.01 * gap, (err, gap)
    np.testing.assert_allclose(loss.item(), float(fields["loss"]), rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_grads_match_jax(jax_results, name):
    """Every gradient to a relative Frobenius error of 2e-2 against JAX's
    bf16 gradients. A bf16 intermediate that rounds to the other neighbour
    carries 2^-8 of its value into the sums behind each gradient; the table
    gradient's rows also differ where JAX's CPU scatter rounds after each
    add of a row's updates and K1's plain version once (a row here takes at
    most a few updates)."""
    fields = jax_results[name]
    model, batch, labels = _port(name, fields)
    t_bce(model(batch), labels).backward()
    grads = {"params": _nest({k[len("grads/"):]: v
                              for k, v in fields.items()
                              if k.startswith("grads/")})}
    want = CONVERT.get(name, convert.ranking_from_flax)(grads)
    got = base.torch_grads(model)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        value = value.numpy()
        norm = np.linalg.norm(value)
        err = np.linalg.norm(got[key] - value)
        assert err <= 2e-2 * norm or err <= 1e-6, (key, err, norm)


def test_bf16_lookup_grad_against_jax_cpu_scatter(jax_results):
    """The bf16 lookup's table gradient: the port sums each row in fp32 and
    rounds once, as the TPU kernel does; JAX's CPU scatter adds in bf16,
    rounding after every add. Each row of the two within (L + 1) u_bf16
    sum|g| (L the row's updates), and the port's within u_bf16 |exact| +
    L u_fp32 sum|g| of the fp64 sum, nearer it than JAX's on the hot
    row."""
    ids, g = _lookup_inputs()
    gb = torch.from_numpy(g).to(BF16)
    table = torch.zeros(LOOKUP_V, LOOKUP_C, dtype=BF16, requires_grad=True)
    ek.lookup(table, torch.from_numpy(ids)).backward(gb)
    got = table.grad.float().numpy()
    want = jax_results["lookup"]["table_grad"]
    g64 = gb.double().numpy()
    exact = np.zeros((LOOKUP_V, LOOKUP_C))
    np.add.at(exact, ids, g64)
    mag = np.zeros_like(exact)
    np.add.at(mag, ids, np.abs(g64))
    count = np.bincount(ids, minlength=LOOKUP_V)[:, None]
    assert table.grad.dtype == BF16
    assert (np.abs(got - want) <= (count + 1) * U_BF16 * mag).all()
    fp32_err = count * 2.0**-24 * mag
    assert (np.abs(got - exact)
            <= U_BF16 * (np.abs(exact) + fp32_err) + fp32_err).all()
    hot = np.abs(got - exact)[5].sum(), np.abs(want - exact)[5].sum()
    assert hot[0] < hot[1], hot


@pytest.mark.parametrize("n,c,v,hot", [(16384, 17, 10044, 0.25),
                                       (5000, 16, 300, 0.5),
                                       (40000, 17, 50, 0.0),
                                       (777, 1, 30, 0.0)])
def test_k1_bf16_order_on_the_cpu(n, c, v, hot):
    """K1 on bf16 g is ``scatter_add_rows_in_segments(g.float(), ids,
    V).bfloat16()``: each row is an fp32 sum rounded once, so within one
    bf16 rounding of the fp64 sum (u_bf16 |exact|) plus the fp32 sum's own
    error (L u_fp32 sum|g|). The wrapper's plain version on a CPU tensor
    (fp32 in index order, rounded once) lies as near, and equals it
    wherever a row's updates lie in one segment."""
    rng = np.random.default_rng(n)
    ids = rng.integers(0, v, n).astype(np.int32)
    ids[rng.random(n) < hot] = v // 2
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    g = g.to(BF16)
    tids = torch.from_numpy(ids)
    order = ek.scatter_add_rows_in_segments(g.float(), tids, v).to(BF16)
    plain = ek.scatter_add_rows(g, tids, v)
    assert plain.dtype == order.dtype == BF16 and plain.shape == (v, c)
    g64 = g.double().numpy()
    exact = np.zeros((v, c))
    np.add.at(exact, ids, g64)
    mag = np.zeros_like(exact)
    np.add.at(mag, ids, np.abs(g64))
    count = np.bincount(ids, minlength=v)[:, None]
    fp32_err = count * 2.0**-24 * mag
    tol = U_BF16 * (np.abs(exact) + fp32_err) + fp32_err
    for got in (order, plain):
        assert (np.abs(got.double().numpy() - exact) <= tol).all()
    if n <= ek.segment_length(c):
        assert torch.equal(order.view(torch.int16), plain.view(torch.int16))
