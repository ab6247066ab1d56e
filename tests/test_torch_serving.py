"""Serving of the PyTorch port against the JAX package: ``serving/export.py``
(``export_model``, ``ServingModule``, ``load_serving_module`` over
``torch.export``), ``serving/model_io.py`` (``model_config``,
``save_model``, ``load_model``) over the zoo cases of
``tests/test_model_io.py``, and ``training/profiler.py``.

Tolerances: the served DeepFM against JAX's served DeepFM on converted
weights, rtol 1e-5 and atol 1e-6, as ``tests/test_serving.py`` holds JAX's
own round trip. A loaded program against the eager model it was exported
from, and a model reloaded by ``load_model`` against the one saved: the
same ops on the same weights, equal bit for bit on the CPU.

A CPU export records the kernel ops too (``ops/custom_ops.py``): each op's
CPU implementation is its kernel's plain version, so the program's graph
shows K3's, K4's or K5's op wherever the card would launch the kernel.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_recommenders_torch.convert import deepfm_from_flax
from deep_recommenders_torch.features.columns import CrossedFeature, Feature
from deep_recommenders_torch.models.multitask import ESMM, MMoE
from deep_recommenders_torch.models.nlp import Transformer
from deep_recommenders_torch.models.ranking import (
    DCN,
    DIN,
    FNN,
    DeepFM,
    FactorizationMachine,
    WideDeep,
    XDeepFM,
)
from deep_recommenders_torch.models.retrieval import GCN, TwoTower
from deep_recommenders_torch.ops import attention as att
from deep_recommenders_torch.ops import cin_kernels as ck
from deep_recommenders_torch.ops import custom_ops
from deep_recommenders_torch.serving import (
    ServingModule,
    export_model,
    load_model,
    load_serving_module,
    model_config,
    save_model,
)
from deep_recommenders_torch.training import profiler
from deep_recommenders_torch.training.checkpoints import save_checkpoint
from deep_recommenders_tpu import features as jfeatures
from deep_recommenders_tpu import serving as jserving
from deep_recommenders_tpu.models import multitask as jmultitask
from deep_recommenders_tpu.models import nlp as jnlp
from deep_recommenders_tpu.models import ranking as jranking
from deep_recommenders_tpu.models import retrieval as jretrieval

torch.set_num_threads(1)

CPU = "cpu"
NS = custom_ops.NAMESPACE


def as_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# -- export_model / load_serving_module ----------------------------------------

SERVE_SPECS = (
    ("user", dict(hash_buckets=50)),
    ("movie", dict(hash_buckets=40)),
    ("genres", dict(vocab=tuple(range(8)), max_len=3)),
)


def serve_batch(rng, b):
    return {
        "user": rng.integers(0, 50, b).astype(np.int32),
        "movie": rng.integers(0, 40, b).astype(np.int32),
        "genres": rng.integers(0, 8, (b, 3)).astype(np.int32),
        "genres__wt": (rng.random((b, 3)) < 0.7).astype(np.float32),
    }


@pytest.fixture
def deepfm_pair(rng):
    """JAX's DeepFM and the port's on the same (converted) weights."""
    jspecs = tuple(jfeatures.Feature(n, **kw) for n, kw in SERVE_SPECS)
    specs = tuple(Feature(n, **kw) for n, kw in SERVE_SPECS)
    jmodel = jranking.DeepFM(jspecs, embedding_dim=8, hidden=(16,))
    sample = serve_batch(rng, 16)
    params = jmodel.init(jax.random.PRNGKey(0),
                         {k: jnp.asarray(v) for k, v in sample.items()})
    model = DeepFM(specs, embedding_dim=8, hidden=(16,))
    model.load_state_dict(deepfm_from_flax(jax.tree.map(np.asarray,
                                                        params)))
    return jmodel, params, model, sample


def test_served_deepfm_matches_jax_serving(tmp_path, rng, deepfm_pair):
    jmodel, params, model, sample = deepfm_pair
    jpath = jserving.export_model(str(tmp_path / "jax"), jmodel.apply,
                                  params, sample)
    jserved = jserving.load_serving_module(jpath, params_template=params)
    path = export_model(str(tmp_path / "port"), model, as_torch(sample))
    served = load_serving_module(path, device=CPU)
    assert isinstance(served, ServingModule)
    with open(os.path.join(path, "signature.json")) as f:
        signature = json.load(f)
    with open(os.path.join(jpath, "signature.json")) as f:
        assert signature == json.load(f)  # the same schema and values
    for b in (16, 64):  # the sample's batch and another one
        batch = sample if b == 16 else serve_batch(rng, b)
        got = served(as_torch(batch))
        want = jserved({k: jnp.asarray(v) for k, v in batch.items()})
        assert got.shape == (b, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        with torch.no_grad():
            assert torch.equal(got, model.eval()(as_torch(batch)))


def test_serving_validates_inputs(tmp_path, rng, deepfm_pair):
    _, _, model, sample = deepfm_pair
    served = load_serving_module(
        export_model(str(tmp_path / "e"), model, as_torch(sample)),
        device=CPU)
    with pytest.raises(ValueError, match="missing serving inputs"):
        served({"user": torch.from_numpy(sample["user"])})
    # inputs the signature lacks are dropped; numpy arrays are taken
    extra = dict(sample, unused=np.zeros(16, np.float32))
    assert torch.equal(served(extra), served(as_torch(sample)))


def test_a_retrained_checkpoint_serves_with_the_same_program(tmp_path, rng,
                                                             deepfm_pair):
    _, _, model, sample = deepfm_pair
    path = export_model(str(tmp_path / "e"), model, as_torch(sample))
    retrained = DeepFM(tuple(Feature(n, **kw) for n, kw in SERVE_SPECS),
                       embedding_dim=8, hidden=(16,),
                       generator=torch.Generator().manual_seed(9))
    save_checkpoint(os.path.join(path, "params"), retrained.state_dict())
    served = load_serving_module(path, device=CPU)
    batch = as_torch(serve_batch(rng, 20))
    with torch.no_grad():
        want = retrained.eval()(batch)
        assert not torch.equal(want, model.eval()(batch))
    assert torch.equal(served(batch), want)


XDEEPFM_SPECS = tuple(Feature(n, **kw) for n, kw in SERVE_SPECS)


@pytest.mark.parametrize("maps,op", [((6, 6), "cin_stack_fwd_pooled"),
                                     ((6, 6, 6), "cin2d_fwd")])
def test_xdeepfm_export_records_its_kernel_op(tmp_path, rng, maps, op):
    model = XDeepFM(XDEEPFM_SPECS, embedding_dim=8, cin_feature_maps=maps,
                    hidden=(16,), generator=torch.Generator().manual_seed(0))
    path = export_model(str(tmp_path / "x"), model,
                        as_torch(serve_batch(rng, 8)))
    served = load_serving_module(path, device=CPU)
    assert custom_ops.graph_ops(served.program.graph_module) == {op}
    assert custom_ops.graph_ops(served.module) == {op}
    for b in (8, 40):
        batch = as_torch(serve_batch(rng, b))
        with torch.no_grad():
            assert torch.equal(served(batch), model.eval()(batch))


class Seq2Seq(torch.nn.Module):
    """The Transformer called on a batch dict, as export_model calls."""

    def __init__(self, transformer):
        super().__init__()
        self.transformer = transformer

    def forward(self, batch):
        return self.transformer(batch["inputs"], batch["targets"])


def tokens(rng, b):
    inputs = rng.integers(1, 30, (b, 6))
    inputs[:, -2:] = 0  # padding
    return {"inputs": torch.from_numpy(inputs),
            "targets": torch.from_numpy(rng.integers(1, 30, (b, 5)))}


def transformer(compute_dtype=None, use_flash=True):
    model = Transformer(30, 16, 2, 1, 1, 32, dropout=0.0,
                        compute_dtype=compute_dtype,
                        generator=torch.Generator().manual_seed(0))
    for m in model.modules():  # the CPU's dispatch would go dense
        if hasattr(m, "use_flash"):
            m.use_flash = use_flash
    return Seq2Seq(model)


@pytest.mark.parametrize("dtype,op", [
    (None, "flash_attention_fwd"),
    (torch.bfloat16, "flash_attention_fwd_bf16")])
def test_transformer_export_records_the_attention_op(tmp_path, rng, dtype,
                                                     op):
    model = transformer(dtype)
    served = load_serving_module(
        export_model(str(tmp_path / "t"), model, tokens(rng, 2)), device=CPU)
    assert custom_ops.graph_ops(served.program.graph_module) == {op}
    calls = [n for n in served.program.graph.nodes
             if n.op == "call_function" and getattr(n.target, "namespace",
                                                    None) == NS]
    assert len(calls) == 3  # encoder self, decoder self and cross
    for b in (2, 3):
        batch = tokens(rng, b)
        with torch.no_grad():
            assert torch.equal(served(batch), model.eval()(batch))


def test_polymorphic_batch_refuses_the_cards_attention_dispatch(
        tmp_path, rng, monkeypatch):
    """On the card attention's dispatch reads the batch size, so a
    polymorphic export raises ValueError; a fixed one serves its batch
    size alone. The rule is run here as the card runs it."""
    rule = att.use_flash_for
    monkeypatch.setattr(att, "use_flash_for",
                        lambda bh, sq, sk, device_type, dropout:
                        rule(bh, sq, sk, "cuda", dropout))
    model = transformer(use_flash=None)
    with pytest.raises(ValueError, match="polymorphic_batch=False"):
        export_model(str(tmp_path / "p"), model, tokens(rng, 2))
    sample = tokens(rng, 2)
    served = load_serving_module(
        export_model(str(tmp_path / "f"), model, sample,
                     polymorphic_batch=False), device=CPU)
    with torch.no_grad():
        assert torch.equal(served(sample), model.eval()(sample))
    with pytest.raises((AssertionError, RuntimeError)):
        served(tokens(rng, 3))


def test_no_kernel_op_is_recorded_outside_the_kernels(tmp_path, rng,
                                                      deepfm_pair):
    _, _, model, sample = deepfm_pair
    served = load_serving_module(
        export_model(str(tmp_path / "d"), model, as_torch(sample)),
        device=CPU)
    assert custom_ops.graph_ops(served.program.graph_module) == set()


def test_k3_inference_writes_no_residuals(rng):
    x0v = torch.randn(32, 3).bfloat16()
    w1, w2 = torch.randn(3, 3, 5), torch.randn(3, 5, 4)
    p1, p2, z1, z2 = ck.stack_forward(x0v, w1, w2, 4, residuals=False)
    assert z1 is None and z2 is None
    want = ck.stack_forward_reference(x0v, w1, w2, 4)
    assert torch.equal(p1, want[0]) and torch.equal(p2, want[1])
    full = ck.stack_forward(x0v, w1, w2, 4)
    for a, b in zip(full, want):
        assert torch.equal(a, b)


# -- model_io over the zoo --------------------------------------------------------

SPECS = (
    ("user", dict(hash_buckets=50)),
    ("gender", dict(vocab=("F", "M"))),
    ("item", dict(hash_buckets=60)),
    ("tags", dict(vocab=tuple(range(7)), max_len=3)),
)
CROSS = ("gxi", ("gender", "item"), 40)


def _specs(module):
    return tuple(module.Feature(n, **kw) for n, kw in SPECS)


def _id_batch(rng, b=8):
    return {
        "user": rng.integers(0, 50, b).astype(np.int32),
        "gender": rng.integers(0, 3, b).astype(np.int32),
        "item": rng.integers(0, 60, b).astype(np.int32),
        "tags": rng.integers(0, 8, (b, 3)).astype(np.int32),
        "tags__wt": (rng.random((b, 3)) < 0.8).astype(np.float32),
    }


def _dense_x(rng):
    return (rng.normal(size=(8, 16)).astype(np.float32),)


def _tower_batches(rng):
    return ({"user": rng.integers(0, 50, 8).astype(np.int32),
             "gender": rng.integers(0, 3, 8).astype(np.int32)},
            {"item": rng.integers(0, 60, 8).astype(np.int32),
             "tags": rng.integers(0, 8, (8, 3)).astype(np.int32),
             "tags__wt": np.ones((8, 3), np.float32)})


# name: (the port's model, the JAX model, the inputs), as in
# tests/test_model_io.py; the port's constructors take the input widths
# flax infers (MMoE's and ESMM's input_dim, GCN's in_features).
ZOO = {
    "deepfm": (lambda m, s: m.DeepFM(s, embedding_dim=8, hidden=(16,)),
               lambda rng: (_id_batch(rng),)),
    "fm": (lambda m, s: m.FactorizationMachine(s, embedding_dim=8),
           lambda rng: (_id_batch(rng),)),
    "fnn": (lambda m, s: m.FNN(s, embedding_dim=8, hidden=(16,)),
            lambda rng: (_id_batch(rng),)),
    "widedeep": (
        lambda m, s: m.WideDeep(
            deep_specs=s, wide_specs=s + (m.CrossedFeature(
                CROSS[0], CROSS[1], hash_buckets=CROSS[2]),),
            embedding_dim=8, hidden=(16,)),
        lambda rng: ({**_id_batch(rng),
                      "gxi": rng.integers(0, 40, 8).astype(np.int32)},)),
    "dcn": (lambda m, s: m.DCN(s, embedding_dim=8, num_cross_layers=2,
                               projection_dim=4, hidden=(16,)),
            lambda rng: (_id_batch(rng),)),
    "xdeepfm": (lambda m, s: m.XDeepFM(s, embedding_dim=8,
                                       cin_feature_maps=(8,), hidden=(16,)),
                lambda rng: (_id_batch(rng),)),
    "xdeepfm_stack": (lambda m, s: m.XDeepFM(
        s, embedding_dim=8, cin_feature_maps=(6, 6), hidden=(16,)),
        lambda rng: (_id_batch(rng),)),
    "mmoe": (lambda m, s, **kw: m.MMoE(
        num_tasks=2, num_experts=3, expert_hidden=(16,), expert_dim=8,
        tower_hidden=(8,), **kw), _dense_x),
    "esmm": (lambda m, s, **kw: m.ESMM(cvr_hidden=(16,), ctr_hidden=(16,),
                                       **kw), _dense_x),
    "gcn": (lambda m, s, **kw: m.GCN(hidden=(8,), num_classes=3,
                                     dropout=0.0, **kw),
            lambda rng: (rng.normal(size=(10, 12)).astype(np.float32),
                         np.eye(10, dtype=np.float32))),
    "transformer": (lambda m, s: m.Transformer(
        vocab_size=30, model_dim=16, num_heads=2, num_encoder_layers=1,
        num_decoder_layers=1, ffn_dim=32, dropout=0.0),
        lambda rng: (rng.integers(1, 30, (2, 6)), rng.integers(1, 30, (2, 5)))),
    "two_tower": (lambda m, s: m.TwoTower(
        query_specs=s[:2], candidate_specs=s[2:], embedding_dim=8,
        hidden=(16,), output_dim=8), _tower_batches),
    "din": (lambda m, s, **kw: m.DIN(attention_units=8, hidden=(16,),
                                     use_dice=True, **kw),
            lambda rng: (rng.normal(size=(4, 5, 8)).astype(np.float32),
                         np.ones((4, 5), np.float32),
                         rng.normal(size=(4, 8)).astype(np.float32))),
}
# Arguments the port's constructor needs where flax infers them.
PORT_ARGS = {"mmoe": dict(input_dim=16), "esmm": dict(input_dim=16),
             "gcn": dict(in_features=12), "din": dict(embedding_dim=8)}
# Arguments of the port alone: flax infers DIN's context width.
PORT_ONLY = {"din": ("context_dim",)}


class _Port:
    """The port's classes under the names the ZOO builders use."""
    Feature, CrossedFeature = Feature, CrossedFeature
    DeepFM, FactorizationMachine, FNN, WideDeep = (
        DeepFM, FactorizationMachine, FNN, WideDeep)
    DCN, XDeepFM, MMoE, ESMM, GCN = DCN, XDeepFM, MMoE, ESMM, GCN
    Transformer, TwoTower, DIN = Transformer, TwoTower, DIN


class _Jax:
    Feature = jfeatures.Feature
    CrossedFeature = jfeatures.CrossedFeature
    DeepFM, FactorizationMachine, FNN = (
        jranking.DeepFM, jranking.FactorizationMachine, jranking.FNN)
    WideDeep, DCN, XDeepFM, DIN = (jranking.WideDeep, jranking.DCN,
                                   jranking.XDeepFM, jranking.DIN)
    MMoE, ESMM = jmultitask.MMoE, jmultitask.ESMM
    GCN, TwoTower = jretrieval.GCN, jretrieval.TwoTower
    Transformer = jnlp.Transformer


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _outputs(o)]


def _port_args(args):
    return tuple(as_torch(a) if isinstance(a, dict) else torch.from_numpy(
        np.asarray(a)) for a in args)


def test_the_zoo_has_13_cases():
    assert len(ZOO) == 13


@pytest.mark.parametrize("name", sorted(ZOO))
def test_save_load_round_trip(name, rng, tmp_path):
    build, make_args = ZOO[name]
    model = build(_Port, _specs(_Port), **PORT_ARGS.get(name, {}))
    args = _port_args(make_args(rng))
    model.eval()
    with torch.no_grad():
        before = _outputs(model(*args))

    path = save_model(str(tmp_path / name), model)
    model2 = load_model(path, device=CPU).eval()
    assert type(model2) is type(model)
    assert model_config(model2) == model_config(model)
    with torch.no_grad():
        after = _outputs(model2(*args))
    assert len(before) == len(after) > 0
    for a, b in zip(before, after):
        assert torch.equal(a, b)

    # The JAX package's config of the same model: every argument the two
    # share is encoded alike (the tagged specs and tuples), runtime ones
    # (mesh; the port's generator) as null. The widths the port is given
    # where flax infers them are the port's own (DIN's embedding_dim sizes
    # its vector inputs here, JAX's only its item table).
    jcfg = jserving.model_config(build(_Jax, _specs(_Jax)))
    cfg = model_config(model)
    shared = set(cfg) & set(jcfg) - set(PORT_ARGS.get(name, {}))
    assert shared and {k: cfg[k] for k in shared} == {
        k: jcfg[k] for k in shared}
    assert cfg.get("generator", None) is None
    assert set(cfg) - set(jcfg) <= {"generator", *PORT_ARGS.get(name, {}),
                                    *PORT_ONLY.get(name, ())}


def test_load_model_with_a_mesh_raises(tmp_path):
    model = DeepFM(_specs(_Port), embedding_dim=8, hidden=(16,))
    path = save_model(str(tmp_path / "m"), model)
    with pytest.raises(NotImplementedError, match="mesh"):
        load_model(path, mesh=object(), device=CPU)


def test_unserializable_configs_are_refused_as_in_jax(tmp_path):
    bf16 = DeepFM(_specs(_Port), embedding_dim=8, hidden=(16,),
                  compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="not serializable"):
        save_model(str(tmp_path / "b"), bf16)
    with pytest.raises(TypeError, match="not serializable"):
        jserving.model_config(_Jax.DeepFM(_specs(_Jax), embedding_dim=8,
                                          compute_dtype=jnp.bfloat16))
    with pytest.raises(TypeError, match="records no constructor"):
        model_config(torch.nn.Linear(2, 2))


def test_load_model_imports_only_the_zoo(tmp_path):
    path = save_model(str(tmp_path / "m"), DeepFM(
        _specs(_Port), embedding_dim=8, hidden=(16,)))
    config = os.path.join(path, "config.json")
    with open(config) as f:
        spec = json.load(f)
    for module, cls, error in (("os", "system", "not a module"),
                               ("deep_recommenders_torch.models.common",
                                "MLP", "records no config")):
        with open(config, "w") as f:
            json.dump(dict(spec, module=module, **{"class": cls}), f)
        with pytest.raises(ValueError, match=error):
            load_model(path, device=CPU)


# -- profiler ------------------------------------------------------------------------

def test_step_timer_reports_at_log_boundaries(monkeypatch):
    clock = iter([10.0, 12.0, 14.0])
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: next(clock))
    timer = profiler.StepTimer(examples_per_step=8, log_every=2)
    assert timer.step() is None  # starts the clock at 10.0
    assert timer.step() == pytest.approx(2 * 8 / 2.0)  # 12.0
    assert timer.step() is None
    assert timer.step() == pytest.approx(4 * 8 / 4.0)  # 14.0


def test_trace_writes_a_chrome_trace_naming_the_op(tmp_path):
    x0v = torch.randn(32, 3).bfloat16()
    w1, w2 = torch.randn(3, 3, 5), torch.randn(3, 5, 4)
    with profiler.trace(str(tmp_path / "logs")):
        ck.stack_forward(x0v, w1, w2, 4, residuals=False)
    files = glob.glob(str(tmp_path / "logs" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert f"{NS}::cin_stack_fwd_pooled" in names
