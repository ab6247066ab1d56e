"""Worker of tests/test_torch_parallel.py and
tests/test_torch_parallel_models.py: one process of a gloo group on the
CPU, running the port's meshed cases and writing its results.

    python tests/torch_parallel_worker.py PORT PORT2 RANK IN_DIR OUT_DIR
    python tests/torch_parallel_worker.py models PORTS RANK IN_DIR OUT_DIR

The four processes form a (data=2, model=2) mesh over 127.0.0.1:PORT; then
ranks 0 and 1 form a (data=2, model=1) mesh over 127.0.0.1:PORT2 for the
multi-process losses of tests/multihost_worker.py. The ``models`` form
runs the meshed two-tower, ShardedBruteForce, expert-parallel MMoE, the
sharded checkpoints and load_model(mesh=) (see ``models_main``). Inputs
(the JAX package's initial weights and the global batches, flattened to
``a/b/c`` keys) come from IN_DIR/inputs.npz; each rank writes its results
to OUT_DIR/rank{RANK}.npz. This file imports torch and the port only.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_functional

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deep_recommenders_torch import convert  # noqa: E402
from deep_recommenders_torch.embedding import sharded  # noqa: E402
from deep_recommenders_torch.embedding.engine import _offsets  # noqa: E402
from deep_recommenders_torch.features import Feature  # noqa: E402
from deep_recommenders_torch.models.multitask import ESMM  # noqa: E402
from deep_recommenders_torch.models.ranking import (  # noqa: E402
    DIN,
    DeepFM,
    XDeepFM,
)
from deep_recommenders_torch.parallel import (  # noqa: E402
    DATA_AXIS,
    MODEL_AXIS,
    MeshConfig,
    axis_group,
    axis_index,
    create_mesh,
    get_default_mesh,
    initialize_distributed,
    replicate_on_mesh,
    set_default_mesh,
    shard_batch,
)
from deep_recommenders_torch.training import (  # noqa: E402
    DeviceData,
    Trainer,
    binary_cross_entropy,
)

torch.set_num_threads(1)

# Shared with the test: the models' widths and the feature specs.
B = 16            # global batch of the one-step cases
D = 8
T = 8             # DIN's behaviors
NUM_ITEMS = 301   # DIN's items: odd, so the model axis pads the table
FIT_ROWS, FIT_BATCH = 128, 32


def specs():
    # 301 + 3 + 400 + 19 = 723 fused rows: padded to 724 at model = 2.
    return (
        Feature("u", hash_buckets=301),
        Feature("g", vocab=("F", "M")),
        Feature("m", hash_buckets=400),
        Feature("tags", vocab=tuple(range(18)), max_len=4),
    )


def models(mesh):
    """name -> (port model on ``mesh``, converter, loss_fn factory)."""
    gen = torch.Generator().manual_seed(0)

    def bce(model):
        return lambda batch, labels: binary_cross_entropy(model(batch),
                                                          labels)

    def din_loss(model):
        return lambda batch, labels: binary_cross_entropy(
            model(batch["behaviors"], batch["mask"], batch["candidate"]),
            labels)

    def esmm_loss(model):
        def loss_fn(batch, labels):
            _, p_ctr, p_ctcvr = model(batch)
            return sum(
                -(y * torch.log(p + 1e-7)
                  + (1 - y) * torch.log(1 - p + 1e-7)).mean()
                for p, y in ((p_ctr, labels[:, :1]),
                             (p_ctcvr, labels[:, 1:])))
        return loss_fn

    return {
        "deepfm": (DeepFM(specs(), D, (16,), mesh=mesh, generator=gen),
                   convert.deepfm_from_flax, bce),
        "xdeepfm": (XDeepFM(specs(), D, (12, 20), "relu", (16, 8),
                            mesh=mesh, generator=gen),
                    convert.xdeepfm_from_flax, bce),
        "din": (DIN(8, (16,), num_items=NUM_ITEMS, embedding_dim=D,
                    mesh=mesh, generator=gen),
                convert.din_from_flax, din_loss),
        "esmm": (ESMM(cvr_hidden=(16,), ctr_hidden=(16,), specs=specs(),
                      embedding_dim=D, mesh=mesh, generator=gen),
                 convert.esmm_from_flax, esmm_loss),
    }


def unflatten(flat, prefix):
    """``{"a/b/c": x}`` entries under ``prefix/`` -> nested dicts."""
    out = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def local(x, mesh):
    """This process's data slice of a global batch (a nested dict)."""
    n = mesh.size(0)
    d = axis_index(mesh, DATA_AXIS)
    if isinstance(x, dict):
        return {k: local(v, mesh) for k, v in x.items()}
    b = x.shape[0] // n
    return x[d * b:(d + 1) * b]


def load(model, converter, inputs, name, mesh):
    state = converter(unflatten(inputs, f"{name}/params"))
    state = convert.shard_state(state, mesh.size(1),
                                axis_index(mesh, MODEL_AXIS))
    model.load_state_dict(state)


def primitive_cases(mesh, inputs, out):
    """sharded_lookup, sharded_embedding_bag and sharded_fused_rows on this
    rank's shard, forward and the shard's gradient summed over the data
    group (the gradient of the global batch's loss)."""
    n_model, m = mesh.size(1), axis_index(mesh, MODEL_AXIS)
    table = torch.from_numpy(inputs["prim/table"])
    rows = table.shape[0] // n_model
    ids = torch.from_numpy(local(inputs["prim/ids"], mesh))
    bag = torch.from_numpy(local(inputs["prim/bag"], mesh))
    wt = torch.from_numpy(local(inputs["prim/wt"], mesh))
    weight = torch.from_numpy(local(inputs["prim/w_out"], mesh))
    fused_table = torch.from_numpy(inputs["prim/fused_table"])
    frows = fused_table.shape[0] // n_model
    batch = {k[len("prim/batch/"):]: torch.from_numpy(local(v, mesh))
             for k, v in inputs.items() if k.startswith("prim/batch/")}
    cases = {
        "lookup": (table, rows, lambda s: sharded.sharded_lookup(
            s, ids, mesh)),
        "lookup2d": (table, rows, lambda s: sharded.sharded_lookup(
            s, bag, mesh)),
        "bag_sum": (table, rows, lambda s: sharded.sharded_embedding_bag(
            s, bag, wt, mesh, combiner="sum")),
        "bag_mean": (table, rows, lambda s: sharded.sharded_embedding_bag(
            s, bag, wt, mesh, combiner="mean")),
        "fused": (fused_table, frows, lambda s: sharded.sharded_fused_rows(
            s, specs(), _offsets(specs())[0], batch, mesh)),
    }
    for name, (full, n, fn) in cases.items():
        shard = full[m * n:(m + 1) * n].clone().requires_grad_()
        y = fn(shard)
        w = weight.reshape(weight.shape[0], *([1] * (y.dim() - 2)), -1)
        (y * w[..., :y.shape[-1]]).sum().backward()
        grad = shard.grad.clone()
        dist.all_reduce(grad, group=axis_group(mesh, DATA_AXIS))
        out[f"prim/{name}/out"] = y.detach().numpy()
        out[f"prim/{name}/grad"] = grad.numpy()


def batch_of(name, inputs, mesh):
    feats = {k[len(f"{name}/batch/"):]: v for k, v in inputs.items()
             if k.startswith(f"{name}/batch/")}
    return shard_batch(local(feats, mesh), mesh), shard_batch(
        local(inputs[f"{name}/labels"], mesh), mesh)


def step_cases(mesh, inputs, out):
    """One step of each model (SGD at lr 0, so the weights stay put): the
    global mean loss and every gradient after the data all-reduce."""
    for name, (model, converter, loss) in models(mesh).items():
        load(model, converter, inputs, name, mesh)
        trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.0),
                          loss_fn=loss(model), mesh=mesh, device="cpu")
        batch, labels = batch_of(name, inputs, mesh)
        out[f"{name}/loss"] = trainer.train_step(batch, labels).numpy()
        for k, p in model.named_parameters():
            out[f"{name}/grad/{k}"] = p.grad.numpy()
        if name == "deepfm":
            # The same step with an all-reduce whose backward sums the
            # cotangents over the model group: every table gradient
            # comes out n_model times too large.
            group = axis_group(mesh, MODEL_AXIS)
            honest = sharded.sum_over_model
            sharded.sum_over_model = (
                lambda x, mesh: dist_functional.all_reduce(x, group=group))
            try:
                trainer.train_step(batch, labels)
            finally:
                sharded.sum_over_model = honest
            for k, p in model.named_parameters():
                out[f"deepfm_summing_backward/grad/{k}"] = p.grad.numpy()
            # Merged evaluation over the data group, on the same weights.
            evaluation = trainer.evaluate(lambda: [(batch, labels)] * 2)
            for k, v in evaluation.items():
                out[f"deepfm/eval/{k}"] = np.float64(v)


def fit_device_case(mesh, inputs, out_dir, out):
    """One epoch of fit_device on a (data=2, model=2) mesh: each process
    uploads its slice; the step losses and the evaluation; then an epoch
    with a checkpoint directory, whose checkpoint is sharded."""
    model, converter, _ = models(mesh)["deepfm"]
    load(model, converter, inputs, "deepfm", mesh)
    trainer = Trainer(model, torch.optim.Adam(model.parameters(), lr=1e-2),
                      mesh=mesh, device="cpu")
    feats = {k[len("fit/feats/"):]: v for k, v in inputs.items()
             if k.startswith("fit/feats/")}
    labels = inputs["fit/labels"]
    data = DeviceData.from_numpy(local(feats, mesh), local(labels, mesh),
                                 FIT_BATCH, device="cpu", mesh=mesh)
    result = trainer.fit_device(data, data, epochs=1, shuffle_seed=3,
                                verbose=False)
    out["fit/step_losses"] = result["step_losses"]
    for k, v in result["history"][0].items():
        out[f"fit/history/{k}"] = np.float64(v)
    ckpt = os.path.join(out_dir, "ckpt22")
    trainer.fit_device(data, epochs=1, checkpoint_dir=ckpt, verbose=False)
    out["fit/checkpoint_files"] = np.asarray(
        sorted(os.listdir(os.path.join(ckpt, "step_0"))))


def multihost_case(rank, port2, inputs, out_dir, out):
    """tests/multihost_worker.py's DeepFM, 5 SGD steps at (data=2,
    model=1), each process feeding its half of every global batch; then
    fit_device with a checkpoint directory, and again resumed."""
    import multihost_worker as worker

    initialize_distributed(f"127.0.0.1:{port2}", 2, rank, device="cpu")
    mesh = create_mesh(MeshConfig(data=2, model=1), device="cpu")
    mh_specs = (
        Feature("u", hash_buckets=40),
        Feature("g", vocab=("F", "M")),
        Feature("m", hash_buckets=50),
        Feature("tags", vocab=tuple(range(7)), max_len=3),
    )
    model = DeepFM(mh_specs, embedding_dim=8, hidden=(16,), mesh=mesh)
    model.load_state_dict(convert.deepfm_from_flax(
        unflatten(inputs, "multihost/params")))
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.5),
                      mesh=mesh, device="cpu")
    half = worker.GLOBAL_BATCH // 2
    losses = []
    for step in range(worker.STEPS):
        feats, labels = worker.global_batch(step)
        lo, hi = rank * half, (rank + 1) * half
        losses.append(trainer.train_step(
            shard_batch({k: v[lo:hi] for k, v in feats.items()}, mesh),
            shard_batch(labels[lo:hi], mesh)).item())
    out["multihost/losses"] = np.asarray(losses)
    # fit_device's checkpoints at model = 1: rank 0 writes, both resume.
    feats, labels = worker.global_batch(0)
    data = DeviceData.from_numpy(
        {k: v[lo:hi] for k, v in feats.items()}, labels[lo:hi], 8,
        device="cpu", mesh=mesh)
    ckpt = os.path.join(out_dir, "ckpt")
    first = trainer.fit_device(data, epochs=1, checkpoint_dir=ckpt,
                               verbose=False)
    resumed = trainer.fit_device(data, epochs=2, checkpoint_dir=ckpt,
                                 verbose=False)
    out["multihost/ckpt_epochs"] = np.asarray(
        [h["epoch"] for h in first["history"] + resumed["history"]])
    out["multihost/ckpt_dirs"] = np.asarray(sorted(os.listdir(ckpt)))


# -- the meshed models of tests/test_torch_parallel_models.py --------------

TT_B = 16  # the two-tower's global batch


def tower_specs():
    """The two-tower's features (tests/test_two_tower_mesh.py's): 308
    query rows and 419 candidate rows, which model = 2 pads to 420."""
    return ((Feature("user_id", hash_buckets=300),
             Feature("user_age", vocab=tuple(range(7)))),
            (Feature("movie_id", hash_buckets=400),
             Feature("movie_genres", vocab=tuple(range(18)), max_len=4)))


def prefixed(inputs, prefix):
    return {k[len(prefix) + 1:]: v for k, v in inputs.items()
            if k.startswith(prefix + "/")}


def two_tower_cases(mesh, inputs, out):
    """The meshed two-tower with Retrieval(axis_name="data", mesh=): one
    step's loss and gradients (SGD at lr 0), the same with the log-Q
    correction and accidental-negative removal, and one Adagrad step's
    parameters; each process feeds its data coordinate's rows."""
    from deep_recommenders_torch.models.retrieval import Retrieval, TwoTower
    from deep_recommenders_torch.training import Adagrad
    from deep_recommenders_torch.training.evaluation import retrieval_loss

    n_model, m = mesh.size(1), axis_index(mesh, MODEL_AXIS)
    state = convert.shard_state(convert.two_tower_from_flax(
        unflatten(inputs, "tt/params")), n_model, m)
    qb = shard_batch(local(prefixed(inputs, "tt/q"), mesh), mesh)
    cb = shard_batch(local(prefixed(inputs, "tt/c"), mesh), mesh)
    labels = shard_batch(local({
        "candidate_ids": inputs["tt/ids"],
        "sampling_prob": inputs["tt/probs"]}, mesh), mesh)
    cases = {
        "plain": (dict(temperature=0.2), None, torch.optim.SGD, 0.0),
        "options": (dict(temperature=0.5, remove_accidental_negatives=True),
                    labels, torch.optim.SGD, 0.0),
        "adagrad": (dict(temperature=0.2), None, Adagrad, 0.1),
    }
    for name, (kw, lab, opt, lr) in cases.items():
        model = TwoTower(*tower_specs(), embedding_dim=8, hidden=(16,),
                         output_dim=8, mesh=mesh)
        model.load_state_dict(state)
        task = Retrieval(axis_name=DATA_AXIS, mesh=mesh, **kw)
        trainer = Trainer(model, opt(model.parameters(), lr),
                          loss_fn=retrieval_loss(model, task), mesh=mesh,
                          device="cpu")
        before = sharded.all_reduce.calls
        loss = trainer.train_step((qb, cb), lab)
        out[f"tt/{name}/all_reduces"] = np.asarray(
            sharded.all_reduce.calls - before)
        out[f"tt/{name}/loss"] = loss.numpy()
        for k, p in model.named_parameters():
            out[f"tt/{name}/grad/{k}"] = p.grad.numpy()
            out[f"tt/{name}/param/{k}"] = p.detach().numpy()


def topk_cases(mesh, inputs, out, tag):
    """ShardedBruteForce over the corpus: row ids, integer and string
    identifiers, k past a shard and past the corpus, a query model,
    exclusions, data-sharded queries, FactorizedTopK with the index, and
    the save_index/load_index(mesh=) round trip."""
    from deep_recommenders_torch.models.retrieval import (
        FactorizedTopK,
        ShardedBruteForce,
        load_index,
        save_index,
    )
    from deep_recommenders_torch.ops.topk import sharded_top_k

    corpus = torch.from_numpy(inputs["topk/corpus"])
    queries = torch.from_numpy(inputs["topk/queries"])
    int_ids = inputs["topk/int_ids"]
    str_ids = inputs["topk/str_ids"]
    excl = torch.from_numpy(inputs["topk/exclusions"])
    n_model, m = mesh.size(1), axis_index(mesh, MODEL_AXIS)
    rows = -(-corpus.shape[0] // n_model)
    padded = torch.cat([corpus, corpus.new_zeros(
        rows * n_model - corpus.shape[0], corpus.shape[1])])
    for k in (5, 12, 40):
        s, i = sharded_top_k(queries, padded[m * rows:(m + 1) * rows], k,
                             mesh, num_valid=corpus.shape[0])
        out[f"topk/{tag}/op/{k}/scores"] = s.numpy()
        out[f"topk/{tag}/op/{k}/ids"] = i.numpy()
        index = ShardedBruteForce(mesh).index(corpus)
        s, i = index(queries, k)
        out[f"topk/{tag}/rows/{k}/scores"] = s.numpy()
        out[f"topk/{tag}/rows/{k}/ids"] = i.numpy()
    index = ShardedBruteForce(mesh, query_model=lambda x: x * 2.0).index(
        corpus, int_ids)
    s, i = index(queries, 12)
    out[f"topk/{tag}/int/scores"] = s.numpy()
    out[f"topk/{tag}/int/ids"] = i.numpy()
    s, i = index.query_with_exclusions(queries, excl, 5)
    out[f"topk/{tag}/excl/scores"] = s.numpy()
    out[f"topk/{tag}/excl/ids"] = i.numpy()
    s, i = ShardedBruteForce(mesh).index(corpus, str_ids)(queries, 40)
    out[f"topk/{tag}/str/scores"] = s.numpy()
    out[f"topk/{tag}/str/ids"] = i.astype(np.str_)
    out[f"topk/{tag}/data"] = np.asarray(axis_index(mesh, DATA_AXIS))
    own = local(queries, mesh)
    s, i = ShardedBruteForce(mesh, queries_data_sharded=True).index(
        corpus, int_ids)(own, 12)
    out[f"topk/{tag}/data_sharded/scores"] = s.numpy()
    out[f"topk/{tag}/data_sharded/ids"] = i.numpy()
    metric = FactorizedTopK(ShardedBruteForce(mesh).index(corpus),
                            ks=(1, 5, 10))
    state = metric.update(metric.init(), queries, corpus[:queries.shape[0]])
    out[f"topk/{tag}/metric"] = torch.stack(
        list(metric.compute(state).values())).numpy()
    path = os.path.join(OUT_DIR, f"index_{tag}")
    save_index(path, index)
    again = load_index(path, query_model=lambda x: x * 2.0, device="cpu",
                       mesh=mesh)
    s, i = again(queries, 12)
    out[f"topk/{tag}/loaded/scores"] = s.numpy()
    out[f"topk/{tag}/loaded/ids"] = i.numpy()


def mmoe_case(mesh, inputs, out):
    """MMoE with expert_parallel=True: one step's loss and gradients (SGD
    at lr 0) under the default mesh; the expert shards this process
    holds."""
    from deep_recommenders_torch.models.multitask import (
        MMoE,
        shard_expert_params,
    )
    from deep_recommenders_torch.training.evaluation import (
        multitask_mse_loss,
    )

    set_default_mesh(mesh)
    model = MMoE(12, num_tasks=2, num_experts=4, expert_hidden=(8,),
                 expert_dim=8, tower_hidden=(8,), expert_parallel=True)
    model.load_state_dict(shard_expert_params(
        convert.mmoe_from_flax(unflatten(inputs, "mmoe/params")), mesh))
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.0),
                      loss_fn=multitask_mse_loss(model), mesh=mesh,
                      device="cpu")
    x = shard_batch(local(inputs["mmoe/x"], mesh), mesh).requires_grad_()
    y = shard_batch(local(inputs["mmoe/y"], mesh), mesh)
    out["mmoe/loss"] = trainer.train_step(x, y).numpy()
    out["mmoe/x_grad"] = x.grad.numpy()
    for k, p in model.named_parameters():
        out[f"mmoe/grad/{k}"] = p.grad.numpy()
    out["mmoe/expert_rows"] = np.asarray(model.experts.kernels[0].shape[0])
    try:
        MMoE(12, num_experts=3, expert_parallel=True)
    except ValueError as e:
        out["mmoe/refused"] = np.asarray(str(e))
    set_default_mesh(None)


def ckpt_model(mesh, inputs):
    model, converter, _ = models(mesh)["deepfm"]
    load(model, converter, inputs, "deepfm", mesh)
    return model, torch.optim.Adam(model.parameters(), lr=1e-2)


def ckpt_data(inputs, mesh):
    feats = prefixed(inputs, "fit/feats")
    return DeviceData.from_numpy(local(feats, mesh),
                                 local(inputs["fit/labels"], mesh),
                                 FIT_BATCH, device="cpu", mesh=mesh)


def checkpoint_case(mesh, inputs, out):
    """DeepFM at (1, 2): two epochs of fit_device at once, and one epoch
    with a checkpoint directory, then a fresh model and optimizer resumed
    from it for the second; the load_model(mesh=) of an unmeshed artifact
    and save_model of the meshed model."""
    from deep_recommenders_torch.serving.model_io import (
        load_model,
        save_model,
    )

    data = ckpt_data(inputs, mesh)
    model, opt = ckpt_model(mesh, inputs)
    whole = Trainer(model, opt, mesh=mesh, device="cpu").fit_device(
        data, epochs=2, shuffle_seed=3, verbose=False)
    out["ckpt/uninterrupted"] = whole["step_losses"]
    ckpt = os.path.join(OUT_DIR, "ckpt12")
    model, opt = ckpt_model(mesh, inputs)
    first = Trainer(model, opt, mesh=mesh, device="cpu").fit_device(
        data, epochs=1, shuffle_seed=3, checkpoint_dir=ckpt, verbose=False)
    model, opt = ckpt_model(mesh, inputs)
    resumed = Trainer(model, opt, mesh=mesh, device="cpu").fit_device(
        data, epochs=2, shuffle_seed=3, checkpoint_dir=ckpt, verbose=False)
    out["ckpt/first"] = first["step_losses"]
    out["ckpt/resumed"] = resumed["step_losses"]
    out["ckpt/resumed_epochs"] = np.asarray(
        [h["epoch"] for h in resumed["history"]])
    feats = shard_batch(prefixed(inputs, "deepfm/batch"), mesh)
    loaded = load_model(os.path.join(OUT_DIR, "artifact"), mesh=mesh,
                        device="cpu")
    out["serve/meshed_logits"] = loaded(feats).detach().numpy()
    out["serve/table_rows"] = np.asarray(loaded.embeddings.table.shape[0])
    save_model(os.path.join(OUT_DIR, "meshed_artifact"), loaded)


def restore_case(mesh, out):
    """The (1, 2) checkpoint restored under this mesh: the state dicts."""
    from deep_recommenders_torch.training import restore_train_state

    model, _, _ = models(mesh)["deepfm"]
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    restore_train_state(os.path.join(OUT_DIR, "ckpt12", "step_0"), model,
                        opt, mesh)
    for k, v in model.state_dict().items():
        out[f"restored/model/{k}"] = v.numpy()
    for i, entry in opt.state_dict()["state"].items():
        for k, v in entry.items():
            out[f"restored/opt/{i}/{k}"] = v.numpy()


OUT_DIR = None


def models_main():
    """``models PORTS RANK IN_DIR OUT_DIR``: four processes at (2, 2), then
    at (1, 4); then ranks 0 and 1 at (1, 2) and at (2, 1). PORTS holds
    four ports, comma-separated. The processes share OUT_DIR (the
    checkpoint, the index and the artifacts); each writes its results to
    OUT_DIR/rank{R}.npz."""
    global OUT_DIR
    ports, rank, in_dir, out_dir = sys.argv[2:]
    ports, rank = ports.split(","), int(rank)
    OUT_DIR = out_dir
    inputs = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    out = {}
    meshes = [(4, (2, 2)), (4, (1, 4)), (2, (1, 2)), (2, (2, 1))]
    for port, (world, shape) in zip(ports, meshes):
        if rank >= world:
            break
        initialize_distributed(f"127.0.0.1:{port}", world, rank,
                               device="cpu")
        mesh = create_mesh(MeshConfig(*shape), device="cpu")
        tag = f"{shape[0]}x{shape[1]}"
        if shape == (2, 2):
            two_tower_cases(mesh, inputs, out)
            mmoe_case(mesh, inputs, out)
        if shape != (2, 1):
            topk_cases(mesh, inputs, out, tag)
        if shape == (1, 2):
            checkpoint_case(mesh, inputs, out)
        if shape == (2, 1):
            restore_case(mesh, out)
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def main():
    if sys.argv[1] == "models":
        return models_main()
    port, port2, rank, in_dir, out_dir = sys.argv[1:]
    rank = int(rank)
    inputs = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    out = {}
    initialize_distributed(f"127.0.0.1:{port}", 4, rank, device="cpu")
    mesh = create_mesh(MeshConfig(data=2, model=2), device="cpu")
    out["coords"] = np.asarray([axis_index(mesh, DATA_AXIS),
                                axis_index(mesh, MODEL_AXIS)])
    out["replicated"] = replicate_on_mesh(np.asarray([rank, 7]), mesh).numpy()
    set_default_mesh(mesh)
    out["default_mesh"] = np.asarray(get_default_mesh() is mesh)
    primitive_cases(mesh, inputs, out)
    step_cases(mesh, inputs, out)
    fit_device_case(mesh, inputs, out_dir, out)
    dist.destroy_process_group()
    if rank < 2:
        multihost_case(rank, port2, inputs, out_dir, out)
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
