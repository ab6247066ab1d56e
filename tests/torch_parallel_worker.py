"""Worker of tests/test_torch_parallel.py: one process of a gloo group on the
CPU, running the port's meshed cases and writing its results.

    python tests/torch_parallel_worker.py PORT PORT2 RANK IN_DIR OUT_DIR

The four processes form a (data=2, model=2) mesh over 127.0.0.1:PORT; then
ranks 0 and 1 form a (data=2, model=1) mesh over 127.0.0.1:PORT2 for the
multi-process losses of tests/multihost_worker.py. Inputs (the JAX
package's initial weights and the global batches, flattened to
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


def fit_device_case(mesh, inputs, out):
    """One epoch of fit_device on a (data=2, model=2) mesh: each process
    uploads its slice; the step losses and the evaluation."""
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
    try:
        trainer.fit_device(data, epochs=1, checkpoint_dir="unused",
                           verbose=False)
    except NotImplementedError as e:
        out["fit/checkpoint_refused"] = np.asarray(str(e))


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


def main():
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
    fit_device_case(mesh, inputs, out)
    dist.destroy_process_group()
    if rank < 2:
        multihost_case(rank, port2, inputs, out_dir, out)
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
