"""Worker of tests/test_torch_bf16_table.py: one of two gloo processes on
the CPU, running DeepFM's composition over a bf16-stored table on a mesh
and writing its results.

    python tests/torch_bf16_table_worker.py PORT PORT2 RANK IN_DIR OUT_DIR

The two processes form a (data=2, model=1) mesh over 127.0.0.1:PORT: the
merged evaluation with non-default metrics, then one train step, whose
bf16 table gradient goes through the data all-reduce. Then a
(data=1, model=2) mesh over 127.0.0.1:PORT2: one train step with the
table's rows cut over "model" and the bf16 partial rows summed by the
model all-reduce. Inputs (the flax weights converted, the global batch)
come from IN_DIR/inputs.pt; each rank writes OUT_DIR/rank{RANK}.pt. This
file imports torch and the port only; the test imports its
:class:`Composition`.
"""

import os
import sys
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

from deep_recommenders_torch import convert  # noqa: E402
from deep_recommenders_torch.embedding.engine import (  # noqa: E402
    EmbeddingCollection,
    LinearTerms,
    fused_embedding_linear,
)
from deep_recommenders_torch.features import Feature  # noqa: E402
from deep_recommenders_torch.models.common import MLP  # noqa: E402
from deep_recommenders_torch.ops.fm import fm_interaction  # noqa: E402
from deep_recommenders_torch.parallel import (  # noqa: E402
    DATA_AXIS,
    MODEL_AXIS,
    MeshConfig,
    all_gather,
    axis_index,
    create_mesh,
    initialize_distributed,
    shard_batch,
)
from deep_recommenders_torch.training import (  # noqa: E402
    AUC,
    Adam,
    BinaryCTREval,
    PrecisionRecall,
    Trainer,
)

torch.set_num_threads(1)

LEARNING_RATE = 1e-3


class Composition(nn.Module):
    """DeepFM's composition (``models/ranking/deepfm.py``) over a table
    stored in ``param_dtype``: one fused pass of the table and the linear
    weights, the first-order sum and bias, the FM term and an MLP with no
    compute dtype, whose first layer promotes the bf16 rows to fp32."""

    def __init__(self, specs: Sequence[Feature], dim: int = 16,
                 hidden: Tuple[int, ...] = (256, 32),
                 param_dtype: torch.dtype = torch.bfloat16, mesh=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = LinearTerms(specs)
        self.embeddings = EmbeddingCollection(
            specs, dim, mesh=mesh, generator=generator,
            param_dtype=param_dtype)
        self.deep = MLP(len(self.embeddings.specs) * dim, hidden,
                        output_dim=1, generator=generator)

    def forward(self, batch) -> torch.Tensor:
        stacked, lin = fused_embedding_linear(self.embeddings, self.linear,
                                              batch)
        first_order = lin.sum(dim=1, keepdim=True) + self.linear.bias
        deep_logit = self.deep(stacked.reshape(stacked.shape[0], -1))
        return first_order + fm_interaction(stacked) + deep_logit.float()


def eval_spec(model):
    """The evaluation with both metrics off their defaults."""
    return BinaryCTREval(model, auc=AUC(num_thresholds=500),
                         pr=PrecisionRecall(threshold=0.3))


def local(x, mesh):
    """This process's data slice of a global batch (a dict or a tensor)."""
    if isinstance(x, dict):
        return {k: local(v, mesh) for k, v in x.items()}
    n = mesh.size(0)
    b = x.shape[0] // n
    d = axis_index(mesh, DATA_AXIS)
    return x[d * b:(d + 1) * b]


def build(inputs, mesh):
    model = Composition(inputs["specs"], mesh=mesh)
    model.load_state_dict(convert.shard_state(
        inputs["state"], mesh.size(1), axis_index(mesh, MODEL_AXIS)))
    return model


def step(model, mesh, inputs, out, tag):
    """One train step on the global batch: the mean loss, every gradient
    after the data all-reduce and every parameter after the update, the
    row shards gathered over "model" and cut to their rows."""
    trainer = Trainer(model, Adam(model.parameters(), lr=LEARNING_RATE),
                      mesh=mesh, device="cpu")
    batch = shard_batch(local(inputs["batch"], mesh), mesh)
    labels = shard_batch(local(inputs["labels"], mesh), mesh)
    out[f"{tag}/loss"] = trainer.train_step(batch, labels)
    rows = inputs["state"]["embeddings.table"].shape[0]
    for name, p in model.named_parameters():
        grad, value = p.grad.detach(), p.detach()
        if name == "embeddings.table":
            grad = all_gather(grad, mesh, MODEL_AXIS)[:rows]
            value = all_gather(value, mesh, MODEL_AXIS)[:rows]
        out[f"{tag}/grad/{name}"] = grad.clone()
        out[f"{tag}/param/{name}"] = value.clone()


def main():
    port, port2, rank, in_dir, out_dir = sys.argv[1:]
    rank = int(rank)
    inputs = torch.load(os.path.join(in_dir, "inputs.pt"),
                        weights_only=False)
    out = {}
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
    mesh = create_mesh(MeshConfig(data=2, model=1), device="cpu")
    model = build(inputs, mesh)
    trainer = Trainer(model, Adam(model.parameters(), lr=LEARNING_RATE),
                      eval_spec=eval_spec(model), mesh=mesh, device="cpu")
    batch = local(inputs["batch"], mesh)
    labels = local(inputs["labels"], mesh)
    half = labels.shape[0] // 2  # two eval batches: two updates to merge
    out["eval"] = trainer.evaluate(lambda: [
        ({k: v[:half] for k, v in batch.items()}, labels[:half]),
        ({k: v[half:] for k, v in batch.items()}, labels[half:])])
    step(build(inputs, mesh), mesh, inputs, out, "2x1")
    dist.destroy_process_group()

    initialize_distributed(f"127.0.0.1:{port2}", 2, rank, device="cpu")
    mesh = create_mesh(MeshConfig(data=1, model=2), device="cpu")
    step(build(inputs, mesh), mesh, inputs, out, "1x2")
    dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
