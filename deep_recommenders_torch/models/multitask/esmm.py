"""ESMM: entire-space multi-task CTCVR model.

Counterpart of ``deep_recommenders_tpu/models/multitask/esmm.py``: a shared
input, two parallel towers giving pCVR and pCTR, and pCTCVR = pCTR * pCVR.
Returns (p_cvr, p_ctr, p_ctcvr), each (B, 1), as probabilities.

With ``specs`` the shared input is an :class:`EmbeddingCollection` over a
batch dict of categorical ids (the reference's shared input layer), so the
table gradient of a train step is kernel K1 on the card; without them the
input is a dense (B, ``input_dim``) tensor. ``mesh`` (a ("data", "model")
``DeviceMesh``, which needs ``specs``: ValueError without) row-shards the
shared table over "model" (``embedding/engine.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from deep_recommenders_torch.embedding.engine import EmbeddingCollection
from deep_recommenders_torch.features.columns import Feature
from deep_recommenders_torch.models.common import MLP, records_config


@records_config
class ESMM(nn.Module):
    """Either ``input_dim`` (the dense mode) or ``specs`` (the embedding
    front end, F features of ``embedding_dim``: tower input F * D)."""

    def __init__(
        self,
        input_dim: Optional[int] = None,
        cvr_hidden: Tuple[int, ...] = (256, 128),
        ctr_hidden: Tuple[int, ...] = (256, 128),
        specs: Optional[Sequence[Feature]] = None,
        embedding_dim: int = 16,
        mesh=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if mesh is not None and specs is None:
            raise ValueError("ESMM(mesh=...) requires specs (the shared "
                             "embedding table is what the mesh partitions)")
        if (specs is None) == (input_dim is None):
            raise ValueError("ESMM takes either input_dim (dense input) or "
                             "specs (categorical input), not both")
        self.embeddings = None
        if specs is not None:
            self.embeddings = EmbeddingCollection(specs, embedding_dim,
                                                  mesh=mesh,
                                                  generator=generator)
            input_dim = len(self.embeddings.specs) * embedding_dim
        self.cvr_tower = MLP(input_dim, cvr_hidden, output_dim=1,
                             generator=generator)
        self.ctr_tower = MLP(input_dim, ctr_hidden, output_dim=1,
                             generator=generator)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.embeddings is not None:
            stacked = self.embeddings(x)  # x is the batch dict of ids
            x = stacked.reshape(stacked.shape[0], -1)
        p_cvr = torch.sigmoid(self.cvr_tower(x))
        p_ctr = torch.sigmoid(self.ctr_tower(x))
        return p_cvr, p_ctr, p_ctr * p_cvr
