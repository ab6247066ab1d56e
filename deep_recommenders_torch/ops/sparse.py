"""Sparse adjacency: a COO matrix and its product with a dense matrix.

Counterpart of ``deep_recommenders_tpu/ops/sparse.py``: a square matrix of
``num_nodes`` rows held as three tensors of ``nnz`` entries (rows, cols,
vals; rows sorted ascending), and ``A @ x`` as a gather of x's rows scaled
by ``vals`` and their sum into each row (JAX's ``segment_sum``), here one
``index_add_``. On the card ``index_add_`` adds with atomics, so a row's
terms are summed in an order that varies from run to run: the product is
not bit-reproducible there, and its checks hold it within a tolerance
(each row's sum of at most a node's degree of terms in fp32). The dense
adjacency is the form for small graphs; this one keeps O(nnz) memory where
the dense form takes O(N^2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SparseAdjacency:
    """Static-shape COO sparse matrix (square, num_nodes x num_nodes), rows
    sorted ascending (``from_scipy`` and ``from_dense`` give them so)."""

    rows: torch.Tensor  # (nnz,) int64
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (nnz,) float32
    num_nodes: int

    @classmethod
    def from_scipy(cls, sp) -> "SparseAdjacency":
        coo = sp.tocsr().tocoo()  # the CSR round trip sorts and dedups
        return cls(
            rows=torch.as_tensor(coo.row, dtype=torch.int64),
            cols=torch.as_tensor(coo.col, dtype=torch.int64),
            vals=torch.as_tensor(coo.data, dtype=torch.float32),
            num_nodes=int(sp.shape[0]),
        )

    @classmethod
    def from_dense(cls, dense) -> "SparseAdjacency":
        d = dense.cpu().numpy() if isinstance(dense, torch.Tensor) \
            else np.asarray(dense)
        rows, cols = np.nonzero(d)
        return cls(
            rows=torch.as_tensor(rows, dtype=torch.int64),
            cols=torch.as_tensor(cols, dtype=torch.int64),
            vals=torch.as_tensor(d[rows, cols], dtype=torch.float32),
            num_nodes=int(d.shape[0]),
        )

    def to(self, device) -> "SparseAdjacency":
        """The same matrix with its tensors on ``device``."""
        return dataclasses.replace(self, rows=self.rows.to(device),
                                   cols=self.cols.to(device),
                                   vals=self.vals.to(device))

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x for x of shape (num_nodes, F) -> (num_nodes, F)."""
        gathered = x[self.cols] * self.vals[:, None].to(x.dtype)
        out = x.new_zeros((self.num_nodes,) + tuple(x.shape[1:]))
        return out.index_add(0, self.rows, gathered)

    def todense(self) -> torch.Tensor:
        out = self.vals.new_zeros((self.num_nodes, self.num_nodes))
        return out.index_put((self.rows, self.cols), self.vals,
                             accumulate=True)
