"""xDeepFM: CIN layer + full model.

Counterpart of ``deep_recommenders_tpu/models/ranking/xdeepfm.py``:
logits = linear(batch) + cin_head(pooled CIN stack) + mlp(flatten(emb)).
The CIN stack runs over flattened (B * D, F) rows. Two relu layers (the
reference's default) go through the fused stack kernel K3
(``ops.cin_kernels.cin_stack_pooled``) on a bf16 row stream; every other
depth or activation runs the layered :class:`CIN` in rows mode, whose layer
is kernel K4 (``ops.cin_kernels.cin2d``). The linear terms and the
embeddings are two table passes, so a train step launches the
embedding-gradient kernel K1 twice.

With ``compute_dtype=torch.bfloat16`` the embeddings and the deep tower run
in bf16 (the embeddings' K1 on bf16 gradients); the linear terms, the
layered CIN (its rows upcast to fp32), ``cin_head``, the parameters and the
logits stay fp32. The fused stack reads bf16 rows either way.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from deep_recommenders_torch.embedding.engine import (
    EmbeddingCollection,
    LinearTerms,
)
from deep_recommenders_torch.features.columns import Feature
from deep_recommenders_torch.models.common import (
    MLP,
    lecun_normal_,
    records_config,
    resolve_activation,
)
from deep_recommenders_torch.ops.cin import cin_interaction
from deep_recommenders_torch.ops.cin_kernels import (
    cin2d,
    cin_interaction_fused,
    cin_stack_pooled,
)


def _cin_init_(w: torch.Tensor, generator: Optional[torch.Generator]):
    # flax truncated_normal(stddev=0.05): cut at +-2 sigma, not rescaled.
    return nn.init.trunc_normal_(w, 0.0, 0.05, -0.1, 0.1, generator=generator)


class CIN(nn.Module):
    """One compressed-interaction layer: (x0, x) -> (B, feature_map, D), or
    (R, feature_map) over flattened rows when x0 and x are 2-D.

    ``in_fields0`` (F0) and ``in_fields`` (F) size the (F0, F, feature_map)
    kernel: flax infers them at the first call.
    """

    def __init__(
        self,
        in_fields0: int,
        in_fields: int,
        feature_map: int = 3,
        use_bias: bool = False,
        activation: str = "sigmoid",
        fused: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.kernel = nn.Parameter(
            _cin_init_(torch.empty(in_fields0, in_fields, feature_map),
                       generator)
        )
        self.bias = (
            nn.Parameter(torch.zeros(feature_map)) if use_bias else None
        )
        self.act = resolve_activation(activation)
        self.fused = fused

    def forward(self, inputs) -> torch.Tensor:
        if not isinstance(inputs, (tuple, list)):
            raise ValueError(
                f"`CIN` inputs must be a (x0, x) tuple, got {type(inputs)}"
            )
        if len(inputs) != 2:
            raise ValueError(
                f"`CIN` inputs tuple length should be 2, got {len(inputs)}"
            )
        x0, x = inputs
        rows_mode = x0.dim() == 2 and x.dim() == 2
        if not rows_mode and (x0.dim() != 3 or x.dim() != 3):
            raise ValueError(
                f"`x0` and `x` must be 3-D, got {x0.dim()} / {x.dim()}"
            )
        if rows_mode:
            out = (
                cin2d(x0, x, self.kernel)
                if self.fused
                else torch.einsum("rf,rg,fgm->rm", x0, x, self.kernel)
            )  # (R, M)
            if self.bias is not None:
                out = out + self.bias[None, :]
        else:
            if self.fused:
                out = cin_interaction_fused(x0, x, self.kernel)  # (B, M, D)
            else:
                out = cin_interaction(x0, x, self.kernel)
            if self.bias is not None:
                out = out + self.bias[None, :, None]
        return self.act(out) if self.act is not None else out


@records_config
class XDeepFM(nn.Module):
    """Full xDeepFM: linear + CIN stack (sum-pooled) + deep MLP -> logits.

    ``mesh`` raises NotImplementedError until the port has sharding;
    ``compute_dtype`` is None (fp32) or ``torch.bfloat16``. Parameters are
    initialised from
    ``generator``: linear terms zero, table normal, CIN kernels flax's
    truncated normal (stddev 0.05), dense kernels lecun-normal.
    """

    def __init__(
        self,
        specs: Sequence[Feature],
        embedding_dim: int = 16,
        cin_feature_maps: Tuple[int, ...] = (128, 128),
        cin_activation: str = "relu",
        hidden: Tuple[int, ...] = (256, 128),
        mesh=None,
        compute_dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cin_feature_maps = tuple(cin_feature_maps)
        self.cin_activation = cin_activation
        self.linear = LinearTerms(specs)
        self.embeddings = EmbeddingCollection(
            specs, embedding_dim, compute_dtype=compute_dtype, mesh=mesh,
            generator=generator,
        )
        f0 = len(self.embeddings.specs)
        if self._use_fused_stack():
            m1, m2 = self.cin_feature_maps
            self.cin_w1 = nn.Parameter(
                _cin_init_(torch.empty(f0, f0, m1), generator))
            self.cin_w2 = nn.Parameter(
                _cin_init_(torch.empty(f0, m1, m2), generator))
        else:
            widths = (f0,) + self.cin_feature_maps
            self.cins = nn.ModuleList(
                CIN(f0, widths[i], m, activation=cin_activation,
                    generator=generator)
                for i, m in enumerate(self.cin_feature_maps)
            )
        self.deep = MLP(f0 * embedding_dim, hidden, output_dim=1,
                        generator=generator, dtype=compute_dtype)
        self.cin_head = nn.Linear(sum(self.cin_feature_maps), 1, bias=False)
        lecun_normal_(self.cin_head.weight, generator)

    def _use_fused_stack(self) -> bool:
        # The fused stack kernel covers the reference's flagship
        # configuration: exactly two CIN layers with relu activation.
        return (
            len(self.cin_feature_maps) == 2
            and self.cin_activation == "relu"
        )

    def forward(self, batch) -> torch.Tensor:
        linear_logit = self.linear(batch)
        x0 = self.embeddings(batch)  # (B, F, D)
        b, f0, d = x0.shape
        # The CIN stack over flattened (B * D, F) rows.
        x0v = x0.transpose(1, 2).reshape(b * d, f0)
        if self._use_fused_stack():
            # bf16 input stream on every device, as in the JAX model; the
            # gradient comes back bf16 and the cast's backward upcasts it.
            x0v = x0v.to(torch.bfloat16).contiguous()
            pooled = list(cin_stack_pooled(x0v, self.cin_w1, self.cin_w2, d))
        else:
            x0v = x0v.float().contiguous()
            xv, pooled = x0v, []
            for cin in self.cins:
                xv = cin((x0v, xv))  # (B * D, M)
                pooled.append(xv.reshape(b, d, -1).sum(dim=1))  # (B, M)
        cin_logit = self.cin_head(torch.cat(pooled, dim=-1))
        deep_logit = self.deep(x0.reshape(b, -1))
        return linear_logit + cin_logit + deep_logit.float()
