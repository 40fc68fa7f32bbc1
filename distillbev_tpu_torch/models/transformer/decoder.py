"""DETR-style box-refining decoder.

Counterpart of ``distillbev_tpu/models/transformer/decoder.py``:
``inverse_sigmoid`` (eps 1e-5), ``DetrDecoderLayer`` (self-attention ->
LN -> deformable cross-attention -> LN -> FFN -> LN) and
``DetectionTransformerDecoder`` with iterative refinement of the
reference points in inverse-sigmoid space, the refined points detached.

The refinement's regression branches belong to the decoder
(``reg_branches.{i}``): in the JAX package they are parameters of their
own under ``transformer/decoder``, apart from the head's branches of the
same shape, and the port keeps that.  The head installs them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..builder import TRANSFORMERS
from .attention import FFN, CustomMSDeformableAttention, MultiheadAttention


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


class DetrDecoderLayer(nn.Module):
    """``attentions.0`` (self) -> ``norms.0`` -> ``attentions.1`` (cross)
    -> ``norms.1`` -> ``ffns.0`` -> ``norms.2``."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 512, num_points: int = 4,
                 dropout: float = 0.1):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(embed_dims, num_heads, dropout),
            CustomMSDeformableAttention(embed_dims, num_heads, num_levels=1,
                                        num_points=num_points,
                                        dropout=dropout)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels,
                                       dropout)])
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dims, eps=1e-5)
                                    for _ in range(3)])

    def forward(self, query, value, query_pos, reference_points,
                spatial_shapes, generator=None):
        query = self.attentions[0](query, query_pos=query_pos,
                                   key_pos=query_pos, generator=generator)
        query = self.norms[0](query)
        query = self.attentions[1](query, value, reference_points,
                                   spatial_shapes, query_pos=query_pos,
                                   generator=generator)
        query = self.norms[1](query)
        query = self.ffns[0](query, generator=generator)
        return self.norms[2](query)


@TRANSFORMERS.register_module()
class DetectionTransformerDecoder(nn.Module):

    def __init__(self, num_layers: int = 6, embed_dims: int = 256,
                 num_heads: int = 8, feedforward_channels: int = 512,
                 num_points: int = 4, dropout: float = 0.1,
                 return_intermediate: bool = True):
        super().__init__()
        self.return_intermediate = return_intermediate
        self.layers = nn.ModuleList([
            DetrDecoderLayer(embed_dims, num_heads, feedforward_channels,
                             num_points, dropout)
            for _ in range(num_layers)])
        self.reg_branches: Optional[nn.ModuleList] = None

    def forward(self, query, value, query_pos, reference_points,
                spatial_shapes, generator=None):
        """query ``[B, Q, C]``; value ``[B, H*W, C]`` (BEV memory);
        reference_points ``[B, Q, 2 or 3]`` (sigmoid space) ->
        (inter_states ``[L, B, Q, C]``, inter_refs ``[L, B, Q, 2 or 3]``).
        """
        intermediate, inter_refs = [], []
        for i, layer in enumerate(self.layers):
            query = layer(query, value, query_pos, reference_points[..., :2],
                          spatial_shapes, generator=generator)
            if self.reg_branches is not None:
                delta = self.reg_branches[i](query)
                new_ref = torch.sigmoid(
                    delta[..., :2] + inverse_sigmoid(reference_points[..., :2]))
                if reference_points.shape[-1] == 3:
                    new_z = torch.sigmoid(delta[..., 4:5] + inverse_sigmoid(
                        reference_points[..., 2:3]))
                    new_ref = torch.cat([new_ref, new_z], -1)
                reference_points = new_ref.detach()
            intermediate.append(query)
            inter_refs.append(reference_points)
        if self.return_intermediate:
            return torch.stack(intermediate), torch.stack(inter_refs)
        return query[None], reference_points[None]
