"""Vision Transformer classifier over ``(B, H, W, C)`` images.

The port of ``bluefog_tpu/models/vit.py``, built from the port's
``transformer.Block`` with bidirectional attention
(``TransformerConfig(causal=False)``): a patchify conv with a bias, a
learned [CLS] token (zeros at init) and position embeddings (N(0, 0.02^2)),
the blocks, an ``RMSNorm``, and a float32 head on the [CLS] row.  With
``attn_impl=flash_attention_impl()`` ViT-S/16 at 224x224 runs K1-K3
non-causal at S=197, D=64.  ``remat`` and ``remat_policy`` recompute each
block's activations in the backward, as the LM's (``transformer.run_block``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.models.layers import Conv, flax_init_, nhwc_to_nchw
from bluefog_tpu_torch.models.transformer import (Block, RMSNorm,
                                                  TransformerConfig,
                                                  block_policy,
                                                  local_attention, run_block)

__all__ = ["ViT"]


class ViT(nn.Module):
    def __init__(self, num_classes: int = 1000, image_size: int = 224,
                 patch_size: int = 16, embed_dim: int = 384,
                 num_layers: int = 12, num_heads: int = 6, mlp_ratio: int = 4,
                 dtype=torch.bfloat16, attn_impl: Optional[Callable] = None,
                 in_channels: int = 3, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        self.patch_size, self.embed_dim, self.dtype = patch_size, embed_dim, dtype
        self.num_layers = num_layers
        tokens = (image_size // patch_size) ** 2 + 1
        self.cfg = TransformerConfig(
            vocab_size=1, num_layers=num_layers, num_heads=num_heads,
            embed_dim=embed_dim, mlp_ratio=mlp_ratio, max_seq_len=tokens,
            dtype=dtype, remat=remat, remat_policy=remat_policy, causal=False)
        self.patch_embed = Conv(in_channels, embed_dim,
                                (patch_size, patch_size), patch_size,
                                dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, embed_dim))
        attn = attn_impl or local_attention
        for i in range(num_layers):
            setattr(self, f"block_{i}", Block(self.cfg, attn))
        self.RMSNorm_0 = RMSNorm(embed_dim, dtype)
        self.head = nn.Linear(embed_dim, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers from ``generator``: ``layers.flax_init_`` on
        the patch conv and the Dense layers, norm scales 1, [CLS] zeros,
        positions N(0, 0.02^2)."""
        flax_init_(self, generator)
        for mod in self.modules():
            if isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, images):
        p = self.patch_size
        if images.shape[1] % p or images.shape[2] % p:
            raise ValueError(f"image {images.shape[1]}x{images.shape[2]} not "
                             f"divisible by patch size {p}")
        x = self.patch_embed(nhwc_to_nchw(images))        # (B, d, h, w)
        B = x.shape[0]
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.embed_dim)
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for i in range(self.num_layers):
            x = run_block(getattr(self, f"block_{i}"),
                          block_policy(self.cfg, i), x)
        x = self.RMSNorm_0(x)
        return F.linear(x[:, 0].float(), self.head.weight, self.head.bias)
