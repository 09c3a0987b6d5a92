"""Models of the port."""

from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM,
                                                  local_attention)

__all__ = ["TransformerConfig", "TransformerLM", "local_attention"]
