"""Parallelism of the port: the switch-routed mixture of experts
(``moe``) and sequence parallelism, ring attention (``ring_attention``) and
Ulysses all-to-all attention (``ulysses``)."""
