"""Operators of the port: norms, RoPE, attention, MoE, losses, and the
kernel wrappers (flash_attention, flash_attention_dropout, decode_layer,
decode_batch, decode_variant, decode_batch_variant, scan)."""
