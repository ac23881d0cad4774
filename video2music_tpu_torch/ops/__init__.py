"""Operators of the port: norms, positions (sinusoidal, learned, RoPE),
the RPR bias, KANLinear, attention, MoE, dropout, losses, and the
kernel wrappers (flash_attention, flash_attention_dropout, decode_layer,
decode_batch, decode_variant, decode_batch_variant, scan)."""
