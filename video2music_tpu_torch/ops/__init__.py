"""Operators of the port: norms, RoPE, attention, MoE, and the kernel
wrappers (flash_attention, decode_layer, scan)."""
