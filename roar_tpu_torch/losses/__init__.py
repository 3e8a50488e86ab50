"""Losses (ports of roar_tpu/losses)."""
