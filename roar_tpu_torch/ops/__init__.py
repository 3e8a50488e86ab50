"""Tensor ops (ports of roar_tpu/ops)."""
