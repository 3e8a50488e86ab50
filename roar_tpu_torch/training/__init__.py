"""Checkpoint handling (ports of roar_tpu/training)."""
