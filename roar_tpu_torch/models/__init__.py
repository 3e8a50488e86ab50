"""Neural modules (ports of roar_tpu/models), inference only."""
