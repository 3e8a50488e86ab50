"""Host-side text processing (copies of roar_tpu/data modules the port needs)."""
