"""The benchmark harness of clearsky_tpu_torch (see ../README.md)."""
