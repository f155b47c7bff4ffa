"""Data parallelism across processes (`aclgan_tpu/parallel`)."""
