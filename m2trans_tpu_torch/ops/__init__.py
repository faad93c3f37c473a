"""Plain PyTorch ops of the port (NHWC), one module per JAX twin in
m2trans_tpu/ops/."""
