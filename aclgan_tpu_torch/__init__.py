"""PyTorch/CUDA port of `aclgan_tpu` for one NVIDIA H100.

Imports `torch`, never JAX and nothing of `aclgan_tpu`. Modules keep the JAX
package's names; tensors are NCHW inside, NHWC at the public boundary
(`ACLGAN.translate`, `ACLGAN.train_step`, `serving.Translator`). Entry points run on CUDA unless
the caller passes `device="cpu"`.
"""
