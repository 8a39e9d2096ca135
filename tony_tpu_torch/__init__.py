"""tony_tpu_torch: the PyTorch/CUDA port of tony_tpu for NVIDIA Hopper.

A package of its own beside ``tony_tpu`` (the JAX reference, which stays as
it is): it imports ``torch`` and numpy, never ``jax`` and nothing of
``tony_tpu``. Module paths mirror the reference's. It serves Llama-family
models through the continuous-batching paged-KV engine
(``serve/engine.py``), whose decode attention is a hand-written CUDA kernel
(``csrc/paged_decode_attention.cu``), and trains them with ``train.fit``
through hand-written CUDA flash-attention forward and backward kernels
(``csrc/flash_attention.cu``), on one device or over a dp x fsdp mesh of
torch.distributed ranks (``parallel/``), the fsdp weight gathers streamed
through the ring's chunk-matmul kernel (``csrc/overlap.cu``). Entry points
run on CUDA unless the caller asks for the CPU.
"""
