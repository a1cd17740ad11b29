"""TSUE on PyTorch and CUDA: the port of ``tsue_tpu`` to an NVIDIA H100.

The layout mirrors ``tsue_tpu/``: ``config`` and ``data`` (the port's own
copies of the framework-neutral layer, held equal to the originals by
``tests/test_torch_data.py``), ``ops`` (attention, int8 decode weights, the
int8 KV cache, the fused LM head + top-k and the sampler, each kernel
hand-written for Hopper with its source in ``csrc/``), ``models``,
``eval`` (metrics and generation), ``train``, ``serve`` and ``convert``
(the weight bridge from the JAX package).  This package imports torch and
nothing of JAX or of the JAX package.
"""
