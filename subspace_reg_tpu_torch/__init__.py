"""subspace_reg_tpu_torch — the PyTorch/CUDA port of ``subspace_reg_tpu``.

The JAX package beside it is the reference each module is held against.
This package imports torch and numpy, never JAX or the JAX package.  Its
entry points run on ``cuda`` unless the caller passes ``device="cpu"``; the
one TPU kernel on the incremental-evaluation path (the fused head fine-tune
loop) is a hand-written CUDA kernel in ``csrc/``, built at first use, with a
plain torch twin that serves CPU tensors.
"""
