"""PyTorch + CUDA port of the groove-infilling framework, for NVIDIA Hopper.

The JAX package ``transformergrooveinfilling_tpu`` beside this one is the
reference: the port mirrors its layout and names, and the ``tests/test_torch_*``
files hold each ported module against its JAX counterpart on shared weights and
inputs. The port imports ``torch``, ``numpy`` and the standard library only —
never ``jax`` or the JAX package.

Layering (bottom → top), as far as it is ported:

- ``csrc``      hand-written CUDA C++ kernels for ``sm_90a`` (the Pallas
                kernels' counterparts), built with ``nvcc`` at first use
- ``ops``       kernel wrappers, each beside its plain PyTorch version
                (``fused_mha`` / ``mha_reference``; ``encoder_layer_train``
                / ``encoder_layer_reference``), dropout, and the kernel build
- ``models``    the encoder-only groove transformer (``nn.Module``) with its
                training mode, the loss, legacy ``.Model`` / flax-parameter
                interop
- ``train``     the training contract (``initialize_model`` + ``train_loop``),
                step and epoch functions, hyperparameters
- ``serve``     bucketed inference server, dynamic batching, HTTP endpoint

Not ported yet (see ROADMAP.md): the training CLI (``train.py``,
``run_training``), checkpoints, evaluation and logging, the audio front end,
the encoder-decoder family, the fused FFN and fused LayerNorm kernels,
multi-GPU, export.
Importing this package has no side effects: no backend is selected and no
kernel is built until a CUDA tensor first reaches a kernel wrapper.
"""

__version__ = "0.1.0"


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that this port does not carry yet."""
