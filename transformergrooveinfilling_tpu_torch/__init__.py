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
                / ``encoder_layer_reference``; ``decoder_layer_train`` /
                ``decoder_layer_reference``; ``ffn_train`` /
                ``ffn_reference``; ``dropout_add_layernorm`` /
                ``dropout_add_layernorm_reference``; ``band_energies`` /
                ``band_energies_plain``; ``synth_events`` /
                ``synth_events_plain``), the MSO DSP, the on-device drum
                synthesizer, dropout, and the kernel build
- ``hvo``       HVO grid operations on tensors, the drum-voice mapping
- ``audio``     the procedural drum kit and the host (numpy) mixer
- ``data``      random masking and the synth + MSO front end as a training
                augmentation on the device
- ``models``    the groove transformer (``nn.Module``), encoder-only and
                encoder-decoder, with its training mode (fused layers, fused
                FFN, fused dropout+LayerNorm, remat), the loss, legacy
                ``.Model`` / flax-parameter interop
- ``utils``     experiment logging (wandb's call surface over a local run
                directory), the flax msgpack codec, the configs' YAML reader
- ``train``     the training contract (``initialize_model`` + ``train_loop``),
                the production loop ``run_training``, checkpoints in the JAX
                package's format, step and epoch functions, hyperparameters
- ``serve``     bucketed inference server, dynamic batching, HTTP endpoint

Not ported yet (see ROADMAP.md): the training CLI (``train.py``) and the
datasets, evaluation, SoundFont (``.sf2``) kits, the C++ mixer, multi-GPU,
export. Every function of the JAX
package that reaches a Pallas kernel has its CUDA counterpart here.
Every entry point runs on ``"cuda"`` unless the caller names another device,
and raises without CUDA (:func:`require_device`); none carries on on the CPU.
Importing this package has no side effects: no backend is selected and no
kernel is built until a CUDA tensor first reaches a kernel wrapper.
"""

__version__ = "0.1.0"


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that this port does not carry yet."""


def require_device(device, who: str):
    """``torch.device(device)``; a CUDA device without CUDA raises (``who``
    names the caller in the message). The port never falls back to the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device={str(device)!r}): CUDA is not available "
            "(the port does not fall back to the CPU; pass device=\"cpu\" "
            "to run there)")
    return device
