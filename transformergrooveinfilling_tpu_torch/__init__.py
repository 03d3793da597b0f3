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
- ``hvo``       HVO grid operations on tensors, the drum-voice mapping, the
                ``HVOSequence`` record
- ``audio``     the procedural drum kit, SoundFont (``.sf2``) kits, the
                host mixer (C++ built with g++ at first use, numpy where no
                g++ is found), WAV files
- ``data``      the infilling datasets and their samplers, corpus subsetting,
                the synthetic corpus, reference-era pickles, the streaming
                augmenter, random masking and the synth + MSO front end as
                a training augmentation on the device, and MIDI in and out
- ``models``    the groove transformer (``nn.Module``), encoder-only and
                encoder-decoder, with its training mode (fused layers, fused
                FFN, fused dropout+LayerNorm, remat), the loss, legacy
                ``.Model`` / flax-parameter interop
- ``utils``     experiment logging (wandb's call surface over a local run
                directory), the flax msgpack codec, the configs' YAML reader,
                pickles that cross between the packages
- ``eval``      the metric families (on the tensors' device or in numpy),
                rhythm features and their stats table, media (SVG piano
                rolls, heatmaps, tabs), the style-subset evaluators
- ``parallel``  multi-GPU and multi-process training on
                ``torch.distributed``: the ("data", "model") mesh, tensor
                parallelism split by heads, the GPipe pipeline, the process
                group from the JAX package's or torchrun's environment, the
                backend rule and the host-staged transport
- ``train``     the training contract (``initialize_model`` + ``train_loop``),
                the production loop ``run_training`` with its eval pass over
                resident eval sets, checkpoints in the JAX package's format,
                step and epoch functions (and the data-parallel step over a
                plan), hyperparameters, batched sweeps (K trials in one
                ``torch.func.vmap`` program)
- ``serve``     bucketed inference server, dynamic batching, HTTP endpoint
- ``export``    serving artifacts: ``torch.export`` programs per batch bucket
                with the attention kernel inside, parameters beside them;
                loading one needs no model code
- ``process_dataset``, ``process_evaluator``, ``train``, ``evaluate``,
                ``export``, ``sweep`` (``python -m``)  the command lines of the
                repository's root ``process_dataset.py``, ``process_evaluator.py``,
                ``train.py``, ``sweep.py`` and the JAX package's ``evaluate.py``
                and ``export.py``
- ``tutorial``  (``python -m``) the walkthrough of root ``tutorial.py``

Every module of the JAX package has its counterpart here, and every function
of it that reaches a Pallas kernel has its CUDA counterpart.
Every entry point runs on ``"cuda"`` unless the caller names another device,
and raises without CUDA (:func:`require_device`); none carries on on the CPU.
Importing this package has no side effects: no backend is selected and no
kernel is built until a CUDA tensor first reaches a kernel wrapper.
"""

__version__ = "0.1.0"


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
