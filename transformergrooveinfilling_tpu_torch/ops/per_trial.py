"""What the training kernels' operators share: a vmap rule that launches once
per trial, the checks on their arguments and outputs, and the test that
picks them over the eager Functions.

Under a ``torch.func`` transform (:func:`transformed`), kernels #2-#5
(``ops/fused_layer.py``, ``ops/fused_decoder_layer.py``, ``ops/fused_ffn.py``,
``ops/fused_ln.py``) each reach the card through two
``torch.library.custom_op`` operators, a forward and a backward, bound for
autograd by a ``torch.autograd.Function`` with ``setup_context`` and
``generate_vmap_rule``: ``torch.func.grad`` asks an autograd rule for
``setup_context``, which the ``torch.autograd.Function`` that
``custom_op.register_autograd`` generates does not define, so ``grad`` refuses
it. Under ``torch.func.vmap(grad_and_value(...))`` the Function's forward and
backward then run at the vmap level, and each operator's vmap rule
(:func:`rule`) receives the trials' stacked tensors.

The rule launches the unbatched operator once per trial on that trial's
slices (its x, weights, vectors and seed) and stacks the results: trial t's
outputs are those of an unbatched call with trial t's arguments, bit for bit.
K trials cost K launches of each kernel a call; one launch over K weight sets
(a grouped product) is the faster design this leaves open.
"""

from __future__ import annotations

import torch


def rule(op):
    """A ``register_vmap`` rule for ``op``: each batched tensor argument's
    trial axis moved to the front and made contiguous once (the kernels read
    ``data_ptr()``, and a slice of a contiguous tensor along its first axis
    is contiguous), an argument without a trial axis (``in_dim`` None: a
    non-tensor, or a tensor all trials share) passed to every call as it is,
    ``op`` called once per trial, the outputs stacked on axis 0. A trial's
    slice that does not start on 16 bytes (a seed of a ``(K, 1)`` int32
    stack) is copied: TMA and the vector loads take 16-byte aligned
    tensors."""

    def vmap_rule(info, in_dims, *args):
        args = [a if d is None else a.movedim(d, 0).contiguous() for a, d in zip(args, in_dims)]
        outs = [op(*(a if d is None else aligned(a[t]) for a, d in zip(args, in_dims)))
                for t in range(info.batch_size)]
        if isinstance(outs[0], torch.Tensor):
            return torch.stack(outs), 0
        stacked = tuple(torch.stack(o) for o in zip(*outs))
        return stacked, (0,) * len(stacked)

    return vmap_rule


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def apart(outputs, inputs):
    """``outputs`` with each one that shares storage with an input or an
    earlier output replaced by a copy: an operator's outputs may alias neither
    (``custom_op`` checks). The plain versions return views or the same tensor
    where a cast is a no-op (f32) or a rate is 0; the kernels' wrappers always
    allocate."""
    seen = {t.untyped_storage().data_ptr() for t in inputs if isinstance(t, torch.Tensor)}
    out = []
    for t in outputs:
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            t = t.clone()
            ptr = t.untyped_storage().data_ptr()
        seen.add(ptr)
        out.append(t)
    return tuple(out)


def check_devices(name: str, tensors) -> None:
    """Raise ``ValueError`` unless ``tensors`` all lie on the CPU or all on
    one CUDA device. The operators' own checks run where each launch reads
    its tensors; this one runs before them, where a tensor may be batched,
    since an operator sends a tensor on another device (``meta``) to its fake
    implementation instead of its body."""
    first = tensors[0].device
    if all(t.device.type == "cpu" for t in tensors):
        return
    if first.type != "cuda" or any(t.device != first for t in tensors):
        raise ValueError(f"{name} kernels need every tensor on one CUDA device; got "
                         f"{sorted({str(t.device) for t in tensors})}")


def transformed() -> bool:
    """Whether a ``torch.func`` transform (``vmap``, ``grad``) is active: the
    wrappers then take the Functions over the operators, and else the eager
    Functions, which launch as the unbatched path always has. A
    ``setup_context`` Function binds its arguments by ``inspect.signature`` on
    every call, and the operators' dispatch adds more: through them, the
    unbatched training step on an H100 took a median 1.17-1.23× as long
    (``scripts/compare_kernel_binding.py``, PERF.md §6)."""
    return torch._C._are_functorch_transforms_active()
