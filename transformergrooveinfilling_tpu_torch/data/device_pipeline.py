"""Augmentation inside the training epoch, on the device, as the JAX
package's ``data/device_pipeline.py``.

The random masking (and, for the audio modality, the synthesis + MSO front
end) runs as the ``augment`` hook of ``train/loop.py::make_epoch_fn``. The
clean base grids live on the device once; every epoch (or block) trains on a
fresh masking/render. The per-item tempos and kit rows go to the device on
the first call for a corpus size and are reused, so later calls transfer
nothing between host and device.

Semantics: one per-item removal threshold drawn from ``thres_range``, hits
removed i.i.d. below it, inputs = kept part (or its MSO), targets = removed
part.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hvo.ops import remove_random_events_batch


def random_mask_on_device(generator: torch.Generator, base: torch.Tensor,
                          thres_range=(0.4, 0.6)):
    """``(M, T, 3V)`` clean grids → (kept, removed), fresh per call, drawn
    from ``generator`` on ``base``'s device."""
    return remove_random_events_batch(base, generator, thres_range)


def make_on_device_augment(qpms=None, mode: str = "symbolic", thres_range=(0.4, 0.6),
                           soundfonts=None, mso_params=None, chunk: int | None = None,
                           seed: int = 0):
    """Build a ``(generator, base_in, base_out) -> (inputs, outputs)`` hook.

    ``mode="symbolic"``: inputs are the kept grids. ``mode="audio"``: the
    kept grids render through the on-device synthesizer and the MSO DSP
    (``ops/device_synth.py``, ``ops/mso.py``) in ``chunk``-item slices, on the
    grids' device (the CUDA kernels on the card). The chunk (default
    ``ops.device_synth.DEFAULT_CHUNK``) only bounds memory (waveforms and
    frames, 2.4 MB per item at 120 bpm), so the base count need not be a
    multiple of it. Per-item kits are assigned once
    (seeded) and stay fixed across epochs; the masking is what regenerates.
    Only the procedural kit is ported. Pass the epoch fn the clean grids as
    both inputs and outputs.
    """
    if mode not in ("symbolic", "audio"):
        raise ValueError(f"unknown augment mode {mode!r}; expected 'symbolic' or 'audio'")
    if mode == "symbolic":
        def augment(generator, base_in, base_out):
            del base_out  # both args are the same clean grids
            return random_mask_on_device(generator, base_in, thres_range)

        return augment

    from ..ops.device_synth import DEFAULT_CHUNK, _front_end, pack_tables
    from ..ops.mso import MSOParams, mso_waveform_length

    chunk = chunk or DEFAULT_CHUNK
    params = mso_params or MSOParams()
    sfs = list(soundfonts) if soundfonts else [None]
    qpms = np.asarray(qpms if qpms is not None else [120.0], np.float64)

    prepared: dict = {}  # (items, steps, device) -> what every epoch's call reuses

    def prepare(m: int, t: int, dev):
        table, base_map, luts, sf_index, lengths = pack_tables(sfs, params.sr, device=dev)
        # a leading-window slice of the corpus augments with its own items' tempos
        q = np.broadcast_to(qpms, (m,)) if qpms.size == 1 else np.asarray(qpms)[:m]
        if q.shape[0] != m:
            raise ValueError(f"{m} items but only {qpms.size} per-item tempos")
        sps = torch.from_numpy(((q / 60.0) * 4.0).astype(np.float32)).to(dev)
        length = mso_waveform_length(t, float((q.min() / 60.0) * 4.0), params)
        item_sf = np.random.default_rng(seed).integers(0, len(sfs), m)
        sf_rows = torch.tensor([base_map[sfs[i]] for i in item_sf], dtype=torch.int32, device=dev)
        sf_ks = torch.tensor([sf_index[sfs[i]] for i in item_sf], dtype=torch.int32, device=dev)
        return sps, table, sf_rows, length, luts, sf_ks, lengths

    def augment(generator, base_in, base_out):
        del base_out
        m, t = base_in.shape[0], base_in.shape[1]
        key = (m, t, base_in.device)
        if key not in prepared:
            prepared[key] = prepare(*key)
        sps, table, sf_rows, length, luts, sf_ks, lengths = prepared[key]

        kept, removed = random_mask_on_device(generator, base_in, thres_range)
        mso = [_front_end(kept[s:s + chunk], sps[s:s + chunk], table, sf_rows[s:s + chunk],
                          length, t, params, luts, sf_ks[s:s + chunk], lengths)
               for s in range(0, m, chunk)]
        return torch.cat(mso), removed

    return augment
