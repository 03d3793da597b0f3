"""The port's HVO grid operations against the JAX package's on the same
arrays (all selects and concatenations: exact), and the statistics of the
random masking through a ``torch.Generator``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu import hvo as jax_hvo
from transformergrooveinfilling_tpu.hvo import ops as jax_ops
from transformergrooveinfilling_tpu_torch import hvo as port_hvo
from transformergrooveinfilling_tpu_torch.hvo import ops


def grids(rng, *lead, t=32, v=9, density=0.3):
    h = (rng.random(lead + (t, v)) < density).astype(np.float32)
    return np.concatenate([h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)],
                          axis=-1).astype(np.float32)


def test_mapping_equals_jax():
    for name in ("ROLAND_REDUCED_MAPPING", "N_VOICES", "VOICE_NAMES"):
        assert getattr(port_hvo, name) == getattr(jax_hvo, name)
    for note in range(20, 70):
        assert port_hvo.midi_note_to_voice(note) == jax_hvo.midi_note_to_voice(note)
    assert port_hvo.mapping.VOICE_TO_MIDI_NOTE == jax_hvo.mapping.VOICE_TO_MIDI_NOTE


@pytest.mark.parametrize("lead", [(), (5,), (2, 3)])
def test_split_combine_active_silent_match_jax(rng, lead):
    x = grids(rng, *lead)
    x[..., 4] = 0  # one voice without hits
    if lead:
        x[0] = 0  # one silent grid
    t = torch.from_numpy(x)
    for got, want in zip(ops.split_hvo(t), jax_ops.split_hvo(jnp.asarray(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ops.combine_hvo(*ops.split_hvo(t)).numpy(), x)
    np.testing.assert_array_equal(ops.get_active_voices(t).numpy(),
                                  np.asarray(jax_ops.get_active_voices(jnp.asarray(x))))
    np.testing.assert_array_equal(ops.is_silent(t).numpy(),
                                  np.asarray(jax_ops.is_silent(jnp.asarray(x))))


@pytest.mark.parametrize("max_len", [16, 32, 40])
def test_pad_to_length_matches_jax(rng, max_len):
    x = grids(rng, 3)
    got = ops.pad_to_length(torch.from_numpy(x), max_len)
    want = jax_ops.pad_to_length(jnp.asarray(x), max_len)
    assert got.shape == (3, max_len, 27)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("voices", [[], [2], [0, 3, 8]])
def test_voice_masks_and_reset_voices_match_jax(rng, voices):
    mask = ops.voice_mask_from_indices(voices)
    want_mask = jax_ops.voice_mask_from_indices(voices)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(ops.channel_mask(mask).numpy(),
                                  np.asarray(jax_ops.channel_mask(want_mask)))
    x = grids(rng, 4)
    for got, want in zip(ops.reset_voices(torch.from_numpy(x), mask),
                         jax_ops.reset_voices(jnp.asarray(x), want_mask)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    masks = np.stack([np.roll(mask.numpy(), i) for i in range(4)])
    for got, want in zip(ops.reset_voices_batch(torch.from_numpy(x), torch.from_numpy(masks)),
                         jax_ops.reset_voices_batch(jnp.asarray(x), jnp.asarray(masks))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_voice_mask_out_of_range_raises():
    for bad in ([9], [-1], [0, 12]):
        with pytest.raises(ValueError, match="out of range"):
            ops.voice_mask_from_indices(bad)


def test_remove_events_on_jax_draws_is_exact(rng):
    """``_remove_events`` with the threshold and the uniforms that
    ``remove_random_events`` draws from its key (one split, two uniforms)
    returns exactly what the JAX function returns."""
    x = grids(rng, 6)
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    want_kept, want_removed = jax_ops.remove_random_events_batch(jnp.asarray(x), keys, (0.4, 0.6))
    thres, u = [], []
    for key in keys:
        k_thres, k_events = jax.random.split(key)
        thres.append(np.array(jax.random.uniform(k_thres, (), minval=0.4, maxval=0.6)))
        u.append(np.array(jax.random.uniform(k_events, (32, 9))))
    kept, removed = ops._remove_events(
        torch.from_numpy(x), torch.from_numpy(np.stack(thres))[:, None, None],
        torch.from_numpy(np.stack(u)))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(want_kept))
    np.testing.assert_array_equal(removed.numpy(), np.asarray(want_removed))
    # one grid, scalar threshold
    k1, r1 = ops._remove_events(torch.from_numpy(x[0]), torch.tensor(float(thres[0])),
                                torch.from_numpy(u[0]))
    np.testing.assert_array_equal(k1.numpy(), np.asarray(want_kept[0]))
    np.testing.assert_array_equal(r1.numpy(), np.asarray(want_removed[0]))


def test_remove_random_events_with_a_generator(rng):
    x = torch.from_numpy(grids(rng, 400, density=0.4))
    kept, removed = ops.remove_random_events_batch(x, torch.Generator().manual_seed(1),
                                                   (0.4, 0.6))
    assert torch.equal(kept + removed, x)  # every cell is in exactly one of the two
    hits = x[..., :9] > 0
    gone = removed[..., :9] > 0
    assert not (gone & ~hits).any() and not ((kept != 0) & (removed != 0)).any()
    # velocity and offset travel with the hit
    moved = torch.cat([gone, gone, gone], dim=-1)
    assert torch.equal(removed, torch.where(moved, x, torch.zeros(())))
    # per-item removal rate: a threshold in [0.4, 0.6] over ~115 events, so
    # 0.5 ± (0.1 + 4σ) with σ ≤ 0.5/√100; the mean over 400 items is 0.5 ± 0.02
    rate = gone.sum((1, 2)) / hits.sum((1, 2))
    assert 0.2 < float(rate.min()) and float(rate.max()) < 0.8
    assert abs(float(rate.mean()) - 0.5) < 0.02
    # thresholds differ between items: the rates spread wider than one
    # binomial at 0.5 would (σ ≈ 0.047 at 115 events)
    assert float(rate.std()) > 0.055
    # the same seed draws the same split, another seed another
    again = ops.remove_random_events_batch(x, torch.Generator().manual_seed(1), (0.4, 0.6))
    other = ops.remove_random_events_batch(x, torch.Generator().manual_seed(2), (0.4, 0.6))
    assert torch.equal(again[0], kept) and not torch.equal(other[0], kept)


def test_remove_random_events_single_grid_and_extremes(rng):
    x = torch.from_numpy(grids(rng))
    kept, removed = ops.remove_random_events(x, torch.Generator().manual_seed(0))
    assert torch.equal(kept + removed, x) and kept.shape == x.shape
    all_gone = ops.remove_random_events(x, torch.Generator().manual_seed(0), (1.0, 1.0))
    assert torch.equal(all_gone[1], x) and not all_gone[0].any()
    none_gone = ops.remove_random_events(x, torch.Generator().manual_seed(0), (0.0, 0.0))
    assert torch.equal(none_gone[0], x) and not none_gone[1].any()
