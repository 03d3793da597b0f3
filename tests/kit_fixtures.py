"""SoundFont fixtures for the port's tests: the generator-model cases of
``tests/test_native_audio.py`` as ``write_minimal_sf2`` arguments, and the
three kits ``chip_smoke.py`` phase 23 renders (its ``write_kits``). Torch and
numpy only: ``tests/test_torch_cuda.py`` uses it on the card."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cents, write_kits as three_kits  # noqa: E402,F401

from transformergrooveinfilling_tpu_torch.hvo.mapping import (  # noqa: E402
    VOICE_TO_MIDI_NOTE as KEYS,
)

SR = 44100


def tone(freq, dur, amp=0.8, sr=SR):
    t = np.arange(int(dur * sr)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def generator_fixtures() -> dict:
    """name → ``write_minimal_sf2`` keyword arguments: one kit per generator
    case of ``tests/test_native_audio.py``."""
    soft, hard = tone(200.0, 0.05), tone(900.0, 0.05)
    t300 = tone(300.0, 0.05)
    hi6k = tone(6000.0, 0.30, amp=0.5)
    return {
        "velocity_split": {"samples": {KEYS[0]: [
            {"sample": soft, "vel_lo": 0, "vel_hi": 63},
            {"sample": hard, "vel_lo": 64, "vel_hi": 127}]}},
        "attenuation": {"samples": {KEYS[0]: [{"sample": t300}],
                                    KEYS[1]: [{"sample": t300, "atten_cb": 200}]}},
        "stacked_zones": {"samples": {KEYS[2]: [{"sample": tone(200.0, 0.05, 0.4)},
                                                {"sample": tone(800.0, 0.03, 0.4)}]}},
        "loop": {"samples": {KEYS[8]: [{"sample": tone(441.0, 0.02), "loop": (100, 782),
                                        "release_tc": 0}]}},
        "volume_envelope": {"samples": {KEYS[0]: [
            {"sample": np.full(int(0.5 * SR), 0.8, np.float32), "decay_tc": 0,
             "sustain_cb": 200, "attack_tc": -3000, "hold_tc": -4000}]}},
        "preset_key_ranges": {"instruments": [
            {"samples": {KEYS[0]: tone(100.0, 0.05), KEYS[1]: tone(100.0, 0.05)},
             "key_lo": KEYS[0], "key_hi": KEYS[0]},
            {"samples": {KEYS[0]: tone(800.0, 0.05), KEYS[1]: tone(800.0, 0.05)},
             "key_lo": KEYS[1], "key_hi": KEYS[1]}]},
        "preset_vel_ranges": {"instruments": [
            {"samples": {KEYS[0]: t300}, "vel_lo": 64, "vel_hi": 127}]},
        "lowpass": {"samples": {KEYS[0]: [{"sample": tone(6000.0, 0.06, 0.5),
                                           "filter_fc": cents(800.0)}],
                                KEYS[1]: [{"sample": tone(200.0, 0.06, 0.5),
                                           "filter_fc": cents(800.0)}],
                                KEYS[2]: [{"sample": tone(6000.0, 0.06, 0.5)}]}},
        "filter_bypass": {"samples": {
            KEYS[0]: [{"sample": tone(500.0, 0.05), "filter_fc": 13500, "filter_q_cb": 0}],
            KEYS[1]: [{"sample": tone(500.0, 0.05)}]}},
        "filter_resonance": {"samples": {
            KEYS[0]: [{"sample": tone(1000.0, 0.12, 0.3), "filter_fc": cents(1000.0),
                       "filter_q_cb": 200}],
            KEYS[1]: [{"sample": tone(1000.0, 0.12, 0.3), "filter_fc": cents(1000.0)}]}},
        "pan": {"samples": {KEYS[0]: [{"sample": tone(400.0, 0.05, 0.4)}],
                            KEYS[1]: [{"sample": tone(400.0, 0.05, 0.4), "pan": 500}],
                            KEYS[2]: [{"sample": tone(400.0, 0.05, 0.4), "pan": -500},
                                      {"sample": tone(400.0, 0.05, 0.4), "pan": 500}]}},
        "preset_relative_attenuation": {"instruments": [
            {"samples": {KEYS[0]: [{"sample": tone(300.0, 0.05, 0.5), "atten_cb": 100}]},
             "key_lo": KEYS[0], "key_hi": KEYS[0], "atten_cb": 100},
            {"samples": {KEYS[1]: tone(300.0, 0.05, 0.5)}, "key_lo": KEYS[1],
             "key_hi": KEYS[1]}]},
        "preset_relative_filter": {"instruments": [
            {"samples": {KEYS[0]: tone(6000.0, 0.06, 0.5)}, "key_lo": KEYS[0],
             "key_hi": KEYS[0], "filter_fc": -5000},
            {"samples": {KEYS[1]: tone(6000.0, 0.06, 0.5)}, "key_lo": KEYS[1],
             "key_hi": KEYS[1]}]},
        "mod_envelope_constant": {"samples": {
            KEYS[0]: [{"sample": tone(3000.0, 0.06, 0.5), "filter_fc": cents(1000.0),
                       "mod_env_to_filter_fc": 1200}],
            KEYS[1]: [{"sample": tone(3000.0, 0.06, 0.5), "filter_fc": cents(1000.0) + 1200}]}},
        "vibrato": {"samples": {KEYS[0]: [{"sample": tone(500.0, 0.25, 0.4),
                                           "vib_lfo_to_pitch": 1200,
                                           "freq_viblfo": cents(1.0)}],
                                KEYS[1]: [{"sample": tone(500.0, 0.25, 0.4)}]}},
        "mod_lfo_pitch": {"samples": {KEYS[3]: [{"sample": tone(700.0, 0.2, 0.4),
                                                 "mod_lfo_to_pitch": -600,
                                                 "freq_modlfo": cents(4.0),
                                                 "delay_modlfo_tc": -4000}]}},
        # the two swept filters: a time-varying cutoff, block by block
        "mod_envelope_sweep": {"samples": {
            KEYS[0]: [{"sample": hi6k, "filter_fc": cents(500.0), "mod_env_to_filter_fc": 4800,
                       "decay_modenv_tc": -2400, "sustain_modenv": 1000}],
            KEYS[1]: [{"sample": hi6k}]}},
        "mod_lfo_filter_sweep": {"samples": {
            KEYS[0]: [{"sample": tone(6000.0, 0.30, 0.4), "filter_fc": cents(500.0),
                       "mod_lfo_to_filter_fc": 4800, "freq_modlfo": cents(1.0)}]}},
    }


SWEPT = ("mod_envelope_sweep", "mod_lfo_filter_sweep")


def tremolo_fixture(depth: int) -> dict:
    """The tremolo case at modLfoToVolume ``depth`` cB (10 Hz LFO)."""
    t = tone(2000.0, 0.30, 0.4)
    return {"samples": {KEYS[0]: [{"sample": t, "mod_lfo_to_volume": depth,
                                   "freq_modlfo": cents(10.0)}],
                        KEYS[1]: [{"sample": t}]}}
