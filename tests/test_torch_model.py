"""Port's model against the JAX model on shared weights and on the in-repo
demo checkpoint. The JAX side runs its Pallas attention in interpret mode
(``use_pallas_attention=True`` on the CPU); the port's
``use_fused_attention=True`` takes the kernel's plain version on CPU tensors."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models import predict as jax_predict
from transformergrooveinfilling_tpu.models import torch_compat as jax_torch_compat
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
    sinusoidal_positional_encoding as jax_pe,
)
from transformergrooveinfilling_tpu_torch.models import (
    GrooveTransformerConfig, build_model, predict, sinusoidal_positional_encoding,
)
from transformergrooveinfilling_tpu_torch.models.torch_compat import (
    STORED_PE_KEY, find_latest_checkpoint, load_legacy_checkpoint,
    state_dict_from_flax_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_DIR = os.path.join(REPO, "demo")
DEMO_MODEL = os.path.join(DEMO_DIR, "transformer_run_demo_Epoch_799.Model")
ARCH = dict(d_model=32, n_heads=4, dim_feedforward=512, num_encoder_layers=6,
            embedding_size_src=27)
FLAGSHIP = dict(d_model=256, n_heads=2, dim_feedforward=512,
                num_encoder_layers=6, embedding_size_src=16)


def configs(**kw):
    """The same architecture as a JAX config and as the port's config."""
    jax_cfg = JaxConfig(dropout=0.0, use_pallas_attention=True, **kw)
    port_cfg = GrooveTransformerConfig(dropout=0.0, use_fused_attention=True, **kw)
    return jax_cfg, port_cfg


def jax_params(cfg, seed=0):
    """Flax init, then every leaf (zero biases and unit LN scales included)
    perturbed, so a mis-mapped bias or LN parameter cannot hide."""
    params = jax_build_model(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg.max_len, cfg.embedding_size_src)),
        deterministic=True)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def port_model(port_cfg, state_dict):
    model = build_model(port_cfg, "cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


def forward_both(jax_cfg, port_cfg, params, x):
    want = jax_build_model(jax_cfg).apply({"params": params}, jnp.asarray(x),
                                          deterministic=True)
    model = port_model(port_cfg, state_dict_from_flax_params(params, port_cfg))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("d_model, ff", [(32, 64), (64, 128)])
def test_forward_matches_jax(rng, d_model, ff):
    jax_cfg, port_cfg = configs(d_model=d_model, n_heads=4, dim_feedforward=ff,
                                num_encoder_layers=2, embedding_size_src=16)
    x = rng.standard_normal((3, 32, 16)).astype(np.float32)
    want, got = forward_both(jax_cfg, port_cfg, jax_params(jax_cfg), x)
    for name, w, g in zip(("h_logits", "v", "o"), want, got):
        assert g.shape == w.shape == (3, 32, 9), name
        # f32 forward bar of the JAX package's own serving tests
        np.testing.assert_allclose(g, w, atol=3e-5, err_msg=name)


def test_flagship_width_forward_matches_jax(rng):
    jax_cfg, port_cfg = configs(**FLAGSHIP)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    want, got = forward_both(jax_cfg, port_cfg, jax_params(jax_cfg, seed=1), x)
    for name, w, g in zip(("h_logits", "v", "o"), want, got):
        # 6 layers at d 256 / hd 128: longer f32 sums than the small configs
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("thres", [0.5, 0.3])
def test_predict_matches_jax(rng, thres):
    jax_cfg, port_cfg = configs(d_model=32, n_heads=4, dim_feedforward=64,
                                num_encoder_layers=2, embedding_size_src=16)
    params = jax_params(jax_cfg, seed=2)
    x = rng.standard_normal((4, 32, 16)).astype(np.float32)
    want = jax_predict(jax_build_model(jax_cfg), params, jnp.asarray(x), thres=thres)
    model = port_model(port_cfg, state_dict_from_flax_params(params, port_cfg))
    got = predict(model, torch.from_numpy(x), thres=thres)
    logits = np.asarray(jax_build_model(jax_cfg).apply(
        {"params": params}, jnp.asarray(x), deterministic=True)[0])
    sure = np.abs(1 / (1 + np.exp(-logits)) - thres) > 1e-4
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(got[0].numpy()[sure], np.asarray(want[0])[sure])
    assert set(np.unique(got[0].numpy())) <= {0.0, 1.0}
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5)


def test_demo_checkpoint_matches_jax(rng):
    jax_cfg, port_cfg = configs(**ARCH)
    params, ep, loss = jax_torch_compat.load_legacy_checkpoint(DEMO_MODEL, jax_cfg)
    sd, port_ep, port_loss = load_legacy_checkpoint(DEMO_MODEL, port_cfg)
    assert (port_ep, port_loss) == (ep, loss) == (799, pytest.approx(0.2347737))
    assert STORED_PE_KEY not in sd and len(sd) == 78
    x = (rng.random((3, 32, 27)) < 0.3).astype(np.float32)
    want = jax_build_model(jax_cfg).apply({"params": params}, jnp.asarray(x),
                                          deterministic=True)
    with torch.inference_mode():
        got = port_model(port_cfg, sd)(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5)


def test_flax_params_round_trip_through_the_legacy_key_map():
    """state_dict_from_flax_params inverts the JAX package's
    state_dict_to_params exactly (transposes and [q; k; v] order)."""
    _, port_cfg = configs(**ARCH)
    raw = torch.load(DEMO_MODEL, map_location="cpu", weights_only=True)
    ref_sd = {k: v.numpy() for k, v in raw["model_state_dict"].items()
              if k != STORED_PE_KEY}
    params = jax_torch_compat.state_dict_to_params(ref_sd, JaxConfig(**ARCH))
    sd = state_dict_from_flax_params(params, port_cfg)
    assert sd.keys() == ref_sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref_sd[k], err_msg=k)


def test_positional_encoding_matches_jax_and_the_stored_buffer():
    pe = sinusoidal_positional_encoding(32, 32)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(jax_pe(32, 32)))
    stored = torch.load(DEMO_MODEL, map_location="cpu",
                        weights_only=True)["model_state_dict"][STORED_PE_KEY]
    # the stored buffer was computed in f32 (sin/cos of f32 angles up to 31
    # rad): a few f32 ulps of the angle away from the f64-exact values
    np.testing.assert_allclose(pe.numpy(), stored.numpy(), atol=5e-5)
    odd = sinusoidal_positional_encoding(32, 7)  # odd width: cos half is shorter
    np.testing.assert_array_equal(odd.numpy(), np.asarray(jax_pe(32, 7)))
    model = build_model(GrooveTransformerConfig(), "cpu")
    assert "pe" not in "".join(model.state_dict())  # non-persistent buffer


def test_find_latest_checkpoint(tmp_path):
    for ep in (3, 12, 7):
        (tmp_path / f"transformer_run_abc_Epoch_{ep}.Model").write_bytes(b"")
    (tmp_path / "transformer_run_abc_Epoch_99.ckpt").write_bytes(b"")
    path, ep = find_latest_checkpoint(str(tmp_path))
    assert ep == 12 and path.endswith("Epoch_12.Model")
    assert find_latest_checkpoint(DEMO_DIR)[1] == 799
    with pytest.raises(FileNotFoundError):
        find_latest_checkpoint(str(tmp_path), "nothing_{}_{}.Model")


def test_training_switches_are_accepted_and_change_nothing(rng):
    base = GrooveTransformerConfig(num_encoder_layers=2)
    model = build_model(base, "cpu", torch.Generator().manual_seed(0))
    switched = dataclasses.replace(
        base, fused_layer=True, fused_ffn=True, fused_dropout_ln=True,
        fast_dropout=False, remat=True, remat_policy="dots", dropout=0.3)
    other = build_model(switched, "cpu")
    other.load_state_dict(model.state_dict(), strict=True)
    x = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(np.float32))
    with torch.inference_mode():
        for a, b in zip(model(x), other(x)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_compute_matches_jax_bf16(rng):
    """compute_dtype=bfloat16 rounds at the JAX model's sites: bf16
    projections, f32 LayerNorms and output head."""
    jax_cfg, port_cfg = configs(d_model=32, n_heads=4, dim_feedforward=64,
                                num_encoder_layers=2, embedding_size_src=16)
    jax_cfg = dataclasses.replace(jax_cfg, compute_dtype=jnp.bfloat16)
    port_cfg = dataclasses.replace(port_cfg, compute_dtype=torch.bfloat16)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    want, got = forward_both(jax_cfg, port_cfg, jax_params(jax_cfg, seed=3), x)
    for name, w, g in zip(("h_logits", "v", "o"), want, got):
        assert g.dtype == np.float32, name  # heads run in f32
        # two 2-layer bf16 stacks (8-bit mantissas) whose products may round
        # in another order: a few bf16 ulps of the O(1) activations
        np.testing.assert_allclose(g, w, atol=5e-2, err_msg=name)
