"""Remat inside a batched sweep, on the CPU: ``make_batched_sweep_fn`` with
``remat`` on (each layer through ``models/transformer.py::_LayerRemat`` under
``torch.func.vmap(grad_and_value(...))``) against the same group without
remat, bit for bit, under every ``remat_policy`` and kernel switch in both
families; each layer's forward run twice a step; a recompute without the
generator's replay caught; ``"dots"`` keeping the dense products; the group
against the JAX package's batched sweep over ``nn.remat`` layers; the policy
errors; and that the changed modules import no JAX. Sizes: d 32, 4 heads,
ff 64, 2 layers (2 + 1 for the encoder-decoder), K 3, rate 0.3."""

import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vmap_sweep import SGD_BAR, grids, key_bias_rows, leaves
from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.train import vmap_sweep as jax_sweep
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig, build_model
from transformergrooveinfilling_tpu_torch.models import transformer
from transformergrooveinfilling_tpu_torch.train import vmap_sweep
from transformergrooveinfilling_tpu_torch.utils.param_layout import (
    stacked_flax_params_from_state_dict, stacked_state_dict_from_flax_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3
RATE = 0.3
ARCH = dict(d_model=32, n_heads=4, dim_feedforward=64, num_encoder_layers=2,
            embedding_size_src=27)
FAMILIES = {"encoder_only": 0, "encoder_decoder": 1}
SWITCHES = {"unfused": {}, "fused_ffn": dict(fused_ffn=True),
            "fused_dropout_ln": dict(fused_dropout_ln=True),
            "both": dict(fused_ffn=True, fused_dropout_ln=True),
            "fused_layers": dict(fused_layer=True, fused_decoder_layer=True)}
POLICIES = [None, "nothing", "dots"]
LRS, PENALTIES, RATES = [0.1, 0.2, 0.3], [0.5, 0.5, 1.0], [0.3, 0.2, 0.1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def config(family: str, switches: str = "unfused", **kw) -> GrooveTransformerConfig:
    n_dec = FAMILIES[family]
    sw = dict(SWITCHES[switches])
    if not n_dec:
        sw.pop("fused_decoder_layer", None)
    return GrooveTransformerConfig(**ARCH, num_decoder_layers=n_dec, dropout=RATE, **sw, **kw)


def group(cfg, rates_as_data: bool = False, epochs: int = 1):
    """A K-trial group at ``cfg``, 8 samples in batches of 4, from fixed
    initial weights and generator → (stacked parameters, last-batch losses,
    the generator's state after the sweep)."""
    model = build_model(cfg, "cpu")
    init = vmap_sweep.init_stacked_params(model, cfg, K, torch.Generator().manual_seed(0), "cpu")
    x, y = (torch.from_numpy(a) for a in grids(0, 8))
    fn = vmap_sweep.make_batched_sweep_fn(model, 4, 8, epochs, encoder_only=cfg.encoder_only,
                                          config=cfg, rates_as_data=rates_as_data)
    gen = torch.Generator().manual_seed(1)
    params, losses = fn(init, (), torch.tensor(LRS), torch.tensor(PENALTIES),
                        torch.tensor(RATES), x, y, gen)
    return params, losses, gen.get_state()


def assert_same_group(want, got):
    params, losses, state = want
    assert torch.equal(losses, got[1])
    assert torch.equal(state, got[2])  # the generator ends where it would have
    assert params.keys() == got[0].keys()
    for name in params:
        assert torch.equal(params[name], got[0][name]), name


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("switches", list(SWITCHES))
@pytest.mark.parametrize("family", FAMILIES)
def test_remat_group_equals_the_group_without_remat(family, switches, policy):
    """Two SGD steps of a group at rate 0.3 with remat on: stacked parameters,
    losses and the generator's final state bit for bit those of the group
    without remat. A replay that drew other masks, or a kept product that
    differentiated otherwise, would move them without any error."""
    cfg = config(family, switches)
    assert_same_group(group(cfg), group(dataclasses.replace(cfg, remat=True,
                                                            remat_policy=policy)))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", FAMILIES)
def test_remat_group_with_per_trial_rates(family, policy):
    """Rates that differ ride the vmap as data and into the recompute as one
    of its tensors: still bit for bit the group without remat."""
    cfg = config(family)
    assert_same_group(group(cfg, rates_as_data=True),
                      group(dataclasses.replace(cfg, remat=True, remat_policy=policy),
                            rates_as_data=True))


def layer_runs(cfg) -> int:
    """How often the layers' forwards ran in one step of a group at ``cfg``."""
    runs = []
    real = {cls: cls.forward for cls in (transformer.EncoderLayer, transformer.DecoderLayer)}
    with contextlib.ExitStack() as stack:
        for cls, fwd in real.items():
            def counted(self, *a, _fwd=fwd, **kw):
                runs.append(type(self))
                return _fwd(self, *a, **kw)
            cls.forward = counted
            stack.callback(setattr, cls, "forward", fwd)
        group(cfg)
    return len(runs)


@pytest.mark.parametrize("family", FAMILIES)
def test_each_layer_runs_twice_a_step_under_remat(family):
    """Without remat each layer's forward runs once a step (2 steps here),
    with it twice: the forward, then the replay in the backward."""
    cfg = config(family)
    n_layers = ARCH["num_encoder_layers"] + FAMILIES[family]
    assert layer_runs(cfg) == 2 * n_layers
    for policy in POLICIES:
        assert layer_runs(dataclasses.replace(cfg, remat=True,
                                              remat_policy=policy)) == 2 * 2 * n_layers


def test_a_recompute_without_the_replay_would_differ(monkeypatch):
    """The equality above can fail: a recompute that leaves the generator
    where the forward put it draws other masks, and the group's parameters
    move without any error."""
    cfg = config("encoder_only")
    plain = group(cfg)
    monkeypatch.setattr(transformer, "_replaying",
                        lambda generator, state: contextlib.nullcontext())
    naive = group(dataclasses.replace(cfg, remat=True))
    assert any(not torch.equal(plain[0][k], naive[0][k]) for k in plain[0])


class _Products:
    """Counts the dense products (``F.linear`` in the model module) and the
    attention's batched products (``torch.matmul``) a group runs."""

    def __init__(self, monkeypatch):
        self.dense = self.attention = 0
        real_linear, real_matmul = transformer.F.linear, torch.matmul

        def linear(*a, **kw):
            self.dense += 1
            return real_linear(*a, **kw)

        def matmul(*a, **kw):
            self.attention += 1
            return real_matmul(*a, **kw)

        monkeypatch.setattr(transformer.F, "linear", linear)
        monkeypatch.setattr(torch, "matmul", matmul)


@pytest.mark.parametrize("family", FAMILIES)
def test_dots_keeps_the_dense_products(monkeypatch, family):
    """A vmapped step under ``"dots"`` runs fewer products than under
    ``None`` and more than without remat: its dense products run once, their
    outputs kept for the replay, and the attention's batched products run
    again in the replay, as under ``None``."""
    counts = {}
    for name, kw in (("off", {}), ("all", dict(remat=True)),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        with monkeypatch.context() as m:
            products = _Products(m)
            group(config(family, **kw))
        counts[name] = (products.dense, products.attention)
    (dense_off, att_off), (dense_all, att_all), (dense_dots, att_dots) = (
        counts["off"], counts["all"], counts["dots"])
    assert 0 < dense_dots == dense_off < dense_all, counts
    assert att_dots == att_all == 2 * att_off > 0, counts
    assert sum(counts["off"]) < sum(counts["dots"]) < sum(counts["all"]), counts


STEP_BYTES = """
import sys
import torch
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig, build_model
from transformergrooveinfilling_tpu_torch.train import vmap_sweep
torch.set_num_threads(1)
cfg = GrooveTransformerConfig(d_model=128, n_heads=4, dim_feedforward=512, dropout=0.1,
                              num_encoder_layers=8, embedding_size_src=16,
                              remat=sys.argv[1] != "off",
                              remat_policy=None if sys.argv[1] == "off" else sys.argv[1])
k, b = 2, 32
model = build_model(cfg, "cpu")
init = {n: p.detach().expand(k, *p.shape).clone() for n, p in model.named_parameters()}
x, y = torch.randn(b, 32, 16), torch.rand(b, 32, 27)
fn = vmap_sweep.make_batched_sweep_fn(model, b, b, 1, config=cfg, rates_as_data=False)

def kib(key):
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) for line in f if line.startswith(key))

before = kib("VmRSS")
fn(init, (), torch.full((k,), 0.01), torch.full((k,), 0.5), torch.full((k,), 0.1), x, y,
   torch.Generator().manual_seed(0))
print(kib("VmHWM") - before)
"""


def step_kib(way: str) -> int:
    """The resident KiB one step of a K 2 group adds at its peak (d 128, ff
    512, 8 layers, batch 32), in a process of its own."""
    proc = subprocess.run([sys.executable, "-c", STEP_BYTES, way], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return int(proc.stdout.split()[-1])


def test_remat_keeps_less_than_the_group_without_it():
    """The point of remat: a step's peak resident bytes under remat are less
    than half the step's without it (each layer's replay is freed as its
    backward consumes it, not held to the end of the step), and under
    ``"dots"`` still below them (600 / 191 / 232 MiB on the CPU when written)."""
    off, remat, dots = (step_kib(way) for way in ("off", "nothing", "dots"))
    assert remat < off / 2 and remat < dots < off, (off, remat, dots)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("family", FAMILIES)
def test_remat_group_matches_jax(family, optimizer, policy):
    """JAX's ``init_stacked_params`` carried into the port, then 3 epochs of
    both packages' ``make_batched_sweep_fn`` at rate 0 over models built with
    remat on and the same policy (JAX: ``nn.remat`` layers): final parameters
    and last-batch losses within 5e-5, Adam's key-bias entries held to a step
    bound as ``test_torch_vmap_sweep.py::test_sweep_matches_jax`` holds them."""
    n_dec = FAMILIES[family]
    arch = dict(ARCH, num_decoder_layers=n_dec, dropout=0.0, remat=True, remat_policy=policy)
    jax_cfg, cfg = JaxConfig(**arch), GrooveTransformerConfig(**arch)
    model = jax_build_model(jax_cfg)
    stacked = jax.tree.map(np.asarray, jax_sweep.init_stacked_params(
        model, jax_cfg, K, jax.random.PRNGKey(0)))
    x, y = grids(0, 8)
    lrs = np.asarray([0.0, 0.05, 0.1] if optimizer == "sgd" else [0.0, 1e-3, 3e-3], np.float32)
    pens = np.asarray([0.5, 0.3, 1.0], np.float32)
    rates = np.zeros(K, np.float32)
    fn = jax_sweep.make_batched_sweep_fn(model, 8, 8, 3, encoder_only=not n_dec,
                                         config=jax_cfg, rates_as_data=False,
                                         optimizer=optimizer)
    j_params, j_losses = fn(stacked, jax_sweep.init_stacked_opt(stacked, optimizer),
                            jnp.asarray(lrs), jnp.asarray(pens), jnp.asarray(rates),
                            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))

    init = stacked_state_dict_from_flax_params(stacked, cfg)
    port = build_model(cfg, "cpu")
    p_fn = vmap_sweep.make_batched_sweep_fn(port, 8, 8, 3, encoder_only=not n_dec,
                                            config=cfg, rates_as_data=False,
                                            optimizer=optimizer)
    p_params, p_losses = p_fn(init, vmap_sweep.init_stacked_opt(init, optimizer),
                              torch.from_numpy(lrs), torch.from_numpy(pens),
                              torch.from_numpy(rates), torch.from_numpy(x),
                              torch.from_numpy(y), torch.Generator().manual_seed(1))

    np.testing.assert_allclose(p_losses.numpy(), np.asarray(j_losses), atol=SGD_BAR, rtol=0)
    got = leaves(stacked_flax_params_from_state_dict(p_params, cfg))
    want, first = leaves(jax.tree.map(np.asarray, j_params)), leaves(stacked)
    assert got.keys() == want.keys()
    for path, a in got.items():
        b, a0 = want[path], first[path]
        rows = key_bias_rows(path, cfg.d_model) if optimizer == "adam" else None
        if rows is None:
            np.testing.assert_allclose(a, b, atol=SGD_BAR, rtol=0, err_msg=str(path))
        else:
            rest = np.ones(a.shape[-1], bool)
            rest[rows] = False
            np.testing.assert_allclose(a[..., rest], b[..., rest], atol=SGD_BAR, rtol=0)
            for moved in (a, b):
                bound = 3 * lrs[:, None] * 1.001 + 1e-7
                assert (np.abs(moved[..., rows] - a0[..., rows]) <= bound).all(), path
        np.testing.assert_array_equal(a[0], a0[0], err_msg=f"lr 0 trial moved: {path}")


@pytest.mark.parametrize("family", FAMILIES)
def test_unknown_remat_policy_raises_in_a_batched_group(family):
    """An unknown ``remat_policy`` raises ``ValueError`` naming it, as JAX's
    ``_remat_wrap`` does; without remat the policy is not read."""
    cfg = config(family, remat=True, remat_policy="everything")
    x, y = grids(0, 4)
    with pytest.raises(ValueError, match="everything"):
        vmap_sweep.batched_sweep(build_model(cfg, "cpu"), cfg, x, y, LRS, PENALTIES,
                                 epochs=1, batch_size=4, device="cpu")
    off = dataclasses.replace(cfg, remat=False)
    _params, losses = vmap_sweep.batched_sweep(build_model(off, "cpu"), off, x, y, LRS,
                                               PENALTIES, epochs=1, batch_size=4, device="cpu")
    assert torch.isfinite(losses).all()


def test_changed_modules_import_no_jax():
    code = (
        "import sys\n"
        "import transformergrooveinfilling_tpu_torch.models.transformer\n"
        "import transformergrooveinfilling_tpu_torch.train.vmap_sweep\n"
        "import transformergrooveinfilling_tpu_torch.sweep\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'transformergrooveinfilling_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
