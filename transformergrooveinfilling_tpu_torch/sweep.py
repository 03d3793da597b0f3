"""Hyperparameter sweeps on the port, as the repository's root ``sweep.py`` is
for the JAX package::

    python -m transformergrooveinfilling_tpu_torch.sweep \\
        --sweep configs/InfillingRandom_sweep.yaml --count 8 [--batched] [--device cpu]

The flags are root ``sweep.py``'s, plus ``--device`` (default ``cuda``; ``cpu``
to run there). The sweep YAML (the wandb random-search schema of
``configs/*_sweep*.yaml``) and ``--paths`` are read by ``utils/yaml_subset.py``:
the machine with the card has no pyyaml. ``--count`` configurations are drawn
up front, in root's order and with root's draws for the same ``--seed``.

Without ``--batched`` each trial runs the port's training command line
(``train/__main__.py::main``) in this process, with ``--device`` passed on, and
the sweep metric is read back from ``runs/<project>/*/metrics.jsonl``. A
trial that raises is reported (``trial failed: <type>: <message>``) and left
out of the ranking.

With ``--batched`` the trials are grouped by every sampled parameter except
the per-trial ones (learning rate, hit-loss penalty, dropout), and each group
trains as one vmapped program (``train/vmap_sweep.py``) and is ranked by its
deterministic full-train-set loss, one vmapped eval forward through kernel #1
on the card. In a group the whole-layer kernels' auto resolves off, as in
root; a kernel switch given as 1 trains the group through its kernel, one
launch per trial (``fused_layer``, ``fused_decoder_layer``, ``fused_ffn``,
``fused_dropout_ln``). ``remat`` follows root's rule: given as 1 it is on,
and unset it is on where the auto-remat estimate over the group's K stacked
trials (``resolve_remat(..., n_replicas=K)``) says so; either way the group
trains as its one vmapped program, each layer recomputed in the backward
(``models/transformer.py::_LayerRemat``).

A group too small to gain from vmap trains its trials one at a time through
the regular step instead (:func:`train_unbatched`: the ``train`` command
line's switches, remat as one trial's estimate resolves it, so #2's chain runs
on the card), ranked on the same full-train-set loss: a group of one trial,
which is what every draw of the repository's ``configs/*_sweep*.yaml`` gives
(they sample the architecture), and a group below :data:`VMAP_MIN_TRIALS`
where the regular step runs the whole-layer kernels. As in root, a sweep
whose metric is not a minimised ``loss``, and groups with an optimizer other
than sgd or adam, run sequentially, with a note.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import random
import sys

from .utils import yaml_subset


def sample_param(spec, rng: random.Random):
    if "value" in spec:
        return spec["value"]
    if "values" in spec:
        return rng.choice(spec["values"])
    dist = spec.get("distribution")
    if dist == "uniform":
        return rng.uniform(spec["min"], spec["max"])
    if dist == "int_uniform":
        return rng.randint(spec["min"], spec["max"])
    if dist == "log_uniform":
        return math.exp(rng.uniform(spec["min"], spec["max"]))
    raise ValueError(f"unsupported distribution spec: {spec}")


def sample_config(sweep: dict, rng: random.Random) -> dict:
    return {name: sample_param(spec, rng) for name, spec in sweep["parameters"].items()}


def read_final_metric(project: str, metric: str):
    """Latest run's last logged value of ``metric`` from the local JSONL sink."""
    run_dirs = sorted(glob.glob(os.path.join("runs", project, "*")))
    if not run_dirs:
        return None
    path = os.path.join(run_dirs[-1], "metrics.jsonl")
    value = None
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if metric in rec:
                    value = rec[metric]
    return value


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m transformergrooveinfilling_tpu_torch.sweep")
    parser.add_argument("--sweep", required=True, help="sweep yaml")
    parser.add_argument("--count", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--paths", default="configs/paths.yaml")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override epochs per trial (quick sweeps)")
    parser.add_argument("--batched", action="store_true",
                        help="vmap-batched trials: trials are grouped by architecture "
                             "(every sampled parameter except learning_rate/"
                             "hit_loss_penalty/dropout) and each group runs as ONE "
                             "vmapped program (sgd and adam)")
    parser.add_argument("--device", default="cuda",
                        help="where to train ('cuda' or 'cpu'); without CUDA 'cuda' raises")
    args = parser.parse_args(argv)

    sweep = yaml_subset.load_file(args.sweep)
    metric = sweep.get("metric", {}).get("name", "loss")
    goal = sweep.get("metric", {}).get("goal", "minimize")
    project = sweep.get("project", "sweep")
    rng = random.Random(args.seed)

    # one up-front sample so both modes see the identical search draw
    trials = []
    for _ in range(args.count):
        hp = sample_config(sweep, rng)
        if args.epochs is not None:
            hp["epochs"] = args.epochs
        trials.append(hp)

    if args.batched:
        return run_batched(trials, metric, goal, project, args)
    return run_sequential(trials, metric, goal, project, args)


def run_trial_sequential(hp: dict, project: str, metric: str, args):
    """One trial through the port's training command line → metric value or None."""
    from .train.__main__ import main as train_main

    hp = dict(hp)
    # only_final_eval is a driver flag, not a model hyperparameter
    only_final = bool(hp.pop("only_final_eval", 1))
    # a validation-referencing sweep metric needs the validation evaluator
    # loaded, or the trial can never log it and would always score None
    needs_val = "validation" in metric
    cli = ["--paths", args.paths, "--wandb", "False",
           "--eval_train", "False",
           "--eval_validation", "True" if needs_val else "False",
           "--dump_eval", "False",
           "--only_final_eval", "True" if only_final else "False",
           "--device", args.device]
    for key, val in hp.items():
        cli += [f"--{key}", str(val)]
    try:
        train_main(cli)
        return read_final_metric(project, metric)
    except Exception as e:
        print(f"    trial failed: {type(e).__name__}: {e}")
        return None


def run_sequential(trials, metric: str, goal: str, project: str, args) -> int:
    results = []
    for i, hp in enumerate(trials):
        print(f"--- trial {i}: {hp}")
        value = run_trial_sequential(hp, project, metric, args)
        results.append((value, hp))
        print(f"    {metric} = {value}")

    scored = [(v, hp) for v, hp in results if v is not None]
    if scored:
        best = (min if goal == "minimize" else max)(scored, key=lambda r: r[0])
        print(f"\nbest {metric} = {best[0]}\nbest config: "
              f"{json.dumps(best[1], indent=2, default=str)}")
        return 0
    print("no successful trials")
    return 1


# parameters that ride the batched vmap as per-trial data rather than forcing
# separate programs (dropout as the 8-bit mask threshold, ops/dropout.py: the
# sweep YAMLs sample it continuously, which would otherwise make every trial a
# singleton group)
_PER_TRIAL_KEYS = ("learning_rate", "hit_loss_penalty", "dropout")


def group_trials(trials) -> dict:
    """``{architecture: [trial indices]}``: trials grouped by every sampled
    parameter except :data:`_PER_TRIAL_KEYS`, in draw order."""
    groups: dict = {}
    for i, cfg in enumerate(trials):
        key = tuple(sorted((k, v) for k, v in cfg.items() if k not in _PER_TRIAL_KEYS))
        groups.setdefault(key, []).append(i)
    return groups


def batched_config(hp, trial: dict, device, n_trials: int = 1):
    """The model config of a batched group of ``n_trials`` trials, as root
    ``sweep.py`` builds it: ``derive_model_config`` with the whole-layer
    kernels' auto resolved off (a switch the trial gives as 1 is kept),
    ``fused_ffn`` as resolved, ``fused_dropout_ln`` as the trial gives it, and
    an unset ``remat`` resolved by the auto-remat estimate over the
    ``n_trials`` stacked trials of parameters, optimizer state and batch that
    share the one device. Every switch runs under ``torch.func.vmap``
    (``train/vmap_sweep.py``), the kernels one launch per trial; auto keeps
    the whole-layer chains off because a vmapped step of plain ops costs about
    the same at every K and the chain's K launches grow with it
    (``batches``)."""
    from .train.config import derive_model_config, resolve_remat

    config = derive_model_config(hp, device=device)
    remat = resolve_remat(
        hp.remat, d_model=hp.d_model, n_heads=hp.n_heads, dim_feedforward=hp.dim_feedforward,
        n_layers=hp.num_encoder_decoder_layers, n_decoder_layers=config.num_decoder_layers,
        optimizer=hp.optimizer_algorithm, batch_size=hp.batch_size, n_data_shards=1,
        n_replicas=n_trials, compute_dtype=config.compute_dtype, device=device)
    return dataclasses.replace(
        config, fused_layer=hp.fused_layer is not None and config.fused_layer,
        fused_decoder_layer=hp.fused_decoder_layer is not None and config.fused_decoder_layer,
        fused_dropout_ln=bool(trial.get("fused_dropout_ln", False)), remat=remat)


# the fewest trials a group trains as one vmapped program where the regular
# step runs the whole-layer kernels: a vmapped step of plain ops costs about
# the same at every K, 4-5 steps of #2's chain (flagship width, batch 32;
# NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 25, PERF.md section 6)
VMAP_MIN_TRIALS = 5


def batches(config, n_trials: int) -> bool:
    """Whether ``n_trials`` trials of a group whose regular step runs at
    ``config`` (``derive_model_config``'s) train as one vmapped program."""
    chain = config.fused_layer or config.fused_decoder_layer
    return n_trials >= (VMAP_MIN_TRIALS if chain else 2)


def train_unbatched(trial: dict, x, y, seed: int, device) -> float:
    """One trial of a batched sweep through the regular step
    (``train/loop.py::make_epoch_fn`` at ``derive_model_config``'s switches,
    remat included), initialised from ``seed`` as a vmapped trial is →
    its deterministic full-set eval loss, the number the groups rank on."""
    import torch

    from .train.config import HyperParams, derive_model_config
    from .train.loop import create_train_state, make_epoch_fn, make_eval_loss_fn

    hp = HyperParams.from_dict(trial)
    config = derive_model_config(hp, device=device)
    state = create_train_state(config, hp.optimizer_algorithm, hp.learning_rate, seed=seed,
                               device=device)
    epoch = make_epoch_fn(hp.hit_loss_penalty, hp.batch_size, x.shape[0], n_epochs=hp.epochs,
                          encoder_only=config.encoder_only)
    epoch(state, x, y, torch.Generator(device).manual_seed(seed + 1))
    eval_loss = make_eval_loss_fn(hp.hit_loss_penalty, config.encoder_only)
    return float(eval_loss(state.model, x, y)["loss"])


def run_batched(trials, metric: str, goal: str, project: str, args) -> int:
    """vmap-batched trials, grouped by architecture (module docstring); sweeps
    batched mode cannot rank (a non-loss metric or a maximize goal) and groups
    it cannot train (an optimizer other than sgd or adam) run sequentially,
    with a note; groups too small for vmap train one trial at a time through
    :func:`train_unbatched`."""
    import torch

    from .data import load_processed_dataset
    from .models import build_model
    from .train.config import HyperParams, derive_model_config, load_paths
    from .train.vmap_sweep import batched_sweep, stacked_eval_loss, trial_seeds

    if goal != "minimize" or metric != "loss":
        # batched mode ranks on the deterministic full-TRAIN-set loss; any
        # other metric (validation_loss included) needs the full driver
        print(f"note: --batched ranks on eval loss (minimize); this sweep's "
              f"metric {metric!r} (goal {goal}) needs the full driver — "
              "falling back to sequential trials")
        return run_sequential(trials, metric, goal, project, args)

    trials = [{k: v for k, v in t.items() if k != "only_final_eval"} for t in trials]
    groups = group_trials(trials)

    paths = load_paths(args.paths)
    data_cache: dict = {}
    losses_by_trial = [None] * len(trials)
    fallback_trials: list = []

    def sequential(idxs):
        for i in idxs:
            losses_by_trial[i] = run_trial_sequential(trials[i], project, metric, args)
        fallback_trials.extend(idxs)

    print(f"batched sweep: {len(trials)} trials in {len(groups)} "
          f"architecture group(s), one vmapped program per group")
    for gi, (key, idxs) in enumerate(groups.items()):
        base = {k: v for k, v in trials[idxs[0]].items() if k not in _PER_TRIAL_KEYS}
        hp = HyperParams.from_dict(base)
        if hp.optimizer_algorithm not in ("sgd", "adam"):
            # an optimizer the vmapped step has no data-lr update rule for: run
            # these trials through the sequential driver instead (the logged
            # final loss is the same quantity this mode ranks on)
            print(f"--- group {gi}: optimizer {hp.optimizer_algorithm!r} can't batch; "
                  f"running its {len(idxs)} trial(s) sequentially")
            sequential(idxs)
            continue
        config = batched_config(hp, base, args.device, len(idxs))
        # the regular step's switches: a group too small for vmap takes them
        regular = derive_model_config(hp, device=args.device)
        model = build_model(config, args.device)
        if hp.experiment not in data_cache:
            ds = load_processed_dataset(paths[hp.experiment]["datasets"]["train"],
                                        exp=hp.experiment)
            data_cache[hp.experiment] = tuple(
                torch.as_tensor(a, dtype=torch.float32, device=args.device)
                for a in (ds.processed_inputs, ds.processed_outputs))
        x, y = data_cache[hp.experiment]
        print(f"--- group {gi}: {len(idxs)} trial(s) of "
              f"d{hp.d_model}/ff{hp.dim_feedforward}/"
              f"{hp.num_encoder_decoder_layers}L bs{hp.batch_size} "
              f"x {hp.epochs} epochs")
        if not batches(regular, len(idxs)):
            print(f"    {len(idxs)} trial(s) one at a time through the regular step "
                  + ("(one trial needs no vmap)" if len(idxs) == 1 else
                     f"(below {VMAP_MIN_TRIALS} trials a vmapped step loses to "
                     "the whole-layer kernels' chain)"))
            seeds = trial_seeds(torch.Generator().manual_seed(args.seed + gi), len(idxs))
            for i, s in zip(idxs, seeds):
                try:
                    losses_by_trial[i] = train_unbatched(trials[i], x, y, s, args.device)
                except Exception as e:
                    print(f"    trial failed: {type(e).__name__}: {e}")
            continue
        if config.remat:
            print(f"    one vmapped program under remat (policy {config.remat_policy}; "
                  + ("given" if hp.remat else f"auto, {len(idxs)} stacked trials") + ")")
        lrs = [float(trials[i].get("learning_rate", 0.05)) for i in idxs]
        pens = [float(trials[i].get("hit_loss_penalty", 1.0)) for i in idxs]
        rates = [float(trials[i].get("dropout", hp.dropout)) for i in idxs]
        params, _last_batch_losses = batched_sweep(
            model, config, x, y, lrs, pens, rates=rates, epochs=hp.epochs,
            batch_size=hp.batch_size, seed=args.seed + gi,
            optimizer=hp.optimizer_algorithm, device=args.device)
        # rank on the deterministic full-dataset loss, not the last
        # training batch (the sequential runner's logged-loss semantics)
        losses = stacked_eval_loss(model, params, x, y, pens,
                                   encoder_only=config.encoder_only, device=args.device)
        for i, loss in zip(idxs, losses.tolist()):
            losses_by_trial[i] = loss

    scored = [i for i, v in enumerate(losses_by_trial) if v is not None]
    if not scored:
        print("no successful trials")
        return 1
    if 0 < len(fallback_trials) < len(scored):
        print("note: ranking mixes the batched groups' deterministic "
              "full-dataset eval loss with the sequential fallbacks' "
              "last-logged training loss — compare across the two kinds "
              "with care")
    order = sorted(scored, key=lambda i: losses_by_trial[i])
    for i in order[:5]:
        cfg = trials[i]
        print(f"  loss {losses_by_trial[i]:.4f}  "
              f"lr {cfg.get('learning_rate', 0.05):.4f}  "
              f"hit_loss_penalty {cfg.get('hit_loss_penalty', 1.0):.3f}  "
              f"d{cfg.get('d_model')}/ff{cfg.get('dim_feedforward')}/"
              f"{cfg.get('num_encoder_decoder_layers')}L")
    print("note: raw loss is not comparable across hit_loss_penalty values "
          "(the penalty scales the loss); prefer a fixed penalty or rank by "
          "a penalty-independent metric")
    return 0


if __name__ == "__main__":
    sys.exit(main())
