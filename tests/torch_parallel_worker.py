"""One rank of a process group for the port's parallel tests.

Started by ``tests/torch_parallel_group.py`` once per rank, with the group
named in the environment (the JAX package's ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``, or torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``)::

    python torch_parallel_worker.py <spec.json> <out prefix>

The spec names an ``.npz`` of inputs and weights (flax parameter trees under
``<name>/<flax path>``) and a list of jobs; each rank runs every job on the
CPU through ``transformergrooveinfilling_tpu_torch.parallel`` and writes
``<out prefix>_<rank>.json`` (scalars, and whether ``jax`` was imported);
rank 0 also writes the arrays to ``<out prefix>.npz``. Imports torch, numpy
and the port only.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from transformergrooveinfilling_tpu_torch.models import build_model  # noqa: E402
from transformergrooveinfilling_tpu_torch.models.transformer import (  # noqa: E402
    GrooveTransformerConfig,
)
from transformergrooveinfilling_tpu_torch.parallel import (  # noqa: E402
    initialize_from_env, make_mesh, make_pipeline_mesh, pipeline_forward, shard_params,
)
from transformergrooveinfilling_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from transformergrooveinfilling_tpu_torch.train.loop import (  # noqa: E402
    TrainState, make_epoch_fn, make_eval_loss_fn, make_optimizer, make_train_step,
)
from transformergrooveinfilling_tpu_torch.utils.param_layout import (  # noqa: E402
    state_dict_from_flax_params,
)


def tree(data, prefix: str) -> dict:
    out: dict = {}
    for key in data.files:
        if key.startswith(prefix + "/"):
            node = out
            path = key[len(prefix) + 1:].split("/")
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = data[key]
    return out


def flat(params: dict, prefix: str) -> dict:
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def model_of(job, data):
    cfg = GrooveTransformerConfig(**job["cfg"])
    model = build_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_flax_params(tree(data, job["params"]), cfg))
    return model


def plan_of(spec: dict):
    if spec["kind"] == "mesh":
        return make_mesh(n_model=spec.get("n_model", 1), device="cpu")
    return make_pipeline_mesh(spec["n_stages"], n_data=spec.get("n_data"),
                              n_micro=spec.get("n_micro"), n_model=spec.get("n_model", 1),
                              device="cpu")


def step_of(plan, job):
    if job["plan"]["kind"] == "pipe":
        from transformergrooveinfilling_tpu_torch.parallel.pipeline import make_pipeline_step

        return make_pipeline_step(plan, job["penalty"])
    return make_train_step(job["penalty"], job.get("encoder_only", True), plan=plan)


def full_params(model, optimizer) -> dict:
    return ckpt.fetch_state_to_host(TrainState(0, model, optimizer))["params"]


def job_forward(job, data):
    model = model_of(job, data)
    plan = plan_of(job["plan"])
    x = torch.from_numpy(data[job["x"]])
    shard_params(model, plan)
    if job["plan"]["kind"] == "pipe":
        out = pipeline_forward(model, x, plan)
    else:
        with torch.no_grad():
            out = model(x)
    rows = model.Encoder["Encoder"]["layers"][0].self_attn.in_proj_weight.shape[0]
    return {"qkv_rows": rows}, {f"out{i}": o.detach().numpy() for i, o in enumerate(out)}


def job_train(job, data):
    model = model_of(job, data)
    plan = plan_of(job["plan"])
    opt = make_optimizer(job.get("optimizer", "sgd"), job["lr"], model.parameters())
    shard_params(model, plan, optimizer=opt)
    state = TrainState(0, model, opt)
    step = step_of(plan, job)
    x, y = torch.from_numpy(data[job["x"]]), torch.from_numpy(data[job["y"]])
    losses = []
    for i in range(job["steps"]):
        gen = torch.Generator().manual_seed(1000 + i)
        losses.append(float(step(state, x, y, None, gen)["loss"]))
    arrays = flat(full_params(model, opt), "params")
    return {"losses": losses}, arrays


def job_epoch(job, data):
    model = model_of(job, data)
    plan = plan_of(job["plan"])
    opt = make_optimizer("sgd", job["lr"], model.parameters())
    shard_params(model, plan, optimizer=opt)
    state = TrainState(0, model, opt)
    x, y = torch.from_numpy(data[job["x"]]), torch.from_numpy(data[job["y"]])
    step_fn = step_of(plan, job) if job["plan"]["kind"] == "pipe" else None
    epoch = make_epoch_fn(job["penalty"], job["batch"], x.shape[0], shuffle=False,
                          encoder_only=job.get("encoder_only", True), plan=plan,
                          step_fn=step_fn)
    metrics = epoch(state, x, y, torch.Generator().manual_seed(9))
    return ({k: float(v) for k, v in metrics.items()},
            flat(full_params(model, opt), "params"))


def corpus():
    from transformergrooveinfilling_tpu_torch.data.synthetic import synthetic_gmd_sequences

    hvos = np.stack([s.hvo for s in synthetic_gmd_sequences(32, seed=77)]).astype(np.float32)
    x = hvos.copy()
    x[:, :, [2, 11, 20]] = 0.0  # mask closed hats
    return x, hvos


def job_run_training(job, data):
    """The multihost worker's recipe: run_training over a plan, then the
    full-corpus eval loss of the gathered parameters on one rank."""
    import torch.distributed as dist

    from transformergrooveinfilling_tpu_torch.train.config import HyperParams
    from transformergrooveinfilling_tpu_torch.train.driver import (
        initialize_model, run_training,
    )

    x, hvos = corpus()
    hp = HyperParams.from_dict(job["hp"])
    plan = plan_of(job["plan"])
    bundle, initial_epoch = None, 0
    if job.get("resume"):
        params = {"model": {"d_model": hp.d_model, "n_heads": hp.n_heads,
                            "dim_feedforward": hp.dim_feedforward, "dropout": hp.dropout,
                            "num_encoder_layers": hp.num_encoder_decoder_layers,
                            "embedding_size_src": 27, "optimizer": hp.optimizer_algorithm,
                            "bf16": False},
                  "training": {"learning_rate": hp.learning_rate, "seed": 0,
                               "batch_size": hp.batch_size},
                  "load_model": {"location": "local", "dir": job["ckpt_dir"]}}
        bundle, _opt, initial_epoch = initialize_model(params, plan=plan)

    class DS:
        processed_inputs, processed_outputs = x, hvos

    ds, kwargs, streamer = DS(), {}, None
    if job.get("streaming"):
        from transformergrooveinfilling_tpu_torch.data.pipeline import StreamingAugmenter

        n_proc, pid = dist.get_world_size(), dist.get_rank()
        per = len(hvos) // n_proc
        streamer = StreamingAugmenter(hvos[pid * per:(pid + 1) * per], aug_per_item=2,
                                      mode="symbolic", seed=pid * (1 << 20), partial=2)
        kwargs = dict(streamer=streamer, regen_cadence="auto")
    elif job.get("fused"):
        from transformergrooveinfilling_tpu_torch.data.device_pipeline import (
            make_on_device_augment,
        )

        class FDS:
            processed_inputs = processed_outputs = hvos

        ds = FDS()
        kwargs = dict(on_device_augment=make_on_device_augment(mode="symbolic"))
    try:
        bundle = run_training(hp, ds, {}, plan=plan, bundle=bundle, initial_epoch=initial_epoch,
                              log_media=False, ckpt_dir=job["ckpt_dir"], seed=0,
                              only_final_eval=True, device="cpu",
                              epoch_block=job.get("epoch_block", 1), **kwargs)
    except NotImplementedError as e:
        if not job.get("expect_error"):
            raise
        return {"error": [type(e).__name__, str(e)]}, {}
    finally:
        if streamer is not None:
            streamer.close()
    params = full_params(bundle.model, bundle.state.optimizer)
    cfg = bundle.config
    plain = build_model(cfg, "cpu")
    plain.load_state_dict(state_dict_from_flax_params(params, cfg))
    loss = make_eval_loss_fn(hp.hit_loss_penalty)(plain, torch.from_numpy(x),
                                                  torch.from_numpy(hvos))["loss"]
    return {"loss": float(loss), "initial_epoch": initial_epoch,
            "fused_layer": bool(cfg.fused_layer), "param_tree": sorted(params)}, {}


def job_helpers(job, data):
    from transformergrooveinfilling_tpu_torch.parallel.multihost import (
        context, global_mesh, is_main_process, local_batch_slice,
    )

    from transformergrooveinfilling_tpu_torch.parallel.mesh import data_sharding

    plan = global_mesh(n_model=job.get("n_model", 1), device="cpu")
    sl = local_batch_slice(32)
    rows = plan.local_rows(10)
    return {"n_data": plan.n_data, "n_model": plan.n_model, "main": is_main_process(),
            "slice": [sl.start, sl.stop], "backend": plan.backend,
            "transport": plan.transport, "n_nodes": context().n_nodes,
            "data_rank": plan.data_rank, "model_rank": plan.model_rank,
            "data_spec": list(data_sharding(plan).spec), "rows_of_10": [rows.start, rows.stop]}, {}


JOBS = {"forward": job_forward, "train": job_train, "epoch": job_epoch,
        "run_training": job_run_training, "helpers": job_helpers}


def main():
    spec_path, out = sys.argv[1], sys.argv[2]
    with open(spec_path) as f:
        spec = json.load(f)
    assert initialize_from_env(device="cpu")
    import torch.distributed as dist

    rank = dist.get_rank()
    torch.manual_seed(0)
    data = np.load(spec["data"]) if spec.get("data") else None
    results, arrays = {}, {}
    for job in spec["jobs"]:
        scalars, arrs = JOBS[job["kind"]](job, data)
        results[job["id"]] = scalars
        arrays.update({f"{job['id']}/{k}": v for k, v in arrs.items()})
    if rank == 0:
        np.savez(out + ".npz", **arrays)
    with open(f"{out}_{rank}.json", "w") as f:
        json.dump({"rank": rank, "jobs": results, "jax_loaded": "jax" in sys.modules}, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
