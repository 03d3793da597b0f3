"""The reference's training contract, as the JAX package's ``train/driver.py``:
``initialize_model`` (with ``load_model`` resuming from a checkpoint) +
``train_loop`` (with ``save``), over :class:`ModelBundle`, for both model
families (``num_decoder_layers`` in the model parameters,
``train_loop(encoder_only=0)`` for teacher forcing), and the production loop
``run_training`` on one device: epoch blocks, the on-device augment,
scheduled saves (snapshot on the device, written by the save worker), a
reference ``.Model`` beside each, wandb.watch histograms, a wall-clock
budget and SIGTERM/SIGINT stops, and each block's metrics, epoch time and
throughput logged through ``utils/logging.py``.

The dropout and shuffle generator of an epoch block is seeded from ``(seed +
1, the block's first epoch)``, never from the previous block's draws, so a
run stopped and resumed from its checkpoint trains exactly as the
uninterrupted run does.

``run_training`` also takes a host ``streamer`` (``data/pipeline.py``) whose
generations it swaps into the resident tensors every ``regen_cadence`` blocks
(an int, or ``"auto"``: fit a generation's build time into the blocks it
serves), a partial generation written in place; and with ``TGI_PROFILE`` set
and a run active it writes a ``torch.profiler`` trace of the first block to
``<run dir>/profile``. With evaluators (``eval/evaluator.py``) each block ends
in an eval pass over every evaluator's set, held resident on the device: the
held-out losses, fetched once a block, and the metric families, fetched once
on a scalar-only epoch; a media epoch runs ``log_eval``, its rendering on a
worker thread (:class:`_MediaWorker`). With a ``plan`` (``parallel/``)
it trains over data, tensor and pipeline parallelism, one rank per process
(:func:`_PlanRun`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import signal
import threading
import time
import traceback
from typing import Any

import numpy as np
import torch

from .. import require_device
from ..eval.evaluator import log_eval
from ..eval.metrics import _metric_stack_torch, format_families
from ..models import predict as model_predict
from ..models import torch_compat
from ..models.transformer import GrooveTransformerConfig
from ..utils import logging as xlog
from . import checkpoint as ckpt
from .config import (
    HyperParams, derive_model_config, resolve_compute_dtype, resolve_fused_decoder_layer,
    resolve_fused_ffn, resolve_fused_layer, resolve_remat,
)
from .loop import (
    TrainState, create_train_state, fetch, make_epoch_fn, make_eval_loss_fn, make_watch_fn,
)
from .schedule import eval_log_freq


def _predict_metric_stacks(model, x, gt):
    """(acc, vel_mse, offset_mse) per-voice stacks, each ``(V,)`` on the
    device, from the model's thresholded predict in eval mode, composed with
    the metric reduction of the tensor path (``eval/metrics.py``): one
    composition for :func:`make_eval_metric_fn` and the driver's eval pass."""
    was_training = model.training
    model.eval()
    try:
        h, v, o = model_predict(model, x, use_thres=True, thres=0.5)
    finally:
        model.train(was_training)
    return _metric_stack_torch(torch.cat([h, v, o], dim=-1).float(), gt)


def make_eval_metric_fn(model):
    """``(inputs, gt) → (acc, vel_mse, offset_mse)`` per-voice stacks on the
    device: the standalone form of the driver's eval pass without the
    losses. The JAX function takes the parameters first; the port's model
    holds its own."""
    return lambda inputs, gt: _predict_metric_stacks(model, inputs, gt)


# the order of make_eval_loss_fn's metrics in the eval pass's packed losses
_LOSS_KEYS = ("loss", "hit_accuracy", "bce_hits", "mse_velocities", "mse_offsets")


def _make_eval_pass(model, sets: dict, hit_loss_penalty: float, encoder_only: bool = True):
    """``sets``: name → (inputs, targets, GT grids), tensors on the model's
    device → ``eval_pass()``: the held-out losses and the metric stacks of
    every set, packed as ``(n_sets, 5)`` (:data:`_LOSS_KEYS`) and ``(n_sets,
    3, V)`` device tensors, so that a block fetches each in one transfer."""
    eval_loss_fn = make_eval_loss_fn(hit_loss_penalty, encoder_only)

    def eval_pass():
        losses, stacks = [], []
        for hx, hy, gt in sets.values():
            held = eval_loss_fn(model, hx, hy)
            losses.append(torch.stack([held[k].float() for k in _LOSS_KEYS]))
            stacks.append(torch.stack(_predict_metric_stacks(model, hx, gt)))
        return torch.stack(losses), torch.stack(stacks)

    return eval_pass


class _MediaWorker:
    """One background thread running eval-media closures (the host half of
    ``log_eval``) so that they overlap the next epoch block. The queue holds 4
    passes (backpressure); a pass's exception is held and printed with its
    traceback at flush, so media never stops a training run."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._errors: list = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="eval-media-writer")
        self._thread.start()

    def _loop(self):
        while True:
            fn = self._q.get()
            if fn is None:
                self._q.task_done()
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — held, printed at flush
                self._errors.append(traceback.format_exc())
            finally:
                self._q.task_done()

    def submit(self, fn):
        self._q.put(fn)

    def flush(self):
        """Block until every submitted pass has run; print held errors."""
        self._q.join()
        for e in self._errors:
            print(f"media worker: a deferred media pass failed:\n{e}", flush=True)
        self._errors.clear()

    def close(self):
        self.flush()
        self._q.put(None)
        self._thread.join()


@dataclasses.dataclass
class ModelBundle:
    """Model + optimizer + state on one device, with the reference's predict
    contract."""

    model: torch.nn.Module
    config: GrooveTransformerConfig
    state: TrainState
    device: torch.device
    optimizer_algorithm: str = "sgd"
    learning_rate: float = 0.05

    def predict(self, inputs, use_thres: bool = True, thres: float = 0.5):
        """Batched deterministic inference → ``[h, v, o]`` numpy arrays,
        fetched in one transfer."""
        x = torch.as_tensor(np.asarray(inputs, np.float32), device=self.device)
        was_training = self.model.training
        self.model.eval()
        try:
            out = model_predict(self.model, x, use_thres=use_thres, thres=thres)
        finally:
            self.model.train(was_training)
        return list(torch.stack(out).cpu().numpy())


def plan_topology(plan, batch_size: int) -> tuple[int, bool]:
    """``(n_devices, dp_shard_ok)`` of a plan for the kernel switches
    (``train/config.py::resolve_fused_layer``): dp_shard_ok on a dp-only
    plan of several ranks whose data axis divides the batch (the JAX
    training driver's test)."""
    from ..parallel.pipeline import PipelinePlan

    if plan is None:
        return 1, False
    ok = (not isinstance(plan, PipelinePlan) and plan.size > 1 and plan.n_model == 1
          and batch_size % plan.n_data == 0)
    return plan.size, ok


def initialize_model(params: dict, device="cuda", plan=None) -> tuple[ModelBundle, Any, int]:
    """Reference ``initialize_model`` contract: ``params = {"model": {...},
    "training": {...}, "load_model": None | ...}`` → (bundle, optimizer,
    initial_epoch), on ``device`` (``"cuda"`` without CUDA raises; the CPU
    only when asked for). ``num_decoder_layers`` > 0 builds the
    encoder-decoder family. ``load_model`` (``checkpoint.restore``'s dict)
    restores the parameters and the optimizer state from a native checkpoint
    (a ``.Model`` holds the parameters only) and returns its epoch + 1.
    ``bf16``, ``fused_ffn`` and ``remat`` in ``params["model"]`` are resolved
    for that device (``train/config.py``; None or absent = auto);
    ``fused_dropout_ln`` (off unless given) and ``remat_policy`` are taken as
    they are.

    Unlike the reference, ``fused_layer`` and ``fused_decoder_layer`` are
    resolved here too: the JAX ``initialize_model`` passes only ``fused_ffn``
    and ``remat`` and leaves both at their default, off, but on the card the
    whole-layer kernels are why the port exists, so auto turns them on at the
    batch sizes where they were measured faster (<= 512,
    ``resolve_fused_layer``), and on a CUDA device the inference forwards
    run the attention kernel (``derive_model_config``). Every kernel switch is
    resolved by ``params["training"]["batch_size"]`` (default 16), and by
    ``plan``'s topology when a mesh plan (``parallel/``) is given
    (:func:`plan_topology`; the model is then built on the plan's device)."""
    m = params["model"]
    t = params.get("training", {})
    device = require_device(plan.device if plan is not None else device, "initialize_model")
    compute_dtype = resolve_compute_dtype(m.get("bf16"), device)
    n_dec = m.get("num_decoder_layers", 0)
    batch = t.get("batch_size", 16)
    n_devices, dp_shard_ok = plan_topology(plan, batch)
    gate = (m["d_model"], m["n_heads"], m["dim_feedforward"], n_devices, compute_dtype,
            m.get("max_len", 32))
    remat = resolve_remat(
        m.get("remat"), d_model=m["d_model"], n_heads=m["n_heads"],
        dim_feedforward=m["dim_feedforward"], n_layers=m["num_encoder_layers"],
        n_decoder_layers=n_dec, optimizer=m.get("optimizer", "sgd"), batch_size=batch,
        max_len=m.get("max_len", 32), compute_dtype=compute_dtype, device=device)
    config = GrooveTransformerConfig(
        fused_ffn=resolve_fused_ffn(m.get("fused_ffn"), m["dim_feedforward"], m["d_model"],
                                    compute_dtype, device),
        fused_dropout_ln=bool(m.get("fused_dropout_ln", False)),
        fused_layer=resolve_fused_layer(m.get("fused_layer"), *gate, batch_size=batch,
                                        dp_shard_ok=dp_shard_ok),
        fused_decoder_layer=(resolve_fused_decoder_layer(m.get("fused_decoder_layer"), *gate,
                                                         batch_size=batch,
                                                         dp_shard_ok=dp_shard_ok)
                             if n_dec > 0 else False),
        remat=remat,
        remat_policy=m.get("remat_policy"),
        use_fused_attention=device.type == "cuda",
        d_model=m["d_model"],
        n_heads=m["n_heads"],
        dim_feedforward=m["dim_feedforward"],
        dropout=m["dropout"],
        num_encoder_layers=m["num_encoder_layers"],
        num_decoder_layers=n_dec,
        max_len=m.get("max_len", 32),
        embedding_size_src=m.get("embedding_size_src", 16),
        embedding_size_tgt=m.get("embedding_size_tgt", 27),
        compute_dtype=compute_dtype,
    )
    algorithm = m.get("optimizer", "sgd")
    lr = t.get("learning_rate", 0.05)
    state = create_train_state(config, algorithm, lr, int(t.get("seed", 0)), device)
    initial_epoch = 0
    if params.get("load_model"):
        restored, opt_state, initial_epoch = ckpt.restore(params["load_model"], config)
        state.model.load_state_dict(torch_compat.state_dict_from_flax_params(restored, config),
                                    strict=True)
        if opt_state is not None:
            try:
                torch_compat.load_optax_state(state.optimizer, state.model, config, opt_state)
            except ValueError as e:
                raise ValueError(
                    f"checkpoint optimizer state does not match optimizer={algorithm!r}: it "
                    "was saved by a different optimizer; set params['model']['optimizer'] "
                    "to the one used at save time") from e
    bundle = ModelBundle(model=state.model, config=config, state=state, device=device,
                         optimizer_algorithm=algorithm, learning_rate=lr)
    return bundle, state.optimizer, initial_epoch


def _device_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def train_loop(dataloader=None, groove_transformer: ModelBundle | None = None,
               encoder_only: int = 1, opt=None, epoch: int = 0,
               loss_fn=None, bce_fn=None, mse_fn=None, device=None,
               test_inputs=None, test_gt=None,
               validation_inputs=None, validation_gt=None,
               hit_loss_penalty: float = 1.0, save: bool = False,
               *, dataset=None, batch_size: int = 16, ckpt_dir: str = "checkpoints",
               run_id: str = "local", seed: int | None = None) -> dict:
    """Reference ``train_loop`` contract: one epoch of training, then the
    held-out losses (``test_*``, ``validation_*``). ``encoder_only=0`` trains
    the encoder-decoder family with teacher forcing. ``dataloader`` is the
    dataset object itself (``processed_inputs``/``processed_outputs``), or
    pass ``dataset=``; ``loss_fn``/``bce_fn``/``mse_fn``/``device``/``opt``
    are accepted for the signature and ignored (the bundle holds the
    optimizer and the device). The shuffle and dropout draws come from a
    generator seeded with ``seed``, else ``epoch``. The metrics are logged
    (``utils/logging.py``, uncommitted, as the JAX package does); ``save``
    writes ``ckpt_dir/transformer_run_{run_id}_Epoch_{epoch}.ckpt``."""
    bundle = groove_transformer
    data = dataset if dataset is not None else dataloader
    if bundle is None or data is None:
        raise ValueError("train_loop needs groove_transformer and a dataset")
    dev = bundle.device
    inputs = _device_tensor(data.processed_inputs, dev)
    outputs = _device_tensor(data.processed_outputs, dev)
    epoch_fn = make_epoch_fn(hit_loss_penalty, batch_size, int(inputs.shape[0]),
                             encoder_only=bool(encoder_only))
    eval_loss_fn = make_eval_loss_fn(hit_loss_penalty, bool(encoder_only))
    generator = torch.Generator(dev).manual_seed(epoch if seed is None else seed)
    metrics = epoch_fn(bundle.state, inputs, outputs, generator)
    for name, (hx, hy) in (("test", (test_inputs, test_gt)),
                           ("validation", (validation_inputs, validation_gt))):
        if hx is not None and hy is not None:
            held = eval_loss_fn(bundle.model, _device_tensor(hx, dev), _device_tensor(hy, dev))
            metrics.update({f"{name}_{k}": v for k, v in held.items()})
    metrics = fetch(metrics)
    xlog.log(metrics, commit=False)
    if save:
        ckpt.save_checkpoint(ckpt_dir, run_id, epoch, bundle.state, metrics["loss"],
                             bundle.config)
    return metrics


class _GracefulStop:
    """Preemption-safe stop: SIGTERM/SIGINT finish the current epoch block,
    checkpoint, and return cleanly. A second SIGINT raises
    ``KeyboardInterrupt``. The previous handlers come back on exit. Off the
    main thread no handler can be installed; ``request()`` sets the flag."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def request(self):
        self.requested = True

    def _handle(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self.requested = True
        print("graceful stop: signal received; finishing the current epoch block, then "
              "checkpointing", flush=True)

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc):
        for sig, handler in self._prev.items():
            signal.signal(sig, handler)
        return False


def block_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of the epoch block that starts at ``epoch``: seeded
    from ``(seed + 1, epoch)`` alone, so a resumed run draws what the
    uninterrupted run drew. ``epoch`` >= 2**31 is the watch events' domain."""
    return torch.Generator(device).manual_seed(((seed + 1) << 32) | int(epoch))


def _slab_update(full: torch.Tensor, slab: np.ndarray, start: int) -> torch.Tensor:
    """Write ``slab`` over ``full[start:start + len(slab)]`` in place, on the
    current stream: after every kernel already queued there (the previous
    block's reads) and before the next block's. On a CUDA tensor the slab is
    copied through pinned host memory without blocking the host; PyTorch's
    pinned-memory allocator keeps that buffer until the copy has run, and the
    returned buffer is the caller's to hold as well."""
    src = torch.from_numpy(np.ascontiguousarray(slab, np.float32))
    if full.is_cuda:
        src = src.pin_memory()
    full[start:start + src.shape[0]].copy_(src, non_blocking=full.is_cuda)
    return src


def _next_cadence(cadence: int, pending: int | None, gen_s: float, block_s: float):
    """The auto regen cadence after a block: the fewest blocks whose time
    covers one generation's build (``gen_s <= cadence · block_s``). A rise
    applies at once; a fall needs two blocks in a row that agree on it (a
    generation about as long as a block would flap between 1 and 2
    otherwise). → ``(cadence, pending)``."""
    want = max(1, int(np.ceil(gen_s / max(block_s, 1e-9))))
    if want >= cadence:
        return want, None
    if want == pending:
        return want, None
    return cadence, want


@contextlib.contextmanager
def _device_trace(profile_dir: str, device: torch.device):
    """A ``torch.profiler`` trace (CPU ops and, on a CUDA device, its kernels,
    from every thread) of the ``with`` body, written as one Chrome trace
    ``profile_dir/trace.json``; the device is synchronised before the trace
    closes, so every kernel of the body is in it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


class _PlanRun:
    """What ``run_training(plan=...)`` adds to the one-device loop, following
    the JAX driver: the plan's topology gates the kernel switches
    (``dp_shard_ok``), a pipeline plan swaps in its step, a "model" axis
    splits the parameters, and across processes the ranks agree on the stop,
    the streaming swaps and their cadence, checkpoints are gathered on every
    rank and written by rank 0, and each rank's streamer feeds its
    generation into the global array every rank trains from."""

    def __init__(self, plan, hp: HyperParams):
        import torch.distributed as dist

        from ..parallel.comm import Comm
        from ..parallel.multihost import context
        from ..parallel.pipeline import PipelinePlan

        self.plan = plan
        self.is_pp = isinstance(plan, PipelinePlan)
        self.n_proc = dist.get_world_size()
        self.rank = dist.get_rank()
        if self.is_pp and context().n_nodes > 1:
            raise NotImplementedError(
                "pipeline parallelism runs on one node: its point-to-point ring of ranks "
                "spans no network here (the JAX package's pipeline is single-process); "
                "across nodes use dp or dp×tp (parallel/mesh.py)")
        self.world = Comm(None, plan.transport, self.n_proc)
        self.dp_shard_ok = plan_topology(plan, hp.batch_size)[1]

    def check_config(self, config: GrooveTransformerConfig, hp: HyperParams) -> None:
        """The JAX driver's refusals, with its exception types."""
        forced = [f for f in ("fused_layer", "fused_decoder_layer") if getattr(config, f)]
        if forced and self.plan.size > 1 and not self.dp_shard_ok:
            raise NotImplementedError(
                f"{'/'.join(forced)} on this mesh is unsupported: the whole-layer kernels "
                "(encoder and decoder) compose with DATA parallelism only, each rank running "
                "them on its rows (batch_size must divide the data axis); tensor- and "
                f"pipeline-parallel layers are split. Drop "
                f"{'those flags' if len(forced) > 1 else 'that flag'} (auto turns them off "
                "here), use a dp-only mesh with a dividing batch size, or run on one device.")
        if self.is_pp:
            from ..parallel.pipeline import check_pipeline_batch

            if not config.encoder_only:
                raise NotImplementedError(
                    "pipeline parallelism covers the encoder-only family; the "
                    "encoder-decoder family is trained with dp or dp×tp")
            check_pipeline_batch(self.plan, hp.batch_size, config.num_encoder_layers)

    def step_fn(self, hp: HyperParams):
        if not self.is_pp:
            return None
        from ..parallel.pipeline import make_pipeline_step

        return make_pipeline_step(self.plan, hp.hit_loss_penalty)

    def shard(self, bundle: "ModelBundle") -> None:
        if self.plan.n_model > 1:
            from ..parallel.mesh import shard_params

            shard_params(bundle.model, self.plan, True, bundle.state.optimizer)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is on any rank."""
        t = torch.tensor([float(flag)], device=self.plan.device)
        return bool(self.world.all_reduce(t).item() > 0)

    def max(self, value: int) -> int:
        t = torch.tensor([int(value)], device=self.plan.device)
        return int(max(int(v.item()) for v in self.world.all_gather(t)))

    def check_streamer(self, streamer) -> int:
        """Every rank's generation size must be equal (the JAX check) →
        the global sample count."""
        n_local = int(streamer.n_samples)
        t = torch.tensor([n_local], device=self.plan.device)
        sizes = [int(v.item()) for v in self.world.all_gather(t)]
        if any(s != n_local for s in sizes):
            raise ValueError(
                f"multi-host streaming needs equal per-process generation "
                f"sizes, got {sizes} — shard the corpus into equal "
                f"parts (train.py does this automatically)")
        return n_local * self.n_proc

    def swap(self, streamer, n: int, dev):
        """One streaming swap across ranks: every rank builds its generation,
        the ranks agree that all succeeded, then gather the global arrays."""
        error = None
        try:
            fresh_in, fresh_out = streamer.next_epoch()
            if fresh_in.shape[0] * self.n_proc != n or fresh_out.shape[0] * self.n_proc != n:
                raise ValueError(
                    f"streamer generation sizes {fresh_in.shape[0]}/{fresh_out.shape[0]} "
                    f"!= local shard size {n // self.n_proc}; generations must keep a "
                    "constant per-process size")
        except Exception as e:  # noqa: BLE001 — agreed across ranks, then raised
            error = e
        if self.any(error is not None):
            if error is not None:
                raise error
            raise RuntimeError("streaming generation failed on a peer process (its error is "
                               "in that process's log); stopping the group")
        return (torch.cat(self.world.all_gather(_device_tensor(fresh_in, dev))),
                torch.cat(self.world.all_gather(_device_tensor(fresh_out, dev))))

    def save(self, bundle: "ModelBundle", ckpt_dir, run_id, epoch, loss, legacy: bool) -> None:
        """Gather on every rank (a collective under tensor parallelism),
        write on rank 0."""
        payload = ckpt.fetch_state_to_host(bundle.state)
        if self.rank == 0:
            ckpt.save_payload_async(ckpt_dir, run_id, epoch, payload, loss, bundle.config)
            if legacy:
                ckpt.export_legacy(ckpt_dir, run_id, epoch, payload["params"], bundle.config,
                                   loss)


def run_training(hp: HyperParams, dataset, evaluators: dict | None = None, *,
                 bundle: ModelBundle | None = None, initial_epoch: int = 0, plan=None,
                 only_final_eval: bool = False, dump_eval: bool = False,
                 ckpt_dir: str = "checkpoints", export_legacy: bool = False, seed: int = 0,
                 log_media: bool = True, epoch_block: int = 1, streamer=None,
                 regen_cadence: int | str = 1, on_device_augment=None,
                 augment_per_epoch: bool = True, watch_log_freq: int | None = 1000,
                 max_wall_s: float | None = None, media_async: bool = True,
                 device="cuda", _stopper: _GracefulStop | None = None) -> ModelBundle:
    """The JAX package's production loop, on one device (``device``, or the
    bundle's; ``"cuda"`` without CUDA raises).

    ``epoch_block`` epochs run per call of the epoch function; logging, the
    stop check and saves happen per block. ``on_device_augment`` (from
    ``data/device_pipeline.py::make_on_device_augment``) runs inside every
    epoch, or once a block with ``augment_per_epoch=False``; pass the clean
    grids as the dataset's ``processed_inputs``/``processed_outputs``.
    ``streamer`` (``data/pipeline.py::StreamingAugmenter``, or anything with
    ``n_samples`` and ``next_epoch``/``next_epoch_delta``) supplies the
    arrays instead, ``streamer.n_samples`` rows of them: a fresh generation is
    swapped in before the first block and then every ``regen_cadence``
    blocks, or with ``"auto"`` every as many blocks as one generation takes
    to build (the JAX driver's rule and hysteresis, :func:`_next_cadence`);
    a partial generation's slab is written into the resident tensors in
    place (:func:`_slab_update`). A checkpoint is saved after every block
    that holds an epoch of the reference schedule (``eval_log_freq``;
    ``only_final_eval``: the last epoch only) and at a stop, by a device
    snapshot written on the save worker, with a ``.Model`` beside it when
    ``export_legacy`` (encoder-only models). ``watch_log_freq``: parameter
    and gradient histograms every that many steps (None: never).
    ``max_wall_s``: stop after the first block that crosses the wall-clock
    budget; SIGTERM/SIGINT stop the same way. Every block logs its metrics,
    ``epoch_time_s`` and ``seqs_per_sec``; saves are flushed before the
    function returns. With ``TGI_PROFILE`` set and a run active
    (``utils.logging.init``), the first block runs under a ``torch.profiler``
    trace written to ``<run dir>/profile/trace.json``. ``_stopper``: a test
    hook.

    ``evaluators``: ``{"train": ev, "test": ev, "validation": ev}`` (any of
    them; ``eval/evaluator.py``). Their inputs, targets and GT grids stay on
    the device for the run, and every block ends in one eval pass
    (:func:`_make_eval_pass`): each set's held-out losses, logged as
    ``{set}_{key}`` after one fetch, and its metric families. On a
    scalar-only epoch the families come from that pass, fetched once and
    logged under ``{Set}_Set``; on a media epoch (``eval_log_freq``'s
    ``save_all``, with ``log_media``) ``log_eval`` runs instead, its media and
    feature stats deferred to a worker thread with ``media_async`` unless
    wandb is online, and ``dump_eval`` dumps the evaluator. A stop skips the
    families and media of its block.

    ``plan``: a ``parallel/mesh.py::MeshPlan`` (data and tensor parallelism)
    or ``parallel/pipeline.py::PipelinePlan`` (dp × pp [× tp]); the model
    lives on the plan's device. Every rank holds the resident corpus and
    trains on its rows of each global batch (the same batches as one
    process); a "model" axis splits the layers (``shard_params``, also of a
    restored bundle); a pipeline plan runs its step
    (``make_pipeline_step``; the encoder-decoder family and a pipe spanning
    nodes are refused with ``NotImplementedError``, as are the whole-layer
    kernels forced on a tensor- or pipeline-parallel plan). Across
    processes: each rank's ``streamer`` streams its own equal corpus shard,
    gathered into the global generation at each swap (full generations);
    the ranks agree on the stop and the auto cadence; checkpoints are
    gathered on every rank and written by rank 0 in the one-device flax
    layout (they load in either package and in a one-rank run); the
    evaluators and the watch pass run in a single process only (the command
    line disables the evaluators, as root ``train.py`` does)."""
    plan_run = _PlanRun(plan, hp) if plan is not None else None
    if plan_run is not None:
        device = plan.device
        if bundle is not None and bundle.device != plan.device:
            raise ValueError(f"the bundle lives on {bundle.device}, the plan's rank on "
                             f"{plan.device}")
    multi = plan_run is not None and plan_run.n_proc > 1
    if multi and evaluators:
        if plan_run.rank == 0:
            print("multi-host run: in-training evaluators disabled (evaluate offline from "
                  "checkpoints: python -m transformergrooveinfilling_tpu_torch.evaluate)")
        evaluators = {}
    if multi:
        watch_log_freq = None
    if streamer is not None and on_device_augment is not None:
        raise ValueError("streamer and on_device_augment are mutually exclusive")
    auto_cadence = regen_cadence == "auto"
    if not auto_cadence and not (isinstance(regen_cadence, int) and regen_cadence >= 1):
        raise ValueError(f"regen_cadence must be a positive int or 'auto', got "
                         f"{regen_cadence!r}")
    if bundle is None:
        device = require_device(device, "run_training")
        n_devices, dp_shard_ok = plan_topology(plan, hp.batch_size)
        config = derive_model_config(hp, n_devices=n_devices, dp_shard_ok=dp_shard_ok,
                                     device=device)
        state = create_train_state(config, hp.optimizer_algorithm, hp.learning_rate, seed,
                                   device)
        bundle = ModelBundle(model=state.model, config=config, state=state, device=device,
                             optimizer_algorithm=hp.optimizer_algorithm,
                             learning_rate=hp.learning_rate)
    dev = bundle.device
    step_fn = None
    if plan_run is not None:
        plan_run.check_config(bundle.config, hp)
        plan_run.shard(bundle)
        step_fn = plan_run.step_fn(hp)
    if streamer is not None:
        # the first generation fills them before any use
        n, inputs, outputs = int(streamer.n_samples), None, None
        if multi:
            n = plan_run.check_streamer(streamer)
    else:
        inputs = _device_tensor(dataset.processed_inputs, dev)
        outputs = _device_tensor(dataset.processed_outputs, dev)
        n = int(inputs.shape[0])
    if n == 0:
        raise ValueError("dataset is empty")
    encoder_only = bundle.config.encoder_only
    epoch_block = max(1, min(epoch_block, hp.epochs - initial_epoch or 1))
    evaluators = evaluators or {}
    eval_pass = (_make_eval_pass(bundle.model, {
        name: (_device_tensor(ev.processed_inputs, dev), _device_tensor(ev.processed_gt, dev),
               _device_tensor(ev._gt_hvos_array, dev))
        for name, ev in evaluators.items()}, hp.hit_loss_penalty, encoder_only)
        if evaluators else None)
    media_worker = None

    def epoch_fn_of(block: int):
        return make_epoch_fn(hp.hit_loss_penalty, hp.batch_size, n, n_epochs=block,
                             augment=on_device_augment, augment_per_epoch=augment_per_epoch,
                             encoder_only=encoder_only, plan=plan, step_fn=step_fn)

    epoch_fn = epoch_fn_of(epoch_block)
    save_partial, save_all = eval_log_freq(
        total_epochs=hp.epochs, initial_epochs_lim=10, initial_step_partial=1,
        initial_step_all=1, secondary_step_partial=10, secondary_step_all=20,
        only_final=only_final_eval)
    scheduled = set(int(e) for e in save_partial) | set(int(e) for e in save_all)
    run = xlog.run
    run_id = run.id if run is not None else time.strftime("%H%M%S")
    profile_dir = (os.path.join(run.dir, "profile")
                   if os.environ.get("TGI_PROFILE") and run is not None else None)
    steps_per_epoch = -(-n // hp.batch_size)
    steps_done = initial_epoch * steps_per_epoch
    watch_events = steps_done // watch_log_freq if watch_log_freq else 0
    watch_fn = None
    cadence, cadence_pending, blocks_run = (1 if auto_cadence else regen_cadence), None, 0
    slabs = ()  # the pinned host buffers of the last in-place swap, held until the next
    stopper = _stopper or _GracefulStop()
    run_start = time.time()
    try:
        with stopper:
            ep = initial_epoch
            while ep < hp.epochs:
                block = min(epoch_block, hp.epochs - ep)
                run_fn = epoch_fn if block == epoch_block else epoch_fn_of(block)
                t0 = time.time()
                if multi and streamer is not None and blocks_run % cadence == 0:
                    inputs, outputs = plan_run.swap(streamer, n, dev)
                elif streamer is not None and blocks_run % cadence == 0:
                    if hasattr(streamer, "next_epoch_delta"):
                        sl, fresh_in, fresh_out = streamer.next_epoch_delta()
                    else:  # plain next_epoch streamers (tests, custom producers)
                        sl, (fresh_in, fresh_out) = None, streamer.next_epoch()
                    if sl is None:
                        if fresh_in.shape[0] != n or fresh_out.shape[0] != n:
                            raise ValueError(
                                f"streamer generation size {fresh_in.shape[0]} != the "
                                f"epoch's n_samples {n}; generations must keep a constant "
                                "size")
                        inputs, outputs = _device_tensor(fresh_in, dev), _device_tensor(
                            fresh_out, dev)
                    else:
                        slabs = (_slab_update(inputs, fresh_in, sl.start),
                                 _slab_update(outputs, fresh_out, sl.start))
                generator = block_generator(seed, ep, dev)
                if profile_dir and ep == initial_epoch:
                    with _device_trace(profile_dir, dev):
                        metrics = fetch(run_fn(bundle.state, inputs, outputs, generator))
                else:
                    metrics = fetch(run_fn(bundle.state, inputs, outputs, generator))
                ep += block  # one past the last epoch trained
                dt = time.time() - t0
                metrics["epoch_time_s"] = dt / block
                metrics["seqs_per_sec"] = n * block / dt if dt > 0 else 0.0
                blocks_run += 1
                if streamer is not None and auto_cadence:
                    gen_s = getattr(streamer, "last_generation_seconds", 0.0)
                    if multi:
                        # the slowest rank's build sets every rank's cadence, so
                        # all ranks swap on the same blocks
                        gen_s = plan_run.max(int(np.ceil(gen_s * 1000))) / 1000.0
                        dt_agreed = plan_run.max(int(dt * 1000)) / 1000.0
                    else:
                        dt_agreed = dt
                    new_cadence, cadence_pending = _next_cadence(cadence, cadence_pending,
                                                                 gen_s, dt_agreed)
                    if new_cadence != cadence:
                        print(f"streaming: auto regen cadence -> every {new_cadence} "
                              f"block(s) (generation {gen_s:.1f}s, block {dt:.1f}s)")
                    cadence = new_cadence
                if evaluators:
                    # the losses now in one fetch; the stacks stay on the device
                    # until a scalar-only epoch reads them
                    losses, stacks = eval_pass()
                    for name, row in zip(evaluators, losses.cpu().tolist()):
                        metrics.update({f"{name}_{k}": v for k, v in zip(_LOSS_KEYS, row)})
                stop_now = stopper.requested or (
                    max_wall_s is not None and time.time() - run_start > max_wall_s)
                if multi:  # a one-sided stop would leave the peers in a collective
                    stop_now = plan_run.any(stop_now)
                if stop_now:
                    metrics["graceful_stop"] = 1.0
                last_ep = ep - 1
                xlog.log({**metrics, "epoch": last_ep}, commit=False)

                steps_done += block * steps_per_epoch
                if (not stop_now and watch_log_freq
                        and steps_done // watch_log_freq > watch_events):
                    watch_events = steps_done // watch_log_freq
                    if watch_fn is None:
                        watch_fn = make_watch_fn(hp.hit_loss_penalty, hp.batch_size,
                                                 encoder_only=encoder_only,
                                                 augment=on_device_augment)
                    hists = watch_fn(bundle.model, inputs, outputs,
                                     block_generator(seed, 2 ** 31 + watch_events, dev))
                    xlog.log({k: xlog.Histogram(c, e) for k, (c, e) in hists.items()},
                             commit=False)

                if stop_now or any(e in scheduled for e in range(ep - block, ep)):
                    if multi:
                        plan_run.save(bundle, ckpt_dir, run_id, last_ep, metrics["loss"],
                                      bool(export_legacy and encoder_only))
                    else:
                        ckpt.save_snapshot_async(
                            ckpt_dir, run_id, last_ep,
                            ckpt.snapshot_state_on_device(bundle.state), metrics["loss"],
                            bundle.config, legacy=bool(export_legacy and encoder_only))
                # a stop skips the families and media: the checkpoint above is
                # what must land in a short grace window
                if evaluators and not stop_now:
                    media_now = log_media and any(e in save_all for e in range(ep - block, ep))
                    if media_now and media_async and media_worker is None:
                        media_worker = _MediaWorker()
                    if not media_now:
                        for (name, ev), (acc, mse_v, mse_o) in zip(evaluators.items(),
                                                                   stacks.cpu().numpy()):
                            ev._identifier = f"{name.capitalize()}_Set"
                            xlog.log({**format_families(ev._identifier, acc, mse_v, mse_o),
                                      "epoch": last_ep}, commit=True)
                    else:
                        for name, ev in evaluators.items():
                            ev._identifier = f"{name.capitalize()}_Set"
                            log_eval(ev, bundle, log_media=True, epoch=last_ep, dump=dump_eval,
                                     defer=media_worker.submit if media_worker else None)
                xlog.log({"epoch": last_ep}, commit=True)
                if stop_now:
                    print(f"graceful stop: checkpoint saved at epoch {last_ep} ({run_id}); "
                          f"resume with load_model location=local dir={ckpt_dir}", flush=True)
                    break
    finally:
        ckpt.flush_async_saves()
        if media_worker is not None:
            media_worker.close()
    return bundle
