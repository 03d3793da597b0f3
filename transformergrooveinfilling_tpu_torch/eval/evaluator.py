"""Infilling evaluator, as the JAX package's ``eval/evaluator.py``.

The reference's ``InfillingEvaluator`` stack as an explicit pipeline over
arrays:

1. style-subset the ground-truth corpus (11 styles × beat × 4/4),
2. push the GT sequences through the *dataset's own* processing pipeline to get
   model inputs + processed GT targets (including augmentation fan-out); for
   the audio experiments that renders and analyses them on the evaluator's
   ``device`` (on the card kernels #6 and #7),
3. drop unused items, re-tag the augmented rows, rebuild per-style subsets,
4. at eval time: one batched ``model.predict`` over the input stack,
   vectorized per-voice metrics, and (optionally) media + feature stats.

The attribute/method surface (``processed_inputs``, ``processed_gt``,
``set_pred``, ``get_hits_accuracies`` …, ``save_as_pickle``, ``dump``) is the
reference's. Pickles name the JAX package's classes
(``utils/serialization.py``), so an evaluator pickled by either package loads
in the other; :func:`init_evaluator` sets the device the loaded evaluator and
its dataset compute on.

One difference from the JAX package: :meth:`HVOSeqSubsetInfillingEvaluator.get_logging_dict`
renders the audio or raises. The JAX package catches every exception there
and leaves the audio empty; here a missing ``.sf2`` (``FileNotFoundError``), a
malformed one (``audio.sf2.SF2Error``) or a fault of the mixer surfaces.
"""

from __future__ import annotations

import copy
import os

import numpy as np

from .. import require_device
from ..hvo import ROLAND_REDUCED_MAPPING
from ..utils import logging as xlog
from ..utils.serialization import load_pickle, save_to_pickle
from .metrics import metrics_dict

EVAL_STYLES = (
    "hiphop", "funk", "reggae", "soul", "latin", "jazz",
    "pop", "afrobeat", "highlife", "punk", "rock",
)


def style_filters(styles=EVAL_STYLES):
    """The reference's common eval filters."""
    return [
        {"style_primary": [s], "beat_type": ["beat"], "time_signature": ["4-4"]}
        for s in styles
    ]


def _progress(items, desc: str, disable: bool):
    """tqdm-style progress over the media synthesis loops (the reference wraps
    them in tqdm gated on ``disable_tqdm``); plain stderr counters where tqdm
    is not installed."""
    items = list(items)
    if disable or not items:
        return items
    try:
        from tqdm import tqdm

        return tqdm(items, desc=desc)
    except ImportError:
        import sys

        def gen():
            for i, it in enumerate(items):
                print(f"\r{desc}: {i + 1}/{len(items)}", end="",
                      file=sys.stderr)
                yield it
            print(file=sys.stderr)

        return gen()


def proportional_budget(sizes: list, budget: int) -> list:
    """Apportion ``budget`` eval slots across style subsets proportionally
    (largest-remainder), guaranteeing every non-empty subset >= 1 slot while
    the budget allows. Deterministic; returns one quota per input size."""
    k = len(sizes)
    total = sum(sizes)
    if total <= budget:
        return list(sizes)
    shares = [budget * s / total for s in sizes]
    quotas = [min(sizes[i], int(shares[i])) for i in range(k)]
    if budget >= sum(1 for s in sizes if s > 0):
        for i in range(k):
            if sizes[i] > 0:
                quotas[i] = max(quotas[i], 1)
    while sum(quotas) > budget:  # trim overshoot from the largest quota
        i = max(range(k), key=lambda j: quotas[j])
        quotas[i] -= 1
    # hand leftover slots out by largest fractional remainder, capped by size
    rem = sorted(range(k), key=lambda i: shares[i] - int(shares[i]),
                 reverse=True)
    for _ in range(k + 1):
        if sum(quotas) >= budget:
            break
        for i in rem:
            if sum(quotas) >= budget:
                break
            if quotas[i] < sizes[i]:
                quotas[i] += 1
    return quotas


class HVOSeqSubsetInfillingEvaluator:
    """Per-subset media/bookkeeping evaluator.

    Holds style-keyed lists of HVO sequences and renders audio / piano rolls /
    velocity heatmaps for sampled items; predictions are merged with the kept
    input voices ("context") before rendering, input hits winning on collision
    (the reference's ``add_removed_part_to_hvo``).
    """

    def __init__(self, set_subsets, set_tags, set_identifier,
                 n_samples_to_synthesize_visualize=10, disable_tqdm=True,
                 group_by_minor_keys=True, analyze_heatmap=True,
                 analyze_global_features=True, sf_dict=None, hvo_comp_dict=None,
                 horizontal=True, is_gt=None, epoch=None):
        self.subsets = {tag: list(sub) for tag, sub in zip(set_tags, set_subsets)}
        self.tags = list(set_tags)
        self.set_identifier = set_identifier
        self.n_samples_to_synthesize_visualize = n_samples_to_synthesize_visualize
        self.disable_tqdm = disable_tqdm
        self.analyze_heatmap = analyze_heatmap
        self.analyze_global_features = analyze_global_features
        self.sf_dict = sf_dict or {}
        self.hvo_comp_dict = hvo_comp_dict or {}
        self.horizontal = horizontal
        self.is_gt = is_gt
        self.epoch = epoch

    # -- sampling --------------------------------------------------------------

    def get_hvo_samples_located_at(self, locations: dict | None):
        if locations is None:
            locations = {
                tag: list(range(min(self.n_samples_to_synthesize_visualize,
                                    len(sub))))
                for tag, sub in self.subsets.items()
            }
        return {
            tag: [self.subsets[tag][i] for i in idxs if i < len(self.subsets[tag])]
            for tag, idxs in locations.items() if tag in self.subsets
        }

    def add_removed_part_to_hvo(self, sample_hvo, key, idx):
        """Merge a prediction with its kept-voices input context; input hits win.

        As in the JAX package, unlike the reference: the reference zeroes only the
        prediction's *hit* columns before adding, so the prediction's dense
        velocity/offset heads (sigmoid/tanh output at every cell) sum with the
        context's at every context-hit cell — velocities up to ~2.0 and
        offsets outside [-0.5, 0.5] in every "+inputs" render. Here all three
        channel groups are cleared at context-hit cells, so the context truly
        wins."""
        comp = self.hvo_comp_dict[key][idx]
        merged = sample_hvo.copy()
        n = len(comp.drum_mapping)
        rows, cols = np.nonzero(comp.hvo[:, :n])
        for off in (0, n, 2 * n):
            merged.hvo[rows, cols + off] = 0
        merged.hvo = merged.hvo + comp.hvo
        return merged

    def _caption(self, sample_hvo, idx: int, ext: str = "") -> str:
        title = "{}_{}_{}_{}{}".format(
            self.set_identifier,
            sample_hvo.metadata.style_primary,
            sample_hvo.metadata.master_id.replace("/", "_"),
            idx, ext,
        )
        if not self.is_gt:
            title = f"epoch_{self.epoch}_{title}"
        return title

    # -- media -----------------------------------------------------------------

    def get_audios(self, sf_paths=None, use_specific_samples_at=None):
        """[(caption, waveform)], alphabetically sorted; prediction merged with
        input context before synthesis.

        All sampled loops render in one batched mixer call
        (``audio.synth.synthesize_hvo_list``, equal to per-item
        ``synthesize`` calls); items whose grid shape disagrees take the
        per-item path."""
        from ..audio.synth import synthesize_hvo_list

        sampled = self.get_hvo_samples_located_at(use_specific_samples_at)
        captions, grids, qpms, sfs_flat = [], [], [], []
        for key, samples in _progress(
                sampled.items(),
                f"Synthesizing samples - {self.set_identifier}",
                self.disable_tqdm):
            for idx, sample in enumerate(samples):
                merged = (
                    self.add_removed_part_to_hvo(sample.copy(), key, idx)
                    if idx < len(self.hvo_comp_dict.get(key, []))
                    else sample.copy())
                sfs = self.sf_dict.get(key, [])
                captions.append(self._caption(sample, idx, ".wav"))
                grids.append((merged, merged.hvo))
                qpms.append(merged.tempos[0].qpm or 120.0)
                sfs_flat.append(sfs[idx] if idx < len(sfs) else None)
        if not grids:
            return []
        shapes = {g.shape for _, g in grids}
        if len(shapes) == 1:
            waves = synthesize_hvo_list(
                np.stack([g for _, g in grids]), np.asarray(qpms), sfs_flat)
        else:  # ragged grids: per-item rendering
            waves = [m.synthesize(sf_path=sf)
                     for (m, _), sf in zip(grids, sfs_flat)]
        out = sorted(zip(captions, waves), key=lambda ca: ca[0])
        return [(c, w) for c, w in out]

    def get_piano_rolls(self, use_specific_samples_at=None, add_inputs=False):
        """Self-contained HTML: per-style tabs of piano rolls."""
        from .media import piano_roll_html, tabs_html

        sampled = self.get_hvo_samples_located_at(use_specific_samples_at)
        tab_titles, tabs = [], []
        for tag in _progress(
                sorted(sampled),
                f"Creating piano rolls for {self.set_identifier}",
                self.disable_tqdm):
            rolls = []
            for idx, sample in enumerate(sampled[tag]):
                s = sample.copy()
                # input context exists only for the sampled audio locations
                if add_inputs and idx < len(self.hvo_comp_dict.get(tag, [])):
                    s = self.add_removed_part_to_hvo(s, tag, idx)
                rolls.append(piano_roll_html(s, title=self._caption(sample, idx)))
            tabs.append(tabs_html(rolls, [str(i) for i in range(len(rolls))]))
            tab_titles.append(tag)
        return tabs_html(tabs, tab_titles)

    def get_velocity_heatmaps(self, use_specific_samples_at=None):
        from .media import velocity_heatmap_html

        sampled = self.get_hvo_samples_located_at(use_specific_samples_at)
        return velocity_heatmap_html(sampled, self.set_identifier,
                                     horizontal=self.horizontal)

    def get_logging_dict(self, velocity_heatmap_html=True,
                         global_features_html=True, piano_roll_html=True,
                         audio_files=True, sf_paths=None,
                         use_specific_samples_at=None):
        out = {}
        if global_features_html and self.analyze_global_features:
            from .media import feature_pdf_html

            out["global_feature_pdfs"] = feature_pdf_html(
                self.get_hvo_samples_located_at(use_specific_samples_at),
                self.set_identifier)
        if piano_roll_html:
            out["piano_rolls"] = self.get_piano_rolls(use_specific_samples_at)
            out["piano_rolls_plus_inputs"] = self.get_piano_rolls(
                use_specific_samples_at, add_inputs=True)
        # analyze_heatmap=False disables heatmap rendering entirely (the
        # constructor flag the reference exposes)
        if velocity_heatmap_html and self.analyze_heatmap:
            out["velocity_heatmaps"] = self.get_velocity_heatmaps(
                use_specific_samples_at)
        if audio_files:
            out["captions_audios"] = self.get_audios(sf_paths, use_specific_samples_at)
        return out

    def get_wandb_logging_media(self, **kwargs):
        logging_dict = self.get_logging_dict(**kwargs)
        media = {}
        if "velocity_heatmaps" in logging_dict:
            media["velocity_heatmaps"] = {
                self.set_identifier: xlog.Html(logging_dict["velocity_heatmaps"])}
        if logging_dict.get("global_feature_pdfs"):
            media["global_feature_pdfs"] = {
                self.set_identifier: xlog.Html(
                    logging_dict["global_feature_pdfs"])}
        if "captions_audios" in logging_dict and logging_dict["captions_audios"]:
            media["audios"] = {
                self.set_identifier + "_plus_inputs": [
                    xlog.Audio(a, caption=c, sample_rate=44100)
                    for c, a in logging_dict["captions_audios"]
                ]
            }
        if "piano_rolls" in logging_dict:
            media["piano_roll_html"] = {
                self.set_identifier: xlog.Html(logging_dict["piano_rolls"]),
                self.set_identifier + "_plus_inputs": xlog.Html(
                    logging_dict["piano_rolls_plus_inputs"]),
            }
        return media


class InfillingEvaluator:
    """See module docstring. The reference's constructor signature plus
    ``sequences=`` for in-memory corpora (synthetic fixtures / tests);
    ``device`` is where the dataset's pipeline computes (``"cuda"`` without
    CUDA raises)."""

    __version___ = "0.3.2"

    def __init__(self, pickle_source_path="", set_subfolder="",
                 hvo_pickle_filename="hvo_sequence_data.obj",
                 _identifier="Train", n_samples_to_use=1024,
                 max_hvo_shape=(32, 27),
                 n_samples_to_synthesize_visualize_per_subset=20,
                 analyze_heatmap=True, analyze_global_features=True,
                 disable_tqdm=True, dataset=None, horizontal=True,
                 device="cuda", sequences=None, seed: int = 0):
        from ..data.subsetter import GrooveMidiSubsetter

        assert dataset is not None, "InfillingEvaluator needs the task dataset"
        self.dataset = dataset
        self._identifier = _identifier
        self.horizontal = horizontal
        self.device = require_device(device, "InfillingEvaluator")
        dataset._device = self.device
        self.disable_tqdm = disable_tqdm
        self.max_hvo_shape = max_hvo_shape
        self.analyze_heatmap = analyze_heatmap
        self.analyze_global_features = analyze_global_features
        self.sf_dict = {}
        self.hvo_comp_dict = {}
        self._rng = np.random.default_rng(seed)

        # 1. style subsets of the GT corpus
        tags, subsets = GrooveMidiSubsetter(
            pickle_source_path=pickle_source_path,
            subset=set_subfolder,
            hvo_pickle_filename=hvo_pickle_filename,
            list_of_filter_dicts_for_subsets=style_filters(),
            sequences=sequences,
        ).create_subsets()
        # keep only non-empty subsets; cap total at n_samples_to_use with
        # proportional per-style quotas, so that every surviving style keeps
        # eval coverage where early styles alone would exhaust the budget
        non_empty = [(tag, sub) for tag, sub in zip(tags, subsets) if sub]
        quotas = proportional_budget([len(s) for _, s in non_empty],
                                     n_samples_to_use)
        self._gt_tags, self._gt_subsets = [], []
        for (tag, sub), q in zip(non_empty, quotas):
            if q <= 0:
                continue
            self._gt_tags.append(tag)
            self._gt_subsets.append(sub[:q])

        # 2. flatten
        self._gmd_gt_hvo_sequences = []
        self._gt_hvos_array_tags = []
        for tag, sub in zip(self._gt_tags, self._gt_subsets):
            for s in sub:
                self._gmd_gt_hvo_sequences.append(s)
                self._gt_hvos_array_tags.append(tag)
        self._gmd_gt_hvos_array = (
            np.stack([s.get("hvo") for s in self._gmd_gt_hvo_sequences])
            if self._gmd_gt_hvo_sequences else np.zeros((0,) + max_hvo_shape))

        # 3. run GT through the dataset's processing pipeline
        processed = self.dataset.process_dataset(self._gmd_gt_hvo_sequences)
        self.processed_inputs = processed["processed_inputs"]
        self.processed_gt = processed["processed_outputs"]
        self.hvo_sequences_inputs = processed["hvo_sequences_inputs"]
        self.hvo_sequences_outputs = processed["hvo_sequences_outputs"]
        self.hvo_index = processed["hvo_index"]
        self.unused_items = processed["unused_items"]
        if "soundfonts" in processed:
            self.soundfonts = processed["soundfonts"]
        self._gt_hvo_sequences = processed["hvo_sequences_outputs"]
        self._gt_hvos_array = (
            np.stack([s.hvo for s in self._gt_hvo_sequences])
            if self._gt_hvo_sequences else np.zeros((0,) + max_hvo_shape))

        # 4. drop unused originals, re-tag augmented rows, rebuild subsets
        unused = set(self.unused_items)
        keep_orig = [i for i in range(len(self._gmd_gt_hvo_sequences))
                     if i not in unused]
        self._gmd_gt_hvos_array = self._gmd_gt_hvos_array[keep_orig]
        orig_tags = list(self._gt_hvos_array_tags)
        self._gmd_gt_hvo_sequences = [self._gmd_gt_hvo_sequences[i]
                                      for i in keep_orig]
        # augmented tags: one per processed row, via its source index
        self._gt_hvos_array_tags = [orig_tags[i] for i in self.hvo_index]

        grouped: dict[str, list] = {}
        for row, tag in enumerate(self._gt_hvos_array_tags):
            grouped.setdefault(tag, []).append(self._gt_hvo_sequences[row])
        self._gt_tags = [t for t in self._gt_tags if t in grouped]
        self._gt_subsets = [grouped[t] for t in self._gt_tags]

        self._prediction_hvo_seq_templates = [
            s.copy_empty()
            for sub in self._gt_subsets for s in sub
        ]

        # 5. GT subset evaluator + fixed audio sample locations
        self.gt_SubSet_Evaluator = HVOSeqSubsetInfillingEvaluator(
            self._gt_subsets, self._gt_tags,
            "Ground_Truth_" + self._identifier,
            disable_tqdm=disable_tqdm, horizontal=horizontal,
            analyze_heatmap=analyze_heatmap, is_gt=True,
        )
        self.audio_sample_locations = self.get_sample_indices(
            n_samples_to_synthesize_visualize_per_subset)

    # -- sampling --------------------------------------------------------------

    def get_sample_indices(self, n_samples: int = 20) -> dict:
        """tag → within-subset sample indices (seeded, stable across epochs)."""
        out = {}
        for tag, sub in zip(self._gt_tags, self._gt_subsets):
            k = min(n_samples, len(sub))
            out[tag] = sorted(
                self._rng.choice(len(sub), size=k, replace=False).tolist())
        return out

    # -- prediction ------------------------------------------------------------

    def set_pred(self, model):
        """Run ``model.predict`` over the resident inputs and regroup by style.

        ``model`` is anything with the reference predict contract
        (``predict(inputs, use_thres=True, thres=0.5) -> [h, v, o]``) — e.g. the
        training driver's ModelBundle.
        """
        eval_pred = model.predict(self.processed_inputs, use_thres=True, thres=0.5)
        self._prediction_hvos_array = np.concatenate(
            [np.asarray(p) for p in eval_pred], axis=2)
        self._metrics_cache = None  # new predictions → recompute metric families

        tags_order, subsets, index_dict = [], {}, {}
        templates = self._prediction_hvo_seq_templates
        for i in range(self._prediction_hvos_array.shape[0]):
            tag = self._gt_hvos_array_tags[i]
            t = copy.deepcopy(templates[i])
            t.hvo = self._prediction_hvos_array[i]
            subsets.setdefault(tag, []).append(t)
            index_dict.setdefault(tag, []).append(i)
            if tag not in tags_order:
                tags_order.append(tag)
        self._prediction_tags = tags_order
        self._prediction_subsets = [subsets[t] for t in tags_order]
        self._subset_hvo_array_index = index_dict

        self.prediction_SubSet_Evaluator = HVOSeqSubsetInfillingEvaluator(
            self._prediction_subsets, self._prediction_tags,
            "Predictions_" + self._identifier,
            disable_tqdm=self.disable_tqdm, horizontal=self.horizontal,
            analyze_heatmap=self.analyze_heatmap, is_gt=False,
        )

        # soundfonts + input-context sequences for the sampled audio locations
        sf_dict, hvo_comp_dict = {}, {}
        for key, idxs in self.audio_sample_locations.items():
            sf_dict[key], hvo_comp_dict[key] = [], []
            for idx in idxs:
                if idx >= len(index_dict.get(key, [])):
                    continue
                row = index_dict[key][idx]
                sf_dict[key].append(
                    self.soundfonts[row] if hasattr(self, "soundfonts") else None)
                hvo_comp_dict[key].append(self.hvo_sequences_inputs[row])
        self.sf_dict, self.hvo_comp_dict = sf_dict, hvo_comp_dict
        for ev in (self.gt_SubSet_Evaluator, self.prediction_SubSet_Evaluator):
            ev.sf_dict = sf_dict
            ev.hvo_comp_dict = hvo_comp_dict

    # -- metrics ---------------------------------------------------------------

    def _family(self, family: str) -> dict:
        # one vectorized pass covers all three families; cached per set_pred
        if getattr(self, "_metrics_cache", None) is None:
            self._metrics_cache = metrics_dict(
                self._prediction_hvos_array, self._gt_hvos_array,
                self._identifier)
        return {k: v for k, v in self._metrics_cache.items()
                if f"_{family}_" in k}

    def get_hits_accuracies(self, drum_mapping=ROLAND_REDUCED_MAPPING) -> dict:
        return self._family("Hits_Accuracy")

    def get_velocity_errors(self, drum_mapping=ROLAND_REDUCED_MAPPING) -> dict:
        return self._family("Velocity_MSE")

    def get_micro_timing_errors(self, drum_mapping=ROLAND_REDUCED_MAPPING) -> dict:
        return self._family("Micro_Timing_MSE")

    def get_rhythmic_distances(self) -> dict:
        from .metrics import rhythmic_distances

        return rhythmic_distances(
            self._prediction_hvos_array, self._gt_hvos_array, self._identifier)

    def get_gmd_ground_truth_hvo_sequences(self):
        return copy.deepcopy(self._gmd_gt_hvo_sequences)

    # -- media -----------------------------------------------------------------

    def get_wandb_logging_media(self, global_features_html=True,
                                recalculate_ground_truth=True, **kwargs) -> dict:
        media = {}
        pred_media = self.prediction_SubSet_Evaluator.get_wandb_logging_media(
            global_features_html=global_features_html,
            use_specific_samples_at=self.audio_sample_locations)
        gt_media = (self.gt_SubSet_Evaluator.get_wandb_logging_media(
            global_features_html=global_features_html,
            use_specific_samples_at=self.audio_sample_locations)
            if recalculate_ground_truth else {})
        for d in (gt_media, pred_media):
            for k, v in d.items():
                media.setdefault(k, {}).update(v)
        return media

    # -- persistence -----------------------------------------------------------

    def save_as_pickle(self, save_evaluator_path: str):
        out_dir = os.path.join(
            save_evaluator_path, "InfillingEvaluator_" + self.__version___)
        os.makedirs(out_dir, exist_ok=True)
        filename = os.path.join(
            out_dir,
            f"{self.dataset.dataset_name}_{self.dataset.split}_"
            f"{self.dataset.__version__}_evaluator.pickle")
        save_to_pickle(self, filename)
        return filename

    def dump(self, path: str):
        save_to_pickle(self, path)
        return path

    def __getstate__(self):
        # the device is the loader's (init_evaluator): a torch.device would
        # not load in the JAX package
        state = dict(self.__dict__)
        state.pop("_rng", None)
        state["device"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._rng = np.random.default_rng(0)


def init_evaluator(evaluator_path: str, device="cuda"):
    """Unpickle a preprocessed evaluator of either package onto ``device``
    (``"cuda"`` without CUDA raises): the device its dataset's pipeline
    computes on. The arrays stay on the host; the training driver and
    ``set_pred`` move them to the model's device."""
    ev = load_pickle(evaluator_path)
    ev.device = require_device(device, "init_evaluator")
    ev.dataset._device = ev.device
    return ev


def _make_media_pass(evaluator: InfillingEvaluator, epoch: int):
    """The media + feature-stats portion of ``log_eval`` as a self-contained
    closure, safe to run AFTER a later ``set_pred`` has replaced the
    evaluator's prediction state: everything it reads is captured eagerly —
    the per-epoch prediction SubSet evaluator (a fresh object graph each
    ``set_pred``), the prediction/GT stacks (replaced, never mutated), and the
    identifier. The training driver hands these closures to a background
    worker so media rendering overlaps the next epoch block."""
    ident = evaluator._identifier
    pred_ev = evaluator.prediction_SubSet_Evaluator
    locations = dict(evaluator.audio_sample_locations)
    gt_arr = evaluator._gt_hvos_array
    pred_arr = evaluator._prediction_hvos_array
    tags = list(evaluator._gt_hvos_array_tags)
    run = xlog.run
    run_dir = run.dir if run is not None else "."
    run_id = run.id if run is not None else "local"

    def media_pass():
        # ONE self-contained record per media pass (xlog.log_record): written
        # atomically WITHOUT touching the shared pending dict, so a deferred
        # pass running mid-block can't sweep the training thread's
        # uncommitted scalars into the wrong epoch's record
        record: dict = {"epoch": epoch}
        media = {}
        pred_media = pred_ev.get_wandb_logging_media(
            global_features_html=False, use_specific_samples_at=locations)
        for k, v in pred_media.items():
            media.setdefault(k, {}).update(v)
        if media:
            record[ident] = media
        from .features import features_table, INFILLING_DROP_COLUMNS

        csv_filename = os.path.join(run_dir, f"stats_{run_id}_Epoch_{epoch}.csv")
        table = features_table(gt_arr, pred_arr, tags)
        os.makedirs(os.path.dirname(csv_filename) or ".", exist_ok=True)
        table.to_csv(csv_filename)
        table = table.drop(columns=[c for c in INFILLING_DROP_COLUMNS if c in table.columns])
        table = table.dropna(axis=1)
        xlog.save(csv_filename, base_path=run_dir)
        record[ident + "_stats"] = xlog.Html(table.to_html())
        xlog.log_record(record)

    return media_pass


def log_eval(evaluator: InfillingEvaluator, model, log_media: bool, epoch: int,
             dump: bool, defer=None):
    """Per-epoch eval logging (the reference's ``log_eval``): scalar metric
    families every call; media + feature-stats CSV + evaluator dump when
    ``log_media``.

    ``defer``: optional callable receiving the media-pass closure instead of
    running it inline (the driver's async media worker). Ignored when real
    wandb is online — wandb's step counter needs in-order commits."""
    evaluator.set_pred(model)
    evaluator.gt_SubSet_Evaluator.epoch = epoch
    evaluator.prediction_SubSet_Evaluator.epoch = epoch

    acc_h = evaluator.get_hits_accuracies(ROLAND_REDUCED_MAPPING)
    mse_v = evaluator.get_velocity_errors(ROLAND_REDUCED_MAPPING)
    mse_o = evaluator.get_micro_timing_errors(ROLAND_REDUCED_MAPPING)
    xlog.log({**acc_h, **mse_v, **mse_o, "epoch": epoch}, commit=True)

    if log_media:
        media_pass = _make_media_pass(evaluator, epoch)
        if defer is not None and not xlog._wandb_online():
            defer(media_pass)
        else:
            media_pass()

        if dump:
            run = xlog.run
            run_name = run.name if run is not None else "local"
            evaluator.dump(
                os.path.join(
                    "evaluator",
                    f"evaluator_{evaluator._identifier}_run_{run_name}"
                    f"_Epoch_{epoch}.Eval"))
