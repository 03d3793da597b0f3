#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and audio front-end paths once
on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, each printing one JSON line (any failure raises; the exit code is
then non-zero):

1. device   the card (``nvidia-smi`` name and power limit), torch and CUDA
            versions; TF32 is switched off for matmuls and cuDNN.
2. build    ``csrc/fused_mha.cu``, ``csrc/layer_sm90.cu``,
            ``csrc/layer_wide_sm90.cu``, ``csrc/layer_attn_sm90.cu``,
            ``csrc/band_energies.cu``,
            ``csrc/device_synth.cu``, ``csrc/fused_ffn.cu`` and
            ``csrc/fused_ln.cu`` compiled from this checkout with nvcc,
            one process each, in parallel;
            ptxas' registers, spills, stack and static shared memory per
            entry, and the FFN and LN kernels' dynamic shared memory.
3. kernel   ``fused_mha`` against ``mha_reference`` on the card, at the
            serving shapes (B 1/8/32/512 × flagship H 2 hd 128 and demo H 4
            hd 8, T 32, causal off/on; f32 at atol 1e-5, bf16 at rtol 2e-2
            and atol 2e-2 · min(1, max|ref|), ``mha_tolerance``),
            contiguous and, at B 1 and 512, as the slices of a
            packed qkv and of q with a packed kv (no copies), one launch a
            call and the (B, T, H, hd) output layout; then timed, stream and
            device, beside its bound and
            ``torch.nn.functional.scaled_dot_product_attention`` on the same
            views (the library call for the same function; the port never
            calls it); also at the eval forwards' B 3,300 and 1,099 (phase 22),
            contiguous and packed qkv, timed at 3,300 in bf16; at the wide
            heads of one head, hd 384, 512 (a d 512 model), 768 and 1,024 (a
            d 1,024 model), B 1 and 512, contiguous and packed qkv, both
            dtypes, causal off/on, and timed at hd 512 and 1,024 (B 1 and
            512, packed qkv, both dtypes) beside SDPA on the same views.
            Past T 64 (the long route: ``attention.route``'s flash form on
            TMA and wgmma at hd ≤ 128 where TMA reads the views, else the
            scores in shared memory) checked at ``LONG_MHA_CASES`` (T 65 to
            the ceiling 2,048, 64 and 128 query rows an item, each bucket of
            the scores form's query rows a block, hd 5 on the scores form),
            each check's form and error recorded, a call past the ceiling
            refused naming it, and timed at T 128, 256 and 1,024 (B 1 and
            512, H 2, hd 128, packed qkv, both dtypes; the kernel's and SDPA's
            device times each from a CUDA graph of their calls; f32's bound at
            the split-TF32 rate its products run at) and at the eval forward's
            3,300 rows at T 128, each with its form. Phases 9, 12, 15 and 16
            record #1's launches by form (``attention.FORM_LAUNCHES``).
4. serve    ``InfillServer`` at the flagship width (configs/
            InfillingRandom_training.yaml: d 256, 2 heads, ff 512, 6 layers,
            16 in, 27 out; seeded random weights) on the card: the kernel's
            launch count over the direct requests is exactly 6 per forward
            chunk, and the answers match a ``use_kernel=False`` server on the
            same card and the plain path on the CPU; then again in bf16.
5. http     POST /infill, GET /healthz, a malformed body (400), and 8
            concurrent clients of a coalescing server against the direct path.
6. demo     the in-repo demo ``.Model`` (legacy: with the architecture
            flags) served through ``serve.main``, answering an
            ``hvo_input`` request like the CPU plain path.
7. latency  B = 1 p50/p99, in-process and over loopback HTTP, and rows/s
            with requests of one full bucket (32), kernel and plain attention
            in turns; where a B = 1 request's host and device time goes.
8. layer    the whole encoder layer through the chain of
            ``layer_sm90.cu``, bf16 and f32 (its products in split TF32),
            against ``encoder_layer_reference`` at the flagship shapes (d
            256, 2 heads, ff 512, T 32), B 32 and 512, dropout 0 and 0.30
            (the same Philox masks): y, the residuals, dx and the 12
            parameter grads (f32 1e-4, bf16 2e-2 · max; ReLU kinks by
            ``layer_flips``); two runs with one seed bit-identical; forward
            and backward timed against the twin (stream and device). Each
            dtype at B 32 and 512: every launch of the chain recorded and held
            to its plain version on the same inputs (bf16 2e-2, f32 1e-5 ·
            max each; the hidden product's ReLU decisions to ``kink_flips``
            in full), each launch's device time and own bound (f32 at 495/3
            TFLOP/s and at 67), at B 32 its plain version's and (bias
            products, plain products) one library call's time; the layer's
            bound from its own inputs, weights and outputs; and
            ``nn.TransformerEncoderLayer`` with the same weights, forward and
            autograd backward, in f32 with TF32 off (the library call for the
            whole layer; the port never calls it). The f32 chain's drift at ff
            512, 1,024, 2,048, 4,096 and 8,192 (d 256, B 32, 8 seeded inputs
            each): every launch within 1e-5 · max of its plain version
            wherever the gate admits the ff (``ops/fused_layer.py::
            F32_MAX_FF``). The chain's wide route (d past 256: 16 launches,
            the LayerNorm epilogues' three as a product and a row pass each)
            at B 32, both dtypes, rate 0.30, at d 512 with 4 heads / ff 1,024,
            d 1,024 with one head of 1,024 / ff 1,024 (the attention streams
            the head), d 2,048 with 2 heads / ff 1,024 (the row passes a block
            a row), d 512 with one head / ff 512 and d 1,280 with 5 heads / ff
            1,024: two runs bit-identical, the layer against its twin, every
            launch held to its plain version (bf16 2e-2, f32 1e-5 · max,
            ``kink_flips``); at d 1,024 every launch timed with the layer's
            bound and ``nn.TransformerEncoderLayer``, at d 2,048 the
            attention's and the row passes' launches, their plain versions
            and ``nn.TransformerEncoderLayer`` on the stream. The same at the
            flagship width in 8- and 16-bar loops (``LONG_SHAPES``: T 128,
            every launch timed; T 256, the attention's and the row passes'
            device times from a CUDA graph, their plain versions and
            ``nn.TransformerEncoderLayer`` on the stream).
9. train    ``initialize_model`` + ``train_loop`` with the flagship YAML's
            hyperparameters (written here: the card's machine has no pyyaml;
            a CPU test holds them to the file) on seeded synthetic loops:
            the loss falls, every step launches each bf16 launch of the
            layer chain once per layer and the f32 chain never (launches
            per step by kernel); the same with ``fused_layer=False``; 3 f32
            steps at dropout 0 through the f32 chain against the plain
            paths on the card and on the CPU;
            training throughput at batch 32 and 512 and where a step's
            device time goes; f32 (``bf16: false``) seqs/s of the f32 chain
            and ``fused_layer=False`` in 3 pairs of turns at batch 32 and
            512, no profiler in the timed epochs (the numbers behind
            ``LAYER_KERNEL_MAX_BATCH[torch.float32]``); the wide route in
            training: d 1,024 with one head of 1,024 and ff 1,024 (6 layers)
            and the chain forced, 4 bf16 steps and 2 f32 steps, each with its
            held-out loss through #1 at hd 1,024, every launch of the route
            once a layer and step; its f32 weights carried through the JAX
            layout to ``InfillServer``, a B 1 request and a bucket of 32
            through #1 at hd 1,024 against the CPU plain path; the sweep
            files' draw d 512 / 1 head on #1 in an eval forward and in the
            vmapped ranking forward of 4 trials; d 512 / 4 heads / ff 1,024,
            the chain against ``fused_layer=False`` in 3 pairs of turns, each
            dtype at batch 32 and 512 (the numbers behind
            ``LAYER_KERNEL_MAX_D``); 8-bar loops (``long_training``): the
            flagship at ``max_len`` 128, the chain given, 4 bf16 and 2 f32
            steps with held-out losses through #1, its f32 weights served at
            T 128 (B 1 and 32, MSO input and ``hvo_input``), and the chain
            against ``fused_layer=False`` in 3 pairs of turns at batch 32 in
            each dtype (the numbers behind ``LAYER_KERNEL_LONG_T``); the
            trained weights served by ``InfillServer``.
10. front-end kernels  ``device_synth`` against its plain version bit for
            bit, and ``band_energies_from_audio`` (framing inside the kernel)
            against its plain version on kit renders (bar 1e-4 · max|ref|: an
            f32 FFT against dense f32 products), at M 1, 64 and 256 × 90/120/
            150 bpm and at the shapes phases 12 and 13 give them (1 loop at 90
            bpm, 6 at 120, 40 at 150; 256 loops at phase 13's own tempos);
            the frames entry ``band_energies`` at N 1, 417, 418, 26,752 and
            140,544; reruns bit-identical; each timed on the stream and the
            device beside its plain version, its bound and the library routes
            (framing + ``torch.fft.rfft`` + abs + matmul from the same
            waveform, ``torch.stft``, the ``"conv"`` method; one
            ``index_add_`` over prepared indices for the synthesizer, on the
            stream and the device), the synthesizer at M 1, 64 and 256 with
            its tile, grid, dynamic shared memory and each instance's
            registers.
11. front end  64 seeded loops at mixed tempos, grids → MSO on the card by
            the kernel route against the plain route on the card and the host
            route (numpy mixer + ``"fft"`` on the CPU), at atol 2e-5 · max,
            rtol 1e-3; each kernel launched once per chunk; loops/s by chunk
            size and method.
12. serve hvo_input  the flagship-width server answers partial grids with
            ``qpm`` 90/120/150 in process and over HTTP through kernels #6,
            #7 and #1 (launch counts), within 1e-4 of the plain path on the
            CPU; B = 1 latency of an ``hvo_input`` request beside an
            MSO-input request, and the front end / model split.
13. train with audio augment  the flagship config through ``make_epoch_fn``
            with ``make_on_device_augment(mode="audio")`` on 256 loops: every
            kernel launched the expected number of times, one augment call
            equal to the same call through the plain versions, the loss finite
            and falling, seqs/s beside the un-augmented epoch.
14. decoder layer  the whole decoder layer (the chain of ``layer_sm90.cu``,
            bf16 and f32) against ``decoder_layer_reference`` at the flagship
            shapes, B 32 and 512, f32 and bf16, dropout 0 and 0.30: y3, the 7
            residuals, dx, dmem and the 20 parameter grads (phase 8's bars);
            reruns bit-identical; forward and backward timed against the
            twin; in each dtype every launch held to its plain version and
            timed, the layer's own bound and ``nn.TransformerDecoderLayer``,
            the f32 chain's drift over ff, the wide route (26 launches) and
            the 8- and 16-bar loops (causal self-attention and
            cross-attention over T 128 and 256), as phase 8.
15. train encoder-decoder  the 6 + 6 layer model at the flagship width
            (scripts/bench_encdec.py's) through ``initialize_model`` +
            ``train_loop(encoder_only=0)``: every step launches each encoder
            and each decoder bf16 launch 6 times (launches per step by
            kernel), the loss falls; the same with both fused switches off; 3
            f32 steps at dropout 0 through the f32 chains and
            ``make_epoch_fn(encoder_only=False)`` against the twin path and
            the unfused path; seqs/s at batch 32 and 512, kernel path and
            unfused path in turns; where a step's device time goes; f32
            seqs/s of both f32 chains and both switches off in 3 pairs of
            turns at batch 32 and 512; the wide route as phase 9 (the d 1,024
            / 1 head model at 2 + 2 layers, cut from 6 + 6; the turns at 2 +
            2, both switches against both off), and the 8-bar loops as phase
            9 (6 + 6 at ``max_len`` 128, 18 #1 launches a served chunk; the
            turns on 128 loops, 4 steps a turn).
16. serve encoder-decoder  ``InfillServer`` over the same config: 18
            ``fused_mha`` launches per forward chunk (6 encoder, 6 causal
            decoder self-, 6 decoder cross-attentions), answers within 1e-4
            of the CPU plain path, one ``hvo_input`` request through kernels
            #6, #7 and #1, B = 1 latency beside the encoder-only server's.
17. ffn and ln kernels  the fused FFN kernels (``fused_ffn.cu``; bf16: the
            two forward products, the two row-backward products, the weight
            gradients and the reduce of their row splits on the tensor cores;
            f32: the CUDA-core forward, row backward and weight gradients)
            against ``ffn_reference`` and the fused dropout + add + LayerNorm
            kernels (``fused_ln.cu``: forward, backward) against
            ``dropout_add_layernorm_reference``, at rows 1,024 and 16,384 × d
            256 × ff 2048, rows 4,096 × d 1024 × ff 4096 and a ragged 100 × 72
            × 200, f32 and bf16, rate 0 and the config's (0.16 / 0.1) with the
            same masks (phase 8's bars); each mask's realised keep rate; reruns
            bit-identical; each call timed beside its plain version, the
            library composition (``F.linear``, relu, ``F.dropout``,
            ``F.linear``; ``F.layer_norm(x + F.dropout(y))``; autograd's
            backward; the LN's also on the device) and its bound, each
            kernel's device time per launch; an LN backward is one launch
            (dscale and dbias summed inside it); the LN kernels' registers,
            shared memory and grids.
18. train wide FFN  configs/InfillingRandomLow_lm_training.yaml (d 256, ff
            2048, 8 layers, dropout 0.16; written here, held to the file by a
            CPU test) through ``initialize_model`` + ``train_loop`` with
            ``fused_ffn`` given (auto leaves it off) and the unfused layers
            (``fused_layer`` given off; the bf16 gate admits ff 2048): every step
            launches each bf16 FFN kernel 8 times (the reduce too: the weight
            gradients split the rows in two), the loss falls; with
            ``fused_dropout_ln`` 16 + 16 LN launches a step, and a step's device
            launches with them (one ``ln_bwd`` a backward site); with ``remat`` 16
            launches of each FFN forward kernel a step, one step's gradients
            equal to the un-rematerialised step's, peak memory with and without at batch
            512; 3 f32 steps at dropout 0 against the plain-version path and
            ``fused_ffn=False``; a 1 + 1 layer encoder-decoder model at the
            same width (1 + 1 FFN and 2 + 3 LN launches a step); seqs/s at
            batch 32 and 512 with ``fused_ffn`` on and off, with the LN kernels,
            with remat with and without ``fused_ffn``, and with
            ``fused_layer`` given (the whole-layer chains), in turns; where a
            step's device time goes.
19. train GrooveXL  d 1024, 8 heads, ff 4096, 12 layers, dropout 0.1, batch
            128, bf16, remat on (scripts/bench_groovexl_ffn.py's; nothing cut
            but the number of steps) through ``make_epoch_fn``: 24 launches of
            each FFN forward kernel a step under remat (no reduce: the weight
            gradients' 256 tiles fill the card), the loss finite and falling,
            peak memory with and without remat, seqs/s with ``fused_ffn`` on
            (given: auto leaves it off) and off under remat and without, two
            epochs a turn, and their ratio in each turn.

20. save, resume, serve  ``run_training`` with the flagship YAML (read on
            the card by the port's YAML reader) on 512 seeded loops rendered by
            the audio augment inside every epoch (kernels #2's bf16 chain, #6,
            #7; launches counted), 4 epochs in blocks of 1, a snapshot save
            after each, watch histograms every 32 steps, ``metrics.jsonl``;
            2 epochs, a stop, a fresh ``initialize_model(load_model=...)`` and
            2 more, equal bit for bit to the uninterrupted run in parameters
            and the last block's metrics, and Adam 1 + 1 against 2 likewise;
            ``serve.main(["--ckpt", dir])`` with no architecture flags answers
            an MSO and an ``hvo_input`` request (#1 six times a forward, #6,
            #7) equal to a server on the in-memory weights, and the loaded
            weights served in f32 within 1e-4 of the CPU plain path; the
            ``.ckpt`` size, the seconds a save holds the training thread,
            synchronous against snapshot, the save worker's seconds and the
            restore's, at the flagship and at GrooveXL width (151 M
            parameters, freshly initialised), beside the card's name and
            power limit. Checkpoints go to a temporary directory.
21. command lines  as a user runs them, each in a child process that
            writes its kernels' launch counts when it exits, all under a
            temporary directory: ``python -m
            transformergrooveinfilling_tpu_torch.process_dataset
            --experiments InfillingRandom`` at the default synthetic sizes
            (3,300 / 1,100 / 1,100 items) on the card (#6, #7), beside the
            same build of the validation split with ``--device cpu``
            (outputs and indices bit for bit, 64 MSO inputs within atol
            1e-5 · max and rtol 1e-4); ``python -m
            transformergrooveinfilling_tpu_torch.train --config
            configs/InfillingRandom_training.yaml --wandb False --eval_train
            False`` at the flagship width, nothing cut, for a few blocks
            (``--max_wall_s``) each with ``--streaming off``, ``host``
            (``--regen_cadence auto``) and ``fused``, the build and these
            three one after another in one child process (its start read
            apart): #2's bf16 chain in every
            run, #6 and #7 in the streaming ones, the loss finite and falling,
            seqs/s per block; the fused run resumes the off run's newest
            ``.ckpt`` (``--load_model``) at its epoch + 1 under
            ``TGI_PROFILE=1``, and its trace of the first block names #2's,
            #6's and #7's kernels; one
            host generation and one fused render of the train split timed in
            process, with their launches.
22. evaluation  on phase 21's datasets, the command lines in child
            processes as there (the card's evaluators and the training with
            them one after the other in one): ``python -m
            transformergrooveinfilling_tpu_torch.process_evaluator
            --experiments InfillingRandom --splits train validation`` on the
            card (#6, #7) beside the validation evaluator built with
            ``--device cpu`` (tags, indices and GT arrays bit for bit, MSO
            inputs within atol 1e-5 · max, rtol 1e-4, a row where the host
            route moves an onset by a sample held to the device route's plain
            versions on the CPU instead); ``train --config
            configs/InfillingRandom_training.yaml`` with the evaluator flags
            at their defaults for a few blocks: both sets' held-out losses
            every block and metric families every evaluated block, epoch 0's
            media (piano rolls, heatmaps, audio, stats CSV), no held error of
            the media worker, #1 six launches a forward of the eval passes,
            #2's chain in training; ``evaluate`` of the last evaluated
            ``.ckpt`` on the card (families equal to the run's within 1e-6)
            and with ``--device cpu``, the weights in f32 on the card against
            the CPU by ``hit_agreement``; a scalar-only eval pass and a media
            pass timed in process, with their launches.
23. MIDI and SoundFont kits  under a temporary directory (~60 s): three
            ``.sf2`` kits written by ``write_minimal_sf2`` (the procedural kit
            exported; three velocity layers a voice with attenuation, a lowpass
            and a volume envelope; a looped, panned kit with a filter sweep),
            #6 on their packed 45-row table at M 1, 64 and 256 against its
            plain version bit for bit, timed beside its bound and one
            ``index_add_``, with the table's padded and true bytes; the front
            end with a kit an item against its plain versions on the CPU (atol
            2e-5 · max, rtol 1e-3); a MIDI archive of the synthetic corpus
            (165 / 55 / 55 loops) through ``gmd_to_processed_tree``,
            ``process_dataset --source <tree> --params-json`` (the kits'
            directory as ``sf_path``) and ``train --streaming fused`` for 2
            blocks (the flagship YAML with its epochs cut to 2), one after
            the other in a child process (#2, #6, #7 counted); ``infill_from_hvo(...,
            sf_path=kit)`` on the flagship server against the CPU plain path,
            its B = 1 p50/p99 and its first request apart; an HTTP ``"format":
            "midi"`` reply parsed back to its hits; a body naming ``sf_path``
            answered 400.
24. serving artifacts  (``export.py``) the flagship server's weights and
            the 6 + 6 model exported (buckets 1/8/32, traced on the CPU) and
            loaded on the card: each within 1e-5 of ``InfillServer`` and 1e-4
            of the CPU plain path (hits by ``hit_agreement``), #1 launched 6
            (18) times a chunk by the programs' ``tgi::fused_mha``;
            ``InfillServer.from_exported`` answering a B = 1 ``hvo_input``
            through #6, #7 and #1; in child processes, ``serve --artifact``
            over HTTP, ``evaluate --artifact`` of phase 22's checkpoint (its
            families equal to ``evaluate --ckpt``'s within 1e-6) and ``python
            -m transformergrooveinfilling_tpu_torch.tutorial`` on the card;
            export and load seconds, artifact and ``params.msgpack`` bytes,
            B = 1 p50/p99 of the program beside the server.
25. batched sweeps  (``train/vmap_sweep.py``, ``sweep.py``) on phase 21's
            datasets: one group of 8 trials at the flagship width (learning
            rate, penalty and dropout drawn from
            configs/InfillingRandom_sweep.yaml; one lr 0) trained 1 SGD epoch
            by ``make_batched_sweep_fn`` (losses finite and distinct, the lr-0
            trial's weights bit for bit); ``stacked_eval_loss`` through #1's
            vmap rule (6 launches a stacked forward for the 8 trials, each
            trial's loss at the dtype's bar of its eager forward) and the
            folded launch at (K·B, 2, 32, 128) against its plain version
            (phase 3's bars); the sweep command line in child processes,
            ``--batched --count 5`` with the flagship's architecture pinned
            (one vmapped group), ``--batched --count 3`` on
            configs/InfillingRandom_sweep.yaml as it stands (groups of one,
            each through the regular step and #2's chain) and ``--count 1``
            (``train`` with #2 and, in its final eval, #1), no trial failed;
            then, the card to itself, the folded launch timed beside SDPA
            and trial·seqs/s at K 1, 2, 4, 5 and 8 beside one trial through
            ``make_epoch_fn`` (#2's chain); the phase's seconds.
26. multi-GPU training  (``parallel/``) with every rank a process of this
            script on the one card (``--parallel-rank``; NCCL refuses two
            ranks on one device, so a group of several ranks runs gloo with
            its tensors staged through pinned host memory): #1 at one head
            of width 128 held to its plain version; (a) one rank over NCCL,
            ``run_training(plan=make_mesh())`` bit for bit as ``plan=None``
            (flagship, bf16, batch 32, 2 epochs, #2's chain); (b) dp 2 at
            the flagship in bf16, global batch 64, #2's chain on every rank:
            at rate 0 two global batches held to one process's chain (2e-2 ·
            max over the parameters), at rate 0.30 the loss falls over 4
            epochs; (c) tp 2 in f32: the eval forward (#1 on one head a
            rank) within 1e-5 · max of one process's, 3 SGD steps within
            5e-5; (d) dp 2 × pp 2 at GrooveXL's width (4 of its 12 layers)
            in bf16, 4 microbatches, ``fused_ffn`` given: the deterministic pipelined
            forward (#1 in the stages) within 2e-2 · max of the plain model,
            3 training steps (#4 in the stages); (e) pp 2 × tp 2, flagship,
            f32: the forward within 2e-5 · max; (f) ``train
            --n_model_shards 2`` started with the JAX package's names and
            ``train --pp_stages 2`` with torchrun's, side by side on phase
            21's datasets for a few blocks, and the tensor-parallel run's newest ``.ckpt``
            resumed in one process for an epoch (#2) and served (#1). Each
            leg prints its backend and transport, seconds, seqs/s and launches
            per rank; ranks share the card, so none of these is a scaling
            figure.

27. training kernels under vmap  #2-#5 through their operators' vmap rules
            (``ops/per_trial.py``): (a) each wrapper, bf16 and f32, rate
            0.30, under ``vmap(grad_and_value(...), randomness="different")``
            at K 4 (#2 at the flagship width, B 32; #3 at the 6 + 6 model's;
            #4 and #5 at the lm config's, rows 1,024, ff 2,048) bit for bit
            4 unbatched calls with each trial's seed, 4 × a call's launches,
            each trial within phase 8's bars of its plain version, both
            timed once (c) has ended; (b) ``make_batched_sweep_fn`` at K 5
            and 8, batch 32, rate 0.30, on phase 21's train split: the
            flagship with ``fused_layer=1``, the 6 + 6 model with
            ``fused_layer=1, fused_decoder_layer=1``, the lm config with
            ``fused_ffn=1, fused_dropout_ln=1``: launches a step K × one
            trial's through ``make_epoch_fn``, each trial's full-set loss
            lower after its turn, trial·seqs/s beside the switches off (phase
            25's plain vmapped step) and one trial through ``make_epoch_fn``;
            each group in f32 at rate 0, K 5, 3 steps, within phase 8's twin
            bar (1e-4) of each trial alone through ``make_train_step`` and
            the same kernels, both beside the switches off from the same
            init; (c) ``sweep --batched --count 5`` on
            configs/InfillingRandom_sweep.yaml with the flagship's
            architecture, rate 0.30 and ``fused_layer: 1`` pinned: one
            vmapped group, #2's chain 5 × 6 layers × 104 steps. The kernels
            line gains each kernel's ``vmap`` route.
28. remat under vmap  each layer of a batched group recomputed in the
            backward under ``torch.func`` (``models/transformer.py::
            _LayerRemat``): (a) GrooveXL (d 1024, 8 heads, ff 4096, 12
            layers, batch 128, bf16, rate 0.1, SGD) at K 8 without remat,
            with ``remat=1`` and with ``"dots"``, from one init: the peak
            allocated bytes of a step, trial·seqs/s over 3 steps, the final
            parameters bit for bit against remat off, the peaks with remat
            below the one without; (b) phase 27's three groups at K 5, 3
            steps with ``remat=1``: bit for bit the same group without remat,
            each forward launch of #2-#5 twice a layer and trial; (c)
            ``sweep --batched --count 5 --epochs 1`` at the flagship's
            architecture with ``remat: 1`` pinned, and with remat unset and
            ``TGI_HBM_BYTES`` set so that auto remat engages for 5 stacked
            trials and not for 1: each one vmapped group under remat, 5
            trials ranked, #1 launched 6 times. The kernels line gains #2-#5's
            ``launches_per_batched_remat_step``.

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from transformergrooveinfilling_tpu_torch import serve
from transformergrooveinfilling_tpu_torch.models import (
    GrooveTransformerConfig, build_model, calculate_loss, predict, transformer,
)
from transformergrooveinfilling_tpu_torch.models.torch_compat import (
    load_legacy_checkpoint,
)
from transformergrooveinfilling_tpu_torch.ops import _build
from transformergrooveinfilling_tpu_torch.ops import attention
from transformergrooveinfilling_tpu_torch.ops.attention import (
    fused_mha, mha_reference,
)
from transformergrooveinfilling_tpu_torch.data import make_on_device_augment
from transformergrooveinfilling_tpu_torch.ops import band_energies as be
from transformergrooveinfilling_tpu_torch.ops import device_synth as ds
from transformergrooveinfilling_tpu_torch.ops import fused_decoder_layer as fdl
from transformergrooveinfilling_tpu_torch.ops import fused_ffn as ffn
from transformergrooveinfilling_tpu_torch.ops import fused_layer as fl
from transformergrooveinfilling_tpu_torch.ops import fused_ln as ln
from transformergrooveinfilling_tpu_torch.ops import layer_sm90
from transformergrooveinfilling_tpu_torch.ops import mso
from transformergrooveinfilling_tpu_torch.ops.dropout import (
    quantized_keep_rate, quantized_threshold,
)
from transformergrooveinfilling_tpu_torch.train import (
    HyperParams, checkpoint as ckpt, create_train_state, eval_log_freq, initialize_model,
    TrainState, load_hyperparameters, make_epoch_fn, make_train_step, run_training, train_loop,
)
from transformergrooveinfilling_tpu_torch.models import torch_compat
from transformergrooveinfilling_tpu_torch.train.driver import _GracefulStop
from transformergrooveinfilling_tpu_torch.train.loop import fetch
from transformergrooveinfilling_tpu_torch.utils import logging as xlog
from transformergrooveinfilling_tpu_torch.utils import yaml_subset
from transformergrooveinfilling_tpu_torch.train.config import (
    embedding_size_src_for, resolve_fused_decoder_layer, resolve_fused_ffn, resolve_fused_layer,
    resolve_remat,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = GrooveTransformerConfig(  # configs/InfillingRandom_training.yaml
    d_model=256, n_heads=2, dim_feedforward=512, dropout=0.30,
    num_encoder_layers=6, embedding_size_src=16)
DEMO_FLAGS = ["--d_model", "32", "--n_heads", "4", "--dim_feedforward", "512",
              "--num_encoder_layers", "6", "--embedding_size_src", "27"]
DEMO_MODEL = "demo/transformer_run_demo_Epoch_799.Model"
BUCKETS = (1, 8, 32)
KERNEL_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/fused_mha.cu"
TPU_KERNEL = "transformergrooveinfilling_tpu/ops/attention.py:25"
LAYER_SM90_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/layer_sm90.cu"
LAYER_WIDE_SOURCE = f"transformergrooveinfilling_tpu_torch/csrc/{layer_sm90.WIDE_SOURCE}.cu"
LAYER_ATTN_SOURCE = f"transformergrooveinfilling_tpu_torch/csrc/{layer_sm90.ATTN_SOURCE}.cu"
# the chains' attention past T 32 in bf16 (the registers form), launched from
# LAYER_ATTN_SOURCE's entry points, and the Pallas code it stands in for
LAYER_REGS_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/attn_regs_sm90.cuh"
REGS_TPU_KERNELS = {
    "fwd": "transformergrooveinfilling_tpu/ops/fused_layer.py:143 (_block_diag_softmax, "
           "in _fwd_kernel :184-204; fused_decoder_layer.py:402 _fwd_call)",
    "bwd": "transformergrooveinfilling_tpu/ops/fused_layer.py:236 (_bwd_kernel, softmax "
           "again :318; fused_decoder_layer.py:475 _bwd_call)"}
# the Pallas kernel bodies a layer chain's forward and backward launches stand in for
LAYER_TPU_KERNELS = {"fwd": "transformergrooveinfilling_tpu/ops/fused_layer.py:164",
                     "bwd": "transformergrooveinfilling_tpu/ops/fused_layer.py:236"}
# configs/InfillingRandom_training.yaml, written out (the card's machine has
# no pyyaml); tests/test_torch_train.py holds it to the file
FLAGSHIP_HP = {
    "experiment": "InfillingRandom", "batch_size": 32, "d_model": 256,
    "dim_feedforward": 512, "dropout": 0.30, "optimizer_algorithm": "sgd",
    "learning_rate": 0.089, "n_heads": 2, "num_encoder_decoder_layers": 6,
    "epochs": 500, "encoder_only": 1, "hit_loss_penalty": 0.73, "load_model": None,
}
# configs/InfillingRandomLow_lm_training.yaml, written out likewise;
# tests/test_torch_remat.py holds it to the file
LM_HP = {
    "experiment": "InfillingRandomLow", "batch_size": 32, "d_model": 256,
    "dim_feedforward": 2048, "dropout": 0.16, "optimizer_algorithm": "sgd",
    "learning_rate": 0.070, "n_heads": 2, "num_encoder_decoder_layers": 8,
    "epochs": 3000, "encoder_only": 1, "hit_loss_penalty": 0.46, "load_model": None,
}
LAYER_SHAPE = dict(d=256, h=2, ff=512, t=32)  # the flagship's encoder and decoder layers
# the encoder-decoder family at the width the JAX package benchmarks it at
# (scripts/bench_encdec.py): the flagship's hyperparameters with 6 + 6 layers
ENCDEC = dataclasses.replace(FLAGSHIP, num_decoder_layers=6)
ENCDEC_LAYERS = 6
BAND_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/band_energies.cu"
BAND_TPU_KERNEL = "transformergrooveinfilling_tpu/ops/mso_pallas.py:56"
SYNTH_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/device_synth.cu"
SYNTH_TPU_KERNEL = "transformergrooveinfilling_tpu/ops/device_synth.py:140"
DEC_TPU_KERNELS = {"fwd": "transformergrooveinfilling_tpu/ops/fused_decoder_layer.py:160",
                   "bwd": "transformergrooveinfilling_tpu/ops/fused_decoder_layer.py:236"}
FFN_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/fused_ffn.cu"
FFN_TPU_KERNELS = {  # the Pallas kernel bodies each CUDA kernel stands in for
    f"fused_ffn_{name}{suffix}": "transformergrooveinfilling_tpu/ops/fused_ffn.py:"
                                 + ("138" if name.startswith("fwd") else "83")  # and :63
    for name, _ in ffn.LAUNCHES for suffix in ("", "_f32")}
# what each FFN launch type is called in a profile: the products are one
# template, told apart by their epilogues (a timing row holds one dtype's)
FFN_DEVICE_NAMES = {
    f"fused_ffn_{name}{suffix}": (epi,)
    for (name, _), epi in zip(ffn.LAUNCHES, ("EpiHidden", "EpiOut", "EpiDh", "EpiRound",
                                             "EpiWgrad", "reduce_splits"))
    for suffix in ("", "_f32")}
LN_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/fused_ln.cu"
LN_TPU_KERNELS = {"fused_ln_fwd": "transformergrooveinfilling_tpu/ops/fused_ln.py:54",
                  "fused_ln_bwd": "transformergrooveinfilling_tpu/ops/fused_ln.py:68"}
KERNEL_NAMES = ["fused_mha", "layer_sm90", layer_sm90.WIDE_SOURCE, layer_sm90.ATTN_SOURCE,
                "band_energies", "device_synth", "fused_ffn", "fused_ln"]
# the wrappers, and the counts of launches of their kernels
BAND, BAND_AUDIO, SYNTH = be.band_energies, be.band_energies_from_audio, ds.synth_events
MHA, BAND_K, SYNTH_K = attention.KERNEL, be.KERNEL, ds.KERNEL
# NVIDIA's published peaks for one H100 SXM, dense, at its 700 W limit; an f32
# product on the tensor cores in split TF32 is three TF32 products (495 / 3)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
THROUGHPUT_BATCHES = (32, 512)  # the YAML's batch and bench.py's
F32_PAIRS = 3  # paired f32 turns (chain, unfused, back to back) a batch in phases 9 and 15
# 3 f32 steps, kernel path against the unfused plain path (cuBLAS), which
# cannot be given the kernel's side of a ReLU kink: one such unit in the first
# step moved a W1 row by 1.2e-4 on an H100, and the bar is about four times that
UNFUSED_BAR = 5e-4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a, b) -> float:
    return float((torch.as_tensor(a).float() - torch.as_tensor(b).float()).abs().max())


def time_us(fn, n: int = 200, warm: int = 10) -> float:
    """Mean µs per call on the stream, by CUDA events over ``n`` calls after
    ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1000.0 / n


def device_us(fn, n: int = 50) -> dict:
    """Device time per call from the profiler, by kernel (or copy) name:
    ``{name: [µs per call, launches per call]}``, device-side events only,
    without the profiler's own buffer requests. The profiler can lose the
    device events of some calls (on an H100 it kept 4 to 8 of 10 calls of a
    2 ms kernel, and 2 of 3 without the calls run inside it first), so read
    the launches per call beside the time. Only events that start inside the
    marked window are counted. The events are read as the profiler recorded
    them: ``prof.events()`` gives the same times, but building its list takes
    9 s for two training steps of the wide config (95,000 records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with record_function("chip_smoke_window"):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    window = next(e for e in events if e.name() == "chip_smoke_window")
    first, last = window.start_ns(), window.start_ns() + window.duration_ns()
    per_kernel: dict = {}
    for e in events:
        name = e.name()
        if (e.device_type() == DeviceType.CUDA and name != "Activity Buffer Request"
                and name != "chip_smoke_window" and first <= e.start_ns() <= last):
            # short names that keep a template's arguments (the FFN's products
            # differ in their epilogue, the last one)
            key = name.removeprefix("void ").replace("(anonymous namespace)::", "")[:80]
            us, count = per_kernel.get(key, (0.0, 0.0))
            per_kernel[key] = (us + e.duration_ns() / 1e3 / n, count + 1 / n)
    return per_kernel


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """ms per call of ``fn`` replayed from one CUDA graph of ``n`` calls: the
    device's time without the host's launches, plus the graph's gaps between
    its kernels. It needs no profiler, which can lose every device event of a
    call (phase 23 on an H100: 0 of 10 captured)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (n * reps)


def host_us(fn, n: int = 200) -> float:
    """Host-clock µs per call of ``fn`` followed by a device synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def bound(n_bytes: float, flops: float, dtype: str) -> dict:
    """The least time the card could take: the larger of the bytes (each input
    read once, each output written once) over the memory rate and the
    operations over the peak rate for the inputs' type."""
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_flops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": int(n_bytes), "flops": int(flops)}


def mha_bound(b, h, t, hd, dtype) -> dict:
    """#1's bound: q, k, v read and o written once, QKᵀ and PV over every
    (query, key) pair; f32 at the split-TF32 rate its products run at, with
    the CUDA cores' rate beside it (``op_bounds``)."""
    size = 4 if dtype == "float32" else 2
    return op_bounds(4 * b * h * t * hd * size, 4 * b * h * t * t * hd, dtype)


def attn_pairs(rows: int, t: int, causal: bool) -> int:
    """The (query, key) pairs an attention over ``rows`` rows in sequences of
    ``t`` computes: t a row, (t + 1) / 2 a row where it is causal (row i
    attends to keys 0..i)."""
    return rows * (t + 1) // 2 if causal else rows * t


def layer_io_bounds(b: int, decoder: bool = False, dtype: str = "bfloat16",
                    shape: dict = LAYER_SHAPE) -> dict:
    """The least time for a whole layer's forward and for its backward at the
    flagship layer, batch ``b``, from the function's own inputs, weights and
    outputs alone (no residual, no design's scratch): the forward reads x
    (and the decoder's memory), the weights and vectors and writes y; the
    backward reads dy, x (and memory), the weights and the LayerNorm gains and
    writes dx (and dmem) and the f32 parameter gradients. Its operations: the
    dense products (forward once, backward twice) and per attention QKᵀ and
    PV forward, dP, dV, dQ and dK backward, the causal one over its T(T+1)/2
    pairs only; in ``dtype`` bf16 at the bf16 peak, float32 at the split-TF32
    rate (the bound) and at the CUDA cores' 67 TFLOP/s (``at_67``). ``shape``:
    another layer's d, ff and t."""
    d, ff, t = shape["d"], shape["ff"], shape["t"]
    m, s = b * t, 4 if dtype == "float32" else 2
    if decoder:
        weights, vectors, acts = 8 * d * d + 2 * d * ff, 15 * d + ff, 2
        pairs = attn_pairs(m, t, True) + attn_pairs(m, t, False)
    else:
        weights, vectors, acts = 4 * d * d + 2 * d * ff, 9 * d + ff, 1
        pairs = attn_pairs(m, t, False)
    products = 2 * m * weights
    fwd = (acts * m * d * s + weights * s + vectors * 4 + m * d * s, products + 4 * pairs * d)
    bwd = (m * d * s + acts * m * d * s + weights * s + 3 * d * 4 + acts * m * d * s
           + (weights + vectors) * 4, 2 * products + 8 * pairs * d)
    return {k: op_bounds(n_bytes, flops, dtype) for k, (n_bytes, flops) in
            (("fwd", fwd), ("bwd", bwd))}


def op_bounds(n_bytes: float, flops: float, dtype: str) -> dict:
    """``bound`` for products in ``dtype``: bf16 at its peak; float32 at the
    split-TF32 rate, with the bound at the CUDA cores' f32 rate beside it
    (``at_67``)."""
    if dtype != "float32":
        return bound(n_bytes, flops, dtype)
    return {**bound(n_bytes, flops, "tf32x3"),
            "at_67": bound(n_bytes, flops, "float32")["bound_ms"]}


# each launch of a layer chain against its plain version on the same inputs,
# · max|ref|: bf16 rounds where the plain version rounds, in another order;
# an f32 split-TF32 product is within ~2⁻²² of each term of the f32 product
# (a ReLU decision at the kink moves a unit within KINK_BAND[f32] · max|h|)
SM90_BAR = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# The share of a bf16 whole layer's hidden units (plus 4) that may fall on the
# other side of the ReLU's kink from its twin's (``layer_flips``)
LAYER_KINK_SHARE = 1e-4
KINK_SEEDS = 4  # further inputs and seeds a rate at which phases 8 and 14 read the flips


def layer_flips(twin_h, kernel_h, share: float = LAYER_KINK_SHARE):
    """The hidden units at which a whole layer's kernels and its twin fall on
    opposite sides of the ReLU's kink, for the twin's ``relu_flips``. f32:
    ``kink_flips`` (within ``KINK_BAND`` of 0, at most ``KINK_SHARE`` of the
    units). bf16: each within ``KINK_BAND`` of 0 as well, and at most
    ``share`` of the units (plus 4; ``LAYER_KINK_SHARE``, at the wide route's
    d 512 ``fl.WIDE_KINK_SHARE``). ``KINK_SHARE`` itself is held
    where the kernel decides the side, the hidden product against its plain
    version on the same inputs (``sm90_launches``: 0–1 flips in 8.4M units),
    and not across the whole layer: there the tensor cores' f32 accumulation
    order, not cuBLAS's sequential one, rounds ~1.4e-4 of qkv's bf16 values to
    the neighbouring value, and the bf16 rounding of P carries each to ~15
    attention outputs, so inputs of W1 differ by one bf16 step (on an H100:
    101–173 flips in 8.4M units at the encoder at B 512, 248–380 at the
    decoder, 30 in 524,288 at the decoder at B 32, at most 5.7e-5 of the
    units, each within 1.8e-3 of max|h|)."""
    if twin_h.dtype == torch.float32:
        return fl.kink_flips(twin_h, kernel_h)
    return fl.kink_flips(twin_h, kernel_h, share)


def kink_survey(dev, decoder: bool) -> dict:
    """A bf16 whole layer's ReLU flips against its twin at ``KINK_SEEDS``
    further inputs and dropout seeds a rate, at B 32 and 512, rates 0 and
    0.3, forward only, each held by ``layer_flips``: per batch, the flips of
    each case, the largest share of the units and the largest flipped unit
    over max|h|. Its inputs come from a generator of its own, so the
    phases after it draw what they drew without it."""
    h_, t = LAYER_SHAPE["h"], LAYER_SHAPE["t"]
    rng = np.random.default_rng(90 + decoder)
    if decoder:
        mod, case, ref, at = fdl, decoder_case, fdl.decoder_layer_reference, 6
    else:
        mod, case, ref, at = fl, layer_case, fl.encoder_layer_reference, 3
    out = {}
    for b in (32, 512):
        readings = []
        for i in range(2 * KINK_SEEDS):
            rate = 0.3 * (i % 2)
            args, _ = case(dev, rng, b, torch.bfloat16)
            seed = torch.tensor([9001 + 97 * i + b], dtype=torch.int32, device=dev)
            res = mod.layer_forward(*args, seed, rate, h_, t)
            with torch.no_grad():
                own = ref(*args, seed, rate, h_, t, return_residuals=True)
            readings.append(layer_flips(own[at], res[at])[1])
        out[f"B{b}"] = {"flips": [r["flips"] for r in readings], "units": readings[0]["units"],
                        "largest_share": max(r["flips"] for r in readings) / readings[0]["units"],
                        "largest_rel": max(r["largest_rel"] for r in readings)}
    return out


def tensors_in(obj):
    """The tensors among a launch's arguments (lists and tuples walked)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from tensors_in(o)


def launch_bound(launch) -> dict:
    """A launch's own bound: each distinct input read once and each output
    written once (views of one packed buffer count what they cover), and its
    operations: the product's 2·rows·n·k, the attention's 4·d forward and
    12·d backward (P again, dP, dS·K, dSᵀ·Q, PᵀdA and the output again) for
    each (query, key) pair it computes (``attn_pairs``),
    the weight gradients' 2·rows·m·n each; row passes and the reduce are
    bytes. f32 products at the split-TF32 rate (``op_bounds``)."""
    seen = {}
    for t in [*tensors_in(launch.args), *tensors_in(launch.outputs)]:
        seen[(t.data_ptr(), tuple(t.shape), t.stride())] = t.numel() * t.element_size()
    ref, a = launch.reference, launch.args
    flops = 0
    if ref in (layer_sm90.bias_reference, layer_sm90.hidden_reference,
               layer_sm90.residual_ln_reference, layer_sm90.dh_reference,
               layer_sm90.round_reference, layer_sm90.ln_backward_reference,
               layer_sm90.residual_sum_reference, layer_sm90.grad_sum_reference):
        flops = 2 * a[0].shape[0] * a[1].shape[0] * a[1].shape[1]
    elif ref is layer_sm90.attention_forward_reference:
        flops = 4 * attn_pairs(a[0].shape[0], a[7], a[8]) * a[0].shape[1]
    elif ref is layer_sm90.attention_backward_reference:
        flops = 12 * attn_pairs(a[0].shape[0], a[8], a[9]) * a[0].shape[1]
    elif ref is layer_sm90.weight_partials_reference:
        flops = sum(2 * dy.shape[0] * dy.shape[1] * x.shape[1] for dy, x in a[0])
    dtype = "float32" if launch_dtype(launch) == torch.float32 else "bfloat16"
    return op_bounds(sum(seen.values()), flops, dtype)


def launch_dtype(launch):
    """The activations' dtype of a recorded launch: bf16 where any of its
    inputs is bf16, else f32."""
    if any(t.dtype == torch.bfloat16 for t in tensors_in(launch.args)):
        return torch.bfloat16
    return torch.float32


def attention_library(launch):
    """``F.scaled_dot_product_attention`` with ``dropout_p`` at the launch's
    rate on its (B, H, T, hd) views (``is_causal`` where the launch is
    causal): its forward for an ``attn_fwd`` launch, its forward and autograd
    backward for an ``attn_bwd`` launch. It computes the same function with
    its own mask stream, so only its time is read; the port never calls it."""
    a = launch.args
    backward = launch.reference is layer_sm90.attention_backward_reference
    rate, h, t, causal = a[-4], a[-3], a[-2], bool(a[-1])

    def heads(x):
        return x.detach().view(x.shape[0] // t, t, h, -1).transpose(1, 2)

    q4, k4, v4 = (heads(x).requires_grad_(backward) for x in a[:3])

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, dropout_p=rate, is_causal=causal)

    if not backward:
        return fwd
    g4 = heads(a[3])
    return lambda: torch.autograd.grad(fwd(), (q4, k4, v4), g4)


def launch_library(launch):
    """One PyTorch call computing a launch's function, where there is one:
    F.linear for the bias products (the bias in bf16), a matmul for the
    products without a residual or epilogue, ``addmm`` for the wide route's
    f32 gradient sum, ``F.layer_norm`` for its f32 row pass of the forward,
    SDPA with dropout for the attention (``attention_library``)."""
    a = launch.args
    if launch.reference in (layer_sm90.attention_forward_reference,
                            layer_sm90.attention_backward_reference):
        return attention_library(launch)
    if launch.reference is layer_sm90.bias_reference:
        bias = a[2].to(a[0].dtype)
        return lambda: F.linear(a[0], a[1], bias)
    if launch.reference is layer_sm90.round_reference and a[2] is None:
        return lambda: torch.matmul(a[0], a[1])
    if launch.reference is layer_sm90.grad_sum_reference and a[0].dtype == torch.float32:
        return lambda: torch.addmm(a[2], a[0], a[1])
    if launch.reference is layer_sm90.ln_y_reference and a[3] == torch.float32:
        return lambda: F.layer_norm(a[0], (a[0].shape[1],), a[1], a[2], layer_sm90.LN_EPS)
    return None


def launch_device_us(record, n: int) -> list:
    """Device µs per call of each recorded launch replayed ``n`` times, and
    the profiler's launches per call (it can lose events), from one profile
    with a marked window per launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for launch in record:
        launch.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, launch in enumerate(record):
            with record_function(f"chip_smoke_launch_{i}"):
                for _ in range(n):
                    launch.replay()
                torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    windows = {}  # the host's marked ranges (the device's copies of the marks are skipped)
    for e in events:
        if e.name().startswith("chip_smoke_launch_") and e.device_type() == DeviceType.CPU:
            windows[int(e.name().rsplit("_", 1)[1])] = (e.start_ns(), e.start_ns() + e.duration_ns())
    us, count = [0.0] * len(record), [0.0] * len(record)
    for e in events:
        if (e.device_type() != DeviceType.CUDA or e.name() == "Activity Buffer Request"
                or e.name().startswith("chip_smoke_launch_")):
            continue
        for i, (lo, hi) in windows.items():
            if lo <= e.start_ns() <= hi:
                us[i] += e.duration_ns() / 1e3 / n
                count[i] += 1 / n
                break
    return us, count


def sm90_launches(record, kernels: dict, plain: bool, n: int, dtype=torch.bfloat16,
                  kinds=None, warm: int = 10, graph: bool = False) -> dict:
    """Every launch of one layer call's chain in ``dtype``, as recorded on the
    card: its outputs held to its plain version on the same inputs
    (``SM90_BAR[dtype]`` · max|ref| each), its device time per launch
    (profiler, ``n`` replays, or with ``graph`` a CUDA graph of ``n``
    replays, where the profiler loses events; none where ``n`` is 0; with
    ``kinds``, only of the launches of those types of
    ``layer_sm90.ENTRIES``), its own bound, and with ``plain`` the plain
    version's stream time and the library call's (with ``graph`` its device
    time, from a CUDA graph of its calls). Keyed by the counted kernel's
    name."""
    names = {id(k): name for name, k in kernels.items()}
    rows, bar = {}, SM90_BAR[dtype]
    for launch in record:
        name = names[id(launch.kernel)]
        want = launch.reference(*launch.args, **launch.kwargs)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for got, ref in zip(launch.outputs, want, strict=True):
            e, top = max_err(got, ref), float(ref.float().abs().max())
            check(e <= bar * top, f"{name}: {e} > {bar} * {top}")
            err = max(err, e)
        rows[name] = {"max_abs_err": err, **launch_bound(launch)}
        if launch.reference is layer_sm90.hidden_reference:  # band and share, in full
            rows[name]["relu_kink_flips"] = fl.kink_flips(want[0], launch.outputs[0])[1]
    if n == 0:
        return rows
    if kinds is not None:
        record = [launch for launch in record
                  if launch.kernel.entry in {layer_sm90.ENTRIES[k] for k in kinds}]
    if graph:
        us = [graph_ms(launch.replay, n=n, reps=2) * 1e3 for launch in record]
        count = [1] * len(record)
    else:
        us, count = launch_device_us(record, n)
    for launch, u, c in zip(record, us, count):
        name = names[id(launch.kernel)]
        rows[name].update(device_ms=u / 1000.0, device_launches_per_call=c)
        if plain:
            rows[name]["plain_ms"] = time_us(
                lambda: launch.reference(*launch.args, **launch.kwargs), 5, warm) / 1000.0
            lib = launch_library(launch)
            rows[name]["library_ms"] = (None if lib is None else graph_ms(lib, n=n, reps=2)
                                        if graph else time_us(lib, 50, warm) / 1000.0)
    return rows


def library_layer(args, dy, b: int, decoder: bool, shape: dict = LAYER_SHAPE,
                  device: bool = True) -> dict:
    """``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer`` (post-LN,
    ReLU, batch_first, dropout 0.30, training mode, in the dtype of
    ``args``: bf16 and f32 both) with the layer's
    weights: forward, and its autograd backward, stream and device time. The
    port never calls it; it is the yardstick one PyTorch call gives. In f32
    its products are cuBLAS SGEMMs: TF32 is off for matmuls and cuDNN
    (``phase_device`` sets both, and ``tf32`` in the result reads them).
    ``shape``: another layer's d, h, ff and t; without ``device``, stream
    times only (no profiler)."""
    h_, t = shape["h"], shape["t"]
    d, ff = shape["d"], shape["ff"]
    dev, dtype = args[0].device, args[0].dtype
    kw = dict(dropout=0.3, batch_first=True, device=dev, dtype=dtype)
    with torch.no_grad():
        if decoder:
            a = dict(zip(fdl.ARG_NAMES, args))
            lib = torch.nn.TransformerDecoderLayer(d, h_, ff, **kw)
            pairs = [(lib.self_attn.in_proj_weight, a["wqkv"]), (lib.self_attn.in_proj_bias, a["bqkv"]),
                     (lib.self_attn.out_proj.weight, a["wo"]), (lib.self_attn.out_proj.bias, a["bo"]),
                     (lib.multihead_attn.in_proj_weight, torch.cat([a["wq"], a["wkv"]])),
                     (lib.multihead_attn.in_proj_bias, torch.cat([a["bq"], a["bkv"]])),
                     (lib.multihead_attn.out_proj.weight, a["wo2"]),
                     (lib.multihead_attn.out_proj.bias, a["bo2"]),
                     (lib.norm1.weight, a["g1"]), (lib.norm1.bias, a["b1"]),
                     (lib.norm2.weight, a["g2"]), (lib.norm2.bias, a["b2"]),
                     (lib.norm3.weight, a["g3"]), (lib.norm3.bias, a["b3"]),
                     (lib.linear1.weight, a["w1"]), (lib.linear1.bias, a["b1f"]),
                     (lib.linear2.weight, a["w2"]), (lib.linear2.bias, a["b2f"])]
            inputs = [a["y"].view(b, t, d).detach().requires_grad_(True),
                      a["mem"].view(b, t, d).detach().requires_grad_(True)]
            mask = torch.nn.Transformer.generate_square_subsequent_mask(t, device=dev,
                                                                        dtype=dtype)

            def fwd():
                return lib(*inputs, tgt_mask=mask, tgt_is_causal=True)
        else:
            x, wqkv, bqkv, wo, bo, g1, b1, w1, b1f, w2, b2f, g2, b2 = args
            lib = torch.nn.TransformerEncoderLayer(d, h_, ff, **kw)
            pairs = [(lib.self_attn.in_proj_weight, wqkv), (lib.self_attn.in_proj_bias, bqkv),
                     (lib.self_attn.out_proj.weight, wo), (lib.self_attn.out_proj.bias, bo),
                     (lib.norm1.weight, g1), (lib.norm1.bias, b1), (lib.norm2.weight, g2),
                     (lib.norm2.bias, b2), (lib.linear1.weight, w1), (lib.linear1.bias, b1f),
                     (lib.linear2.weight, w2), (lib.linear2.bias, b2f)]
            inputs = [x.view(b, t, d).detach().requires_grad_(True)]

            def fwd():
                return lib(*inputs)
        for param, value in pairs:
            param.copy_(value)
    lib.train()
    out = fwd()
    leaves = [*lib.parameters(), *inputs]
    grad = dy.view(b, t, d)

    def bwd():
        return torch.autograd.grad(out, leaves, grad, retain_graph=True)

    n = 20 if b == 32 else 5
    f1, b1_, b2_, f2 = (time_us(fn, n) / 1000.0 for fn in (fwd, bwd, bwd, fwd))

    return {"fwd_ms": [f1, f2], "bwd_ms": [b1_, b2_],
            "fwd_device_ms": (sum(us for us, _ in device_us(fwd, n=3).values()) / 1000.0
                              if device else None),
            "bwd_device_ms": (sum(us for us, _ in device_us(bwd, n=3).values()) / 1000.0
                              if device else None),
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32}}


def band_bound(n: int, n_fft: int = 1024, n_bands: int = 16) -> dict:
    """What the function needs of its inputs: frames and filterbank read once,
    band energies written once, and per frame a real FFT (2.5 · n_fft ·
    log2 n_fft operations), the magnitude (4 a bin) and the projection. The
    kernel's own algorithm, two dense DFT products, costs far more: its
    operations and their time at the f32 peak go beside the bound as
    ``dense_dft_flops`` and ``dense_dft_ms``, and are no bound."""
    bins = n_fft // 2
    fft = 2.5 * n_fft * np.log2(n_fft)
    dense = 4 * n * n_fft * bins + 2 * n * bins * n_bands
    return {**bound(4 * (n * n_fft + (bins + 1) * n_bands + n * n_bands),
                    n * (fft + 4 * bins + 2 * bins * n_bands), "float32"),
            "dense_dft_flops": int(dense),
            "dense_dft_ms": dense / PEAK_FLOPS["float32"] * 1e3}


def band_audio_bound(m: int, length: int, f: int, n_fft: int = 1024, n_bands: int = 16) -> dict:
    """What the waveform entry needs: the samples, window, filterbank and
    twiddles read once, band energies written once, and per frame a real FFT
    (2.5 · n_fft · log2 n_fft operations), the magnitude and the projection."""
    bins = n_fft // 2
    fft = 2.5 * n_fft * np.log2(n_fft)
    return bound(4 * (m * length + n_fft + bins * n_bands + 2 * n_fft + m * f * n_bands),
                 m * f * (fft + 4 * bins + 2 * bins * n_bands), "float32")


def synth_bound(onset, row, gain, table, lengths, length: int) -> dict:
    """What this run's events need: two operations per (live event, sample)
    pair that lands inside the waveform, and of the table only the samples
    they read (per row used, its longest span; a kit table's rows are padded
    to the longest sample of all kits, and most rows go unread at M 1)."""
    live = gain != 0
    rows = row[live].long()
    span = ((onset[live] + lengths[rows]).clamp(max=length) - onset[live]).long()
    read = torch.zeros(table.shape[0], dtype=torch.long, device=table.device).scatter_reduce(
        0, rows, span, "amax")
    m, e = onset.shape
    return bound(4 * (3 * m * e + int(read.sum()) + lengths.numel() + m * length),
                 2 * int(span.sum()), "float32")


def hit_agreement(h, h_ref, sig_ref, margin=1e-4) -> bool:
    """Thresholded hits equal wherever the reference sigmoid is not within
    ``margin`` of 0.5."""
    sure = np.abs(sig_ref - 0.5) >= margin
    return bool(np.array_equal(h[sure], h_ref[sure]))


def post(port: int, payload=None, raw: bytes | None = None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/infill",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all(KERNEL_NAMES)  # one nvcc each, together
    for name in KERNEL_NAMES:
        info = _build.build_info[name]
        ptxas = [line.strip() for line in info["log"].splitlines()
                 if "registers" in line or "spill" in line or "Compiling entry" in line]
        emit({"phase": "build", "kernel": name, "seconds": time.perf_counter() - t0,
              "nvcc_seconds": info["seconds"], "ptxas": ptxas})
    emit({"phase": "build", "kernel": "fused_ln", "dynamic_smem_bytes": {
        f"d {d}": {"ln_fwd": 0, "ln_bwd": ln.bwd_smem_bytes(d, torch.bfloat16)}
        for d in (256, 1024)}, "limit": fl.MAX_SMEM_BYTES})


def kernel_resources(name: str) -> dict:
    """ptxas' registers, spilled bytes and static shared memory of each entry
    of ``csrc/<name>.cu`` (one per template instance), from the build log."""
    out, entry = {}, None
    for line in _build.build_info[name]["log"].splitlines():
        found = re.search(r"Compiling entry function '_Z\w*?\d+([a-z_]+)I(\w+?)EEEv", line)
        if found:
            args = found.group(2)
            dtype = ["bf16"] if args.startswith("13__nv_bfloat16") else ["f32"] * (args[0] == "f")
            entry = f"{found.group(1)}<{', '.join(dtype + re.findall(r'Li(\d+)E', args + 'E'))}>"
            out[entry] = {}
        elif entry and "spill stores" in line:
            out[entry]["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif entry and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def mha_inputs(dev, rng, b: int, h: int, hd: int, dtype, form: str, t: int = 32):
    """q, k, v of shape (b, h, t, hd) as the model passes them: contiguous, the
    slices of a packed qkv (b, t, 3, h, hd), or q (b, t, h, hd) with the
    slices of a packed kv (b, t, 2, h, hd). ``rng`` a numpy generator, or a
    torch generator on the card (the long route's large inputs, drawn
    there)."""
    def n(*shape):
        if isinstance(rng, torch.Generator):
            return torch.randn(shape, generator=rng, device=dev).to(dtype)
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    if form == "contiguous":
        return n(b, h, t, hd), n(b, h, t, hd), n(b, h, t, hd)
    if form == "packed_qkv":
        return tuple(n(b, t, 3, h, hd).permute(2, 0, 3, 1, 4))
    k, v = n(b, t, 2, h, hd).permute(2, 0, 3, 1, 4)
    return n(b, t, h, hd).transpose(1, 2), k, v


MHA_FORMS = ("contiguous", "packed_qkv", "packed_kv")
# #1 past the flagship's heads, one head: hd 384, 512 (the sweeps' d 512 / 1
# head), 768 and 1,024 (a d 1,024 model with one head, phase 9's wide path);
# timed at 512 and 1,024
MHA_WIDE_HDS = (384, 512, 768, 1024)
MHA_TIMED_HDS = (512, 1024)
# the batches phase 22's eval forwards give #1: the train and validation
# evaluators' rows (seeded, so fixed), each one forward of the whole set
EVAL_ROWS = {"train": 3300, "validation": 1099}
MHA_BARS = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}


def mha_tolerance(dtype, want) -> tuple:
    """(atol, rtol) for #1 against its plain version: f32 1e-5; bf16 2e-2
    and 2e-2 · |ref|, with the atol scaled by max|ref| where that is below 1
    (long sequences average more values, so their outputs shrink: about
    √(e/T), 0.05 at T 1,024, where a bare 2e-2 would be half a typical
    value)."""
    atol, rtol = MHA_BARS[dtype]
    if dtype == torch.bfloat16:
        atol *= min(1.0, float(want.float().abs().max()))
    return atol, rtol
# #1 past T 64 (loops past 4 bars at sixteenths: the long route), (b, h, hd,
# form, T): the flash form (heads up to 128 that TMA reads) at the flagship's
# heads from T 65 to the ceiling, 64 query rows an item (one wave) and 128
# (B 300), odd heads and lengths; the scores form at wider heads, each of its
# buckets of query rows a block (64 up to T 256, 32 up to 512, 16 past it),
# and at hd 5 (rows of 10 or 20 bytes, which TMA does not read)
LONG_MHA_CASES = ((4, 2, 128, "packed_qkv", 65), (4, 2, 128, "contiguous", 128),
                  (2, 2, 128, "packed_kv", 256), (1, 2, 128, "packed_qkv", 1024),
                  (1, 2, 128, "contiguous", attention.MAX_T), (300, 2, 128, "packed_qkv", 128),
                  (2, 1, 256, "packed_qkv", 128),
                  (1, 1, 512, "contiguous", 400), (1, 1, 384, "contiguous", 1100),
                  (3, 2, 72, "contiguous", 300), (2, 4, 8, "contiguous", 96),
                  (3, 2, 5, "contiguous", 200))
# ... timed at 8, 16 and 64 bars (B 1 and 512, H 2, hd 128, packed qkv), and
# the eval forward at 8 bars (the train evaluator's rows)
LONG_MHA_TS = (128, 256, 1024)
# ... and the scores form past hd 128 at 8 bars (one head of 256, 512 and
# 1,024; B 1 and 512; both dtypes), beside its bound and SDPA
SCORES_TIMED_HDS = (256, 512, 1024)
LONG_T = 128  # phases 9 and 15's path: 8-bar loops


def mha_timing(dev, rng, b: int, dtype, h: int, hd: int, form: str, t: int = 32,
               n: int = 20, long: bool = False) -> dict:
    """``fused_mha`` at (b, h, t, hd) in ``dtype`` and ``form``: stream time
    in turns with its plain version and SDPA on the same views (``n`` calls
    each), the profiler's device times, and the bound. ``long`` (the long
    route's lengths, where a call takes up to 26 ms): 2 warm-up calls a
    timing, not 10, and no profiler: the kernel's and SDPA's device times
    each from a CUDA graph of their calls, so the two compare alike."""
    q, k, v = mha_inputs(dev, rng, b, h, hd, dtype, form, t)
    kern = lambda: fused_mha(q, k, v)  # noqa: E731
    plain = lambda: mha_reference(q, k, v)  # noqa: E731
    # the library call that computes the same function; timed, never used
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    check(torch.allclose(sdpa().float(), kern().float(),
                         atol=2e-2 if dtype == torch.bfloat16 else 1e-5),
          "scaled_dot_product_attention disagrees with fused_mha")
    warm = 2 if long else 10
    k1, p1, l1, l2, p2, k2 = (time_us(f, n, warm)
                              for f in (kern, plain, sdpa, sdpa, plain, kern))
    before = MHA.launches
    if long:  # replayed from a CUDA graph: the device's time without the host's launches
        dk, dp, dl = {}, {}, {}
        kernel_device = graph_ms(kern, n=n, reps=2) * 1e3
        sdpa_device = graph_ms(sdpa, n=n, reps=2) * 1e3
    else:
        dk, dp, dl = device_us(kern, n=n), device_us(plain, n=n), device_us(sdpa, n=n)
        # per captured launch (the profiler may lose events)
        kernel_device = max(sum(us / c for us, c in dk.values()), 1e-9)
        sdpa_device = sum(us for us, _ in dl.values()) if dl else None
    launches_profiled = MHA.launches - before
    dtype_name = str(dtype).replace("torch.", "")
    bnd = mha_bound(b, h, t, hd, dtype_name)
    route = attention.route(q, k, v)
    rows = attention.flash_rows(b, h, t, _build.sm_count(q.device)) if route == "flash" else None
    return {
        "shape": [b, h, t, hd], "dtype": dtype_name, "form": form, "route": route,
        "flash_rows": rows, "copy_bytes": attention.copy_bytes(q, k, v),
        "smem_bytes": attention.kernel_smem_bytes(t, dtype, hd, rows),
        "kernel_us": [k1, k2], "plain_us": [p1, p2], "sdpa_us": [l1, l2],
        "sdpa_device_us": sdpa_device, "device_time_from": "cuda_graph" if long else "profiler",
        **bnd, "kernel_device_us": kernel_device,
        "kernel_device_launches_per_call": sum(c for _, c in dk.values()) if dk else None,
        "wrapper_launches_in_profiled_calls": launches_profiled,
        "bound_share_of_device_time": bnd["bound_ms"] * 1e3 / kernel_device,
        "plain_device_us": sum(us for us, _ in dp.values()) if dp else None,
        "plain_kernels_us": {k: us for k, (us, _) in dp.items()}}


def mha_checked(dev, rng, cases, worst: dict, record: list | None = None) -> int:
    """``fused_mha`` against ``mha_reference`` (on contiguous copies) at each
    (b, h, hd, form[, t]) of ``cases``, both dtypes, causal and not, one
    launch each; the largest error a dtype into ``worst``, and each check's
    form of the kernel (``attention.route``), error and bar into ``record``.
    Returns the checks made."""
    checks = 0
    for b, h, hd, form, *rest in cases:
        t = rest[0] if rest else 32
        for dtype in MHA_BARS:
            q, k, v = mha_inputs(dev, rng, b, h, hd, dtype, form, t)
            for causal in (False, True):
                before = MHA.launches
                got = fused_mha(q, k, v, causal=causal)
                torch.cuda.synchronize()
                want = mha_reference(q.contiguous(), k.contiguous(), v.contiguous(),
                                     causal=causal)
                err = max_err(got, want)
                worst[dtype] = max(worst[dtype], err)
                atol, rtol = mha_tolerance(dtype, want)
                if record is not None:
                    record.append({"shape": [b, h, t, hd], "form": form,
                                   "dtype": str(dtype)[6:], "causal": causal,
                                   "route": attention.route(q, k, v), "max_abs_err": err,
                                   "atol": atol, "rtol": rtol})
                ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
                check(ok and got.dtype == dtype and got.shape == q.shape
                      and got.transpose(1, 2).is_contiguous() and MHA.launches == before + 1,
                      f"fused_mha != mha_reference at {(b, h, t, hd)} {dtype} {form} "
                      f"causal={causal}: max abs err {err}")
                checks += 1
    return checks


def phase_kernel(dev, rng) -> dict:
    """``fused_mha`` against ``mha_reference`` (on contiguous copies) at the
    serving shapes, contiguous and as the slices of packed projections; then
    device times beside the bound and SDPA on the same views. Past T 64 (the
    long route) the same at ``LONG_MHA_CASES`` and ``LONG_MHA_TS``, and a
    call past the ceiling refused with a ``ValueError`` that names it."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(b, h, hd, "contiguous") for h, hd in ((2, 128), (4, 8)) for b in (1, 8, 32, 512)]
    cases += [(b, 2, 128, form) for b in (1, 512) for form in MHA_FORMS[1:]]
    cases += [(b, 2, 128, form) for b in EVAL_ROWS.values() for form in MHA_FORMS[:2]]
    cases += [(b, 1, hd, form) for hd in MHA_WIDE_HDS for b in (1, 512) for form in MHA_FORMS[:2]]
    checks = mha_checked(dev, rng, cases, worst)
    timings = []
    eval_b = EVAL_ROWS["train"]
    timed = [(b, dtype, 2, 128, form)
             for b, dtype in ((1, torch.float32), (8, torch.float32), (32, torch.float32),
                              (512, torch.float32), (1, torch.bfloat16), (512, torch.bfloat16),
                              (eval_b, torch.bfloat16))
             for form in (MHA_FORMS if b in (1, 512) else MHA_FORMS[:2] if b == eval_b
                          else MHA_FORMS[:1])]
    timed += [(b, dtype, 1, hd, "packed_qkv") for hd in MHA_TIMED_HDS for dtype in MHA_BARS
              for b in (1, 512)]
    for b, dtype, h, hd, form in timed:
        timings.append(mha_timing(dev, rng, b, dtype, h, hd, form))
    # past T 64: the long route's buckets checked, the ceiling refused, and
    # 8, 16 and 64 bars timed (the long buckets timed with 5 calls a turn)
    long_worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    long_record = []
    long_checks = mha_checked(dev, rng, LONG_MHA_CASES, long_worst, long_record)
    check({r["route"] for r in long_record} == {"flash", "scores"},
          f"the long checks took the forms {sorted({r['route'] for r in long_record})}")
    past = torch.zeros(1, 1, attention.MAX_T + 1, 16, device=dev)
    try:
        fused_mha(past, past, past)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check(f"T ≤ {attention.MAX_T}" in refused,
          f"fused_mha past its ceiling T {attention.MAX_T}: {refused or 'no ValueError'}")
    card_rng = torch.Generator(dev).manual_seed(23)
    long_timings = [mha_timing(dev, card_rng, b, dtype, 2, 128, "packed_qkv", t, n=3, long=True)
                    for t in LONG_MHA_TS for dtype in MHA_BARS for b in (1, 512)]
    long_timings.append(mha_timing(dev, card_rng, eval_b, torch.bfloat16, 2, 128, "packed_qkv",
                                   LONG_T, n=3, long=True))
    scores_timings = [mha_timing(dev, card_rng, b, dtype, 1, hd, "packed_qkv", LONG_T, n=3,
                                 long=True)
                      for hd in SCORES_TIMED_HDS for dtype in MHA_BARS for b in (1, 512)]
    check(all(r["route"] == "scores" for r in scores_timings),
          f"past hd 128 #1 took {sorted({r['route'] for r in scores_timings})}")
    emit({"phase": "kernel", "checks": checks,
          "max_abs_err": {"float32": worst[torch.float32], "bfloat16": worst[torch.bfloat16]},
          "bars": {"float32": {"atol": 1e-5},
                   "bfloat16": {"atol": "2e-2 * min(1, max|ref|)", "rtol": 2e-2}},
          "timings": timings})
    emit({"phase": "kernel_long_t", "checks": long_checks, "cases": LONG_MHA_CASES,
          "checked": long_record,
          "max_abs_err": {str(k)[6:]: v for k, v in long_worst.items()},
          "refused_past_the_ceiling": refused, "timings": long_timings,
          "scores_form_timings": scores_timings})
    return {"max_abs_err": max(worst[torch.float32], long_worst[torch.float32]),
            "timings": timings, "long_timings": long_timings, "scores_timings": scores_timings,
            "long_max_abs_err": {str(k)[6:]: v for k, v in long_worst.items()}}


def phase_serve(dev, rng, sd):
    srv = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev)
    plain = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev,
                               use_kernel=False)
    raw = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev,
                             use_kernel=False, use_thres=False)
    check(srv.config.use_fused_attention and not plain.config.use_fused_attention,
          "kernel / plain servers are not configured as asked")
    xs = {n: rng.standard_normal((n, 32, 16)).astype(np.float32) for n in (1, 6, 40)}
    chunks = {1: 1, 6: 1, 40: 2}  # buckets (1, 8, 32): 1 | 8 | 32 + 8

    MHA.launches = 0  # the main path's run starts here
    out = {n: srv.infill(x) for n, x in xs.items()}
    launches = MHA.launches  # ... and ends here
    check(launches == 6 * sum(chunks.values()),
          f"fused_mha launched {launches} times, expected 6 per forward chunk "
          f"({6 * sum(chunks.values())})")

    worst = 0.0
    for n, x in xs.items():
        y, yp, yr = out[n], plain.infill(x), raw.infill(x)
        check(y.shape == (n, 32, 27) and np.isfinite(y).all(), f"bad output at N={n}")
        check(set(np.unique(y[..., :9])) <= {0.0, 1.0}, "hits not thresholded")
        err = max_err(y[..., 9:], yp[..., 9:])
        worst = max(worst, err)
        check(err <= 1e-4, f"kernel vs plain server at N={n}: v/o differ by {err}")
        check(hit_agreement(y[..., :9], yp[..., :9], yr[..., :9]),
              f"kernel vs plain server at N={n}: hits differ away from the threshold")

    # the plain path on the CPU, the one the CPU tests hold against JAX
    cpu_model = build_model(FLAGSHIP, "cpu")
    cpu_model.load_state_dict(sd, strict=True)
    h_cpu, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(xs[6]))
    cpu_err = max(max_err(out[6][..., 9:18], v_cpu), max_err(out[6][..., 18:], o_cpu))
    check(cpu_err <= 1e-4, f"card vs CPU plain path: v/o differ by {cpu_err}")

    bf16_cfg = dataclasses.replace(FLAGSHIP, compute_dtype=torch.bfloat16)
    srv16 = serve.InfillServer(sd, bf16_cfg, batch_sizes=BUCKETS, device=dev)
    plain16 = serve.InfillServer(sd, bf16_cfg, batch_sizes=BUCKETS, device=dev,
                                 use_kernel=False)
    before = MHA.launches
    y16 = srv16.infill(xs[40])
    check(MHA.launches - before == 6 * chunks[40], "bf16 run missed the kernel")
    check(np.isfinite(y16).all(), "bf16 output not finite")
    err16_plain = max_err(y16[..., 9:], plain16.infill(xs[40])[..., 9:])
    check(err16_plain <= 2e-2, f"bf16 kernel vs plain server: v/o differ by {err16_plain}")
    emit({"phase": "serve", "config": "InfillingRandom flagship d256 h2 ff512 6L",
          "requests": sorted(xs), "chunks": sum(chunks.values()), "launches": launches,
          "max_abs_err_vs_plain_server": worst, "max_abs_err_vs_cpu_plain": cpu_err,
          "bf16": {"max_abs_dev_vs_f32": max_err(y16[..., 9:], out[40][..., 9:]),
                   "hit_flip_share_vs_f32": float((y16[..., :9] != out[40][..., :9]).mean()),
                   "max_abs_err_vs_bf16_plain_server": err16_plain}})
    return srv, plain, raw, launches


def phase_http(dev, rng, sd, srv, raw) -> None:
    httpd = srv.serve_http(port=0, block=False)
    coal = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev,
                              coalesce=True, coalesce_wait_ms=5.0)
    httpd_c = coal.serve_http(port=0, block=False)
    try:
        port = httpd.server_address[1]
        for n in (1, 3):
            x = rng.standard_normal((n, 32, 16)).astype(np.float32)
            code, payload = post(port, {"input": x.tolist()})
            check(code == 200, f"POST /infill answered {code}: {payload}")
            check(np.array_equal(np.asarray(payload["hvo"], np.float32), srv.infill(x)),
                  "HTTP answer differs from the direct path")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            body = r.read()
        health = json.loads(body)
        check(b"NaN" not in body and health["ok"] and health["count"] >= 2,
              f"bad /healthz: {body!r}")
        code, bad = post(port, raw=b"{not json")
        check(code == 400 and "error" in bad, f"malformed body answered {code}")

        xs = [rng.standard_normal((32, 16)).astype(np.float32) for _ in range(32)]
        got, errs = [None] * len(xs), []

        def client(ids):
            try:
                for i in ids:
                    c, p = post(httpd_c.server_address[1], {"input": xs[i].tolist()})
                    got[i] = (c, np.asarray(p.get("hvo"), np.float32))
            except Exception as e:  # reported below
                errs.append(e)

        threads = [threading.Thread(target=client, args=(range(j, 32, 8),))
                   for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not errs and not any(t.is_alive() for t in threads),
              f"coalesced clients failed: {errs}")
        worst = 0.0
        for x, (c, y) in zip(xs, got):
            check(c == 200, f"coalesced request answered {c}")
            want, sig = srv.infill(x), raw.infill(x)
            worst = max(worst, max_err(y[:, 9:], want[:, 9:]))
            check(hit_agreement(y[:, :9], want[:, :9], sig[:, :9]),
                  "coalesced hits differ from the direct path")
        # batch composition changes the products' shapes, hence f32 rounding
        check(worst <= 1e-5, f"coalesced v/o differ from the direct path by {worst}")
        emit({"phase": "http", "posts": 2, "healthz": health, "malformed": code,
              "coalesced_clients": 8, "coalesced_requests": len(xs),
              "coalesced_max_abs_err_vs_direct": worst})
    finally:
        for h in (httpd, httpd_c):
            h.shutdown()
            h.server_close()


def phase_demo(rng) -> None:
    before = MHA.launches
    httpd = serve.main(["--ckpt", DEMO_MODEL, "--port", "0"] + DEMO_FLAGS, block=False)
    try:
        grid = (rng.random((32, 27)) < 0.25).astype(np.float32)
        code, payload = post(httpd.server_address[1], {"hvo_input": grid.tolist()})
    finally:
        httpd.shutdown()
        httpd.server_close()
    check(code == 200, f"demo hvo_input answered {code}: {payload}")
    y = np.asarray(payload["hvo"], np.float32)
    check(y.shape == (32, 27) and np.isfinite(y).all(), "bad demo answer")
    cfg = GrooveTransformerConfig(d_model=32, n_heads=4, dim_feedforward=512,
                                  num_encoder_layers=6, embedding_size_src=27)
    sd, epoch, _loss = load_legacy_checkpoint(DEMO_MODEL, cfg)
    model = build_model(cfg, "cpu")
    model.load_state_dict(sd, strict=True)
    h, v, o = predict(model, torch.from_numpy(grid[None]))
    sig = predict(model, torch.from_numpy(grid[None]), use_thres=False)[0].numpy()[0]
    err = max(max_err(y[:, 9:18], v[0]), max_err(y[:, 18:], o[0]))
    check(err <= 1e-4, f"demo answer vs CPU plain path: v/o differ by {err}")
    check(hit_agreement(y[:, :9], h[0].numpy(), sig), "demo hits differ")
    launches = MHA.launches - before
    check(launches >= 6, "the demo server did not run the kernel")
    emit({"phase": "demo", "checkpoint": DEMO_MODEL, "epoch": epoch,
          "max_abs_err_vs_cpu_plain": err, "hits": int(y[:, :9].sum()),
          "launches_incl_warmup": launches})


def phase_latency(dev, srv, plain) -> dict:
    runs = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):  # in turns
        runs[which].append(serve.latency_benchmark(
            srv if which == "kernel" else plain, n_requests=300, batch=1))
    batch32 = {"kernel": [], "plain": []}  # one full bucket-32 chunk per request
    for which in ("kernel", "plain", "plain", "kernel"):
        batch32[which].append(serve.latency_benchmark(
            srv if which == "kernel" else plain, n_requests=200, batch=32))
    httpd = srv.serve_http(port=0, block=False)
    try:
        http = serve.latency_benchmark(
            srv, n_requests=300, batch=1,
            url=f"http://127.0.0.1:{httpd.server_address[1]}/infill")
    finally:
        httpd.shutdown()
        httpd.server_close()
    # where a B = 1 request's time goes
    x = np.zeros((1, 32, 16), np.float32)
    xd = torch.zeros((1, 32, 16), device=dev)
    request = host_us(lambda: srv.infill(x))
    forward = host_us(lambda: srv._forward(xd))
    plain_forward = host_us(lambda: plain._forward(xd))
    copies = host_us(lambda: torch.from_numpy(x).to(dev).cpu())
    per_kernel = device_us(lambda: srv.infill(x), n=50)
    device_total = sum(us for us, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "latency", "batch": 1, "in_process_kernel": runs["kernel"],
          "in_process_plain": runs["plain"], "http_kernel": http,
          "batch32_kernel": batch32["kernel"], "batch32_plain": batch32["plain"],
          "batch32_rows_per_s_kernel": [32e3 / r["mean_ms"] for r in batch32["kernel"]],
          "batch32_rows_per_s_plain": [32e3 / r["mean_ms"] for r in batch32["plain"]],
          "breakdown_us": {"request": request, "forward": forward,
                           "plain_forward": plain_forward, "copy_in_out": copies},
          "request_device_us": device_total,
          "device_launches_per_request": sum(c for _, c in per_kernel.values()),
          "device_busy_share": device_total / request,
          "top_device_kernels_us_launches": top})
    return {"in_process": runs["kernel"][0], "http": http}


def layer_case(dev, rng, b: int, dtype, ff: int = LAYER_SHAPE["ff"], d: int = LAYER_SHAPE["d"],
               t: int = LAYER_SHAPE["t"]):
    """Flagship-shaped layer inputs from ``rng`` (ff, d and T as given):
    (args without the seed, dy)."""
    m = b * t

    def n(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    x = n(m, d).to(dtype)
    # nn.Linear's (out, in) layout
    wqkv, wo, w1, w2 = (n(3 * d, d, scale=d ** -0.5).to(dtype), n(d, d, scale=d ** -0.5).to(dtype),
                        n(ff, d, scale=d ** -0.5).to(dtype), n(d, ff, scale=ff ** -0.5).to(dtype))
    return [x, wqkv, n(3 * d, scale=0.1), wo, n(d, scale=0.1), n(d, scale=0.1, offset=1.0),
            n(d, scale=0.1), w1, n(ff, scale=0.1), w2, n(d, scale=0.1),
            n(d, scale=0.1, offset=1.0), n(d, scale=0.1)], n(m, d).to(dtype)


GRAD_NAMES = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg1", "db1", "dw1", "db1f", "dw2",
              "db2f", "dg2", "db2")


def layer_backward_args(args, res, seed):
    x, wqkv, _, wo, _, g1, b1, w1, _, w2, _, g2, _ = args
    _, qkv, a1, h, a2 = res
    return (x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed)


def layer_device_times(kf, kb, pf, pb) -> dict:
    """Device time of a layer call's forward and backward on the kernels and
    on the twin (profiler), and the kernels' device µs by kernel name."""
    dev_f, dev_b = device_us(kf, n=3), device_us(kb, n=3)
    per_kernel, launched = {}, {}
    for part in (dev_f, dev_b):
        for k, (us, c) in part.items():
            per_kernel[k] = per_kernel.get(k, 0.0) + us
            launched[k] = launched.get(k, 0.0) + c
    return {"kernel_fwd_device_ms": sum(us for us, _ in dev_f.values()) / 1000.0,
            "kernel_bwd_device_ms": sum(us for us, _ in dev_b.values()) / 1000.0,
            "kernel_device_us": per_kernel, "kernel_device_launches": launched,
            "plain_fwd_device_us": sum(us for us, _ in device_us(pf, n=3).values()),
            "plain_bwd_device_us": sum(us for us, _ in device_us(pb, n=3).values())}


def chain_drift(dev, rng, ff: int, decoder: bool = False, b: int = 32, draws: int = 8) -> dict:
    """The f32 encoder (or decoder) chain at ff ``ff`` (the flagship layer
    otherwise), rate 0, on ``draws`` seeded inputs: each launch's outputs
    against its plain version on the same inputs, the worst max|err| /
    max|ref| by launch. The products that reduce over ff (W2 with the last
    LN, dh·W1 with an LN's backward) run in 64 × 256 tiles without promotion,
    so their drift grows with ff (``gemm_sm90.cuh``). The chains are called
    below their gate (``forward_sm90`` / ``backward_sm90``), so a width the
    gate refuses is measured too; a launch past ``SM90_BAR`` fails unless the
    gate refuses that ff (``F32_MAX_FF``, ROADMAP §C11)."""
    h_, t, d = LAYER_SHAPE["h"], LAYER_SHAPE["t"], LAYER_SHAPE["d"]
    seed = torch.tensor([11], dtype=torch.int32, device=dev)
    mod = fdl if decoder else fl
    case, backward_args = ((decoder_case, decoder_backward_args) if decoder
                           else (layer_case, layer_backward_args))
    names = {id(k): name for name, k in mod.SM90_F32_KERNELS.items()}
    drift = {}
    for _ in range(draws):
        args, dy = case(dev, rng, b, torch.float32, ff=ff)
        with layer_sm90.recording() as record:
            res = mod.forward_sm90(*args, seed, 0.0, h_, t)
            mod.backward_sm90(dy, *backward_args(args, res, seed), 0.0, h_, t)
        for launch in record:
            want = launch.reference(*launch.args, **launch.kwargs)
            want = want if isinstance(want, tuple) else (want,)
            name = names[id(launch.kernel)]
            drift[name] = max(drift.get(name, 0.0), *(
                max_err(got, ref) / max(float(ref.float().abs().max()), 1e-30)
                for got, ref in zip(launch.outputs, want, strict=True)))
    gated = fl.supports_fused_layer(d, h_, ff, t, torch.float32) if not decoder \
        else fdl.supports_fused_decoder_layer(d, h_, ff, t, torch.float32)
    worst = max(drift.values())
    check(all(np.isfinite(v) for v in drift.values()), f"chain drift at ff {ff}: {drift}")
    check(worst <= SM90_BAR[torch.float32] or not gated,
          f"the f32 {'decoder' if decoder else 'encoder'} chain at ff {ff} drifts {worst} of "
          f"max, past {SM90_BAR[torch.float32]}, and its gate admits ff {ff}")
    return {"ff": ff, "B": b, "draws": draws, "gate_admits": gated, "worst": worst,
            "max_abs_err_of_max_by_launch": drift}


def against_twin(mod, args, dy, seed, rate: float, h_: int, res, grads, dtype, what: str,
                 relative: bool = False, t: int = LAYER_SHAPE["t"]):
    """A layer call's outputs ``res`` and gradients ``grads`` on the chain
    of ``mod`` (``fl`` or ``fdl``) against autograd through its twin on the
    same inputs and masks, the twin taking the chain's side of the ReLU's
    kink at the units ``layer_flips`` admits and its own everywhere else:
    ``(errs, kink)``. Bars: f32 1e-4 on y and the residuals and 1e-4 ·
    max|grad| on each grad (sums in another order, the products in split
    TF32); bf16 2e-2 · max|ref| on everything (the chain rounds its
    backward's intermediates where the TPU kernel does, autograd does not).
    ``relative`` (the wide route's layers, d past 256): f32 y and residuals
    at 1e-4 · max|ref| too (their products reduce over 512 to 6,144 terms and
    carry the error of one more launch into each residual; a launch alone is
    held to 1e-5 · max by ``sm90_launches``), and bf16 ReLU flips to
    ``fl.wide_kink_share(d)`` (``WIDE_KINK_SHARE`` up to d 1,024). ``t``:
    the sequences' length."""
    decoder = mod is fdl
    ref, h_at = (fdl.decoder_layer_reference, 6) if decoder else (fl.encoder_layer_reference, 3)
    out_names = ("y",) + (fdl.RESIDUAL_NAMES if decoder else ("qkv", "a1", "h", "a2"))
    with torch.no_grad():
        own = ref(*args, seed, rate, h_, t, return_residuals=True)
    flips, kink = layer_flips(own[h_at], res[h_at],
                              fl.wide_kink_share(args[0].shape[1]) if relative
                              else LAYER_KINK_SHARE)
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    want = ref(*leaves, seed, rate, h_, t, return_residuals=True, relu_flips=flips)
    want[0].backward(dy)
    errs = {}
    for name, g, w in zip(out_names, res, want):
        w = w.detach().float()
        top = float(w.abs().max())
        bar = (1e-4 * (top if relative else 1.0) if dtype == torch.float32 else 2e-2 * top)
        errs[name] = max_err(g, w)
        check(errs[name] <= bar, f"{name} {what}: {errs[name]} > {bar}")
    for name, g, leaf in zip(DEC_GRAD_NAMES if decoder else GRAD_NAMES, grads, leaves):
        w = leaf.grad.float()
        rel = 1e-4 if dtype == torch.float32 else 2e-2
        errs[name] = max_err(g, w)
        check(errs[name] <= rel * float(w.abs().max()),
              f"{name} {what}: {errs[name]} > {rel} * {float(w.abs().max())}")
    return errs, kink


# C11: the f32 chains' drift over ff, at the flagship's ff, the lm config's and above
DRIFT_FFS = (LAYER_SHAPE["ff"], 1024, 2048, 4096, 8192)


# the timed cases of phases 8 and 14: both dtypes at the YAML's batch and bench.py's
LAYER_TIMINGS = ((32, torch.bfloat16), (512, torch.bfloat16), (32, torch.float32),
                 (512, torch.float32))
# the launch types of the attention and the row passes (ops/layer_sm90.py)
STREAMED_KINDS = ("attn_fwd", "attn_bwd", "ln_rows", "ln_y", "ln_grad")
# what ``layer_route_cases`` times at a shape of each role, B 32: which
# launches (``kinds``, None for every one) with their plain versions or not,
# the whole layer (through the profiler and on the stream, on the stream
# only, or not at all, each beside its bound and nn.Transformer*Layer), and
# the warm-up calls before a timing; "checked" times nothing
LAYER_ROLES = {
    "checked": None,
    "timed": dict(kinds=None, plain=True, layer="device", warm=10),
    "streamed": dict(kinds=STREAMED_KINDS, plain=True, layer="stream", warm=10),
    # longer loops, whose launches take longer: 2 warm-up calls, every
    # launch's device time from a CUDA graph of its calls (no profiler)
    "timed_long": dict(kinds=None, plain=True, layer="stream", warm=2, graph=True),
    # (16 bars: the launches' device times from a CUDA graph, where the
    # profiler lost most of the forwards' events, PR 23)
    "streamed_long": dict(kinds=STREAMED_KINDS, plain=True, layer="stream", warm=2, graph=True),
}
# The chains' wide route (d past layer_sm90.LN_TILE), each shape a width the
# JAX gate admits: d 512 with 4 heads and ff 1,024 (a draw of
# configs/InfillingRandom_sweep.yaml and InfillingKicksAndSnares_sweep_2.yaml),
# d 1,024 with one head of 1,024 and ff 1,024 (phase 9's wide path: the
# attention streams the head), d 2,048 with 2 heads and ff 1,024 (the row
# passes a block a row), d 512 with one head of 512 and ff 512 (the sweeps'
# draw) and d 1,280 with 5 heads of 256 and ff 1,024 (the JAX gate's most
# heads)
# (timed: every launch at the main path's width, d 1,024 / 1 head; the
# attention and the row passes at d 2,048)
WIDE_SHAPES = (dict(d=512, h=4, ff=1024, t=32, role="checked"),
               dict(d=1024, h=1, ff=1024, t=32, role="timed"),
               dict(d=2048, h=2, ff=1024, t=32, role="streamed"),
               dict(d=512, h=1, ff=512, t=32, role="checked"),
               dict(d=1280, h=5, ff=1024, t=32, role="checked"))
WIDE_TIMED, WIDE_STREAMED = WIDE_SHAPES[1], WIDE_SHAPES[2]
# The flagship's layers in longer loops, 8 and 16 bars (the attention
# launches' long route past T 32): every launch timed at 8 bars, with its
# plain version, and the whole layer beside nn.Transformer*Layer; at 16 the
# attention's and the row passes' device time (a CUDA graph's), their plain
# versions, and the layer beside nn.Transformer*Layer on the stream
LONG_SHAPES = (dict(d=256, h=2, ff=512, t=LONG_T, role="timed_long"),
               dict(d=256, h=2, ff=512, t=256, role="streamed_long"))


def layer_route_cases(dev, rng, decoder: bool, shapes) -> dict:
    """The encoder (or decoder) chain at each of ``shapes`` (``WIDE_SHAPES``:
    the wide route; ``LONG_SHAPES``: the long route of the attention), both
    dtypes, rate 0.30, B 32: two calls with one seed bit-identical, the
    layer against its twin (``against_twin``), every launch of the route
    recorded and held to its plain version (``sm90_launches``: bf16 2e-2,
    f32 1e-5 · max, the hidden product's ReLU decisions by ``kink_flips``),
    and what the shape's role (``LAYER_ROLES``) times."""
    mod, case, backward_args = ((fdl, decoder_case, decoder_backward_args) if decoder
                                else (fl, layer_case, layer_backward_args))
    checks, timings = [], []
    for shape in shapes:
        d, h_, ff, t = shape["d"], shape["h"], shape["ff"], shape["t"]
        role = LAYER_ROLES[shape["role"]]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            route = mod.route_kernels(dtype, d)
            b = 32
            args, dy = case(dev, rng, b, dtype, ff=ff, d=d, t=t)
            seed = torch.tensor([2024 + b], dtype=torch.int32, device=dev)
            kf = lambda: mod.layer_forward(*args, seed, 0.3, h_, t)  # noqa: E731

            def kb(fwd):
                return mod.layer_backward(dy, *backward_args(args, fwd, seed), 0.3, h_, t)

            layer_sm90.reset_form_launches()
            with layer_sm90.recording() as record:
                res = kf()
                grads = kb(res)
            forms = layer_sm90.form_launches()
            res2 = kf()
            runs = [res + grads, res2 + kb(res2)]
            torch.cuda.synchronize()
            bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
            what = f"{'decoder' if decoder else 'encoder'} {shape} B {b} {dname}"
            check(bitwise, f"two runs with one seed differ, {what}")
            check(len(record) == len(route), f"{what}: {len(record)} launches, route "
                                             f"{len(route)}")
            form = layer_sm90.attention_form(t, d // h_, dtype)
            check(all(set(counts) == {form} for counts in forms.values()),
                  f"{what}: the attention launches took the forms {forms}, not {form}")
            timed = role or dict(kinds=None, plain=False, layer=None, warm=10)
            row = {"shape": shape, "B": b, "dtype": dname, "rate": 0.3,
                   "bitwise_repeat": bitwise, "attention_forms": forms,
                   "launches": sm90_launches(record, route, plain=timed["plain"],
                                             n=5 if role else 0, dtype=dtype,
                                             kinds=timed["kinds"], warm=timed["warm"],
                                             graph=timed.get("graph", False))}
            row["max_abs_err"], row["relu_kink_flips"] = against_twin(
                mod, args, dy, seed, 0.3, h_, res, grads, dtype, what, relative=True, t=t)
            if timed["layer"] == "device":
                row["kernel_fwd_device_ms"] = sum(
                    us for us, _ in device_us(kf, n=3).values()) / 1000.0
                row["kernel_bwd_device_ms"] = sum(
                    us for us, _ in device_us(lambda: kb(res), n=3).values()) / 1000.0
            if timed["layer"]:
                row["kernel_fwd_ms"] = time_us(kf, 5) / 1000.0
                row["kernel_bwd_ms"] = time_us(lambda: kb(res), 5) / 1000.0
                row["io_bounds"] = layer_io_bounds(b, decoder, dname, shape)
                row["library"] = library_layer(args, dy, b, decoder, shape,
                                               device=timed["layer"] == "device")
            (timings if role else checks).append(row)
    return {"checked": checks, "timings": timings}


def phase_layer(dev, rng) -> dict:
    """The encoder layer's chain, bf16 and f32, against
    ``encoder_layer_reference`` on the card. Bars: f32 atol 1e-4 on y and the
    residuals, and 1e-4 · max|grad| on each grad (sums taken in another order,
    the products in split TF32); bf16 2e-2 · max|ref| on everything (bf16
    rounds P, attention, y1, h and the weight grads, and the kernel rounds its
    backward's intermediates where the TPU kernel does, autograd does not).
    The masks are equal (the same Philox bytes). A hidden unit within
    rounding of 0 may fall on either side of the ReLU's kink: the twin takes
    the kernel's side at such units only (``kink_flips``: within
    ``KINK_BAND`` of 0, and few), and its own everywhere else."""
    h_, t = LAYER_SHAPE["h"], LAYER_SHAPE["t"]
    checks, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b in (32, 512):
        for dtype in (torch.float32, torch.bfloat16):
            args, dy = layer_case(dev, rng, b, dtype)
            for rate in (0.0, 0.3):
                seed = torch.tensor([1234 + b], dtype=torch.int32, device=dev)
                res = fl.layer_forward(*args, seed, rate, h_, t)
                grads = fl.layer_backward(dy, *layer_backward_args(args, res, seed), rate, h_, t)
                res2 = fl.layer_forward(*args, seed, rate, h_, t)
                grads2 = fl.layer_backward(dy, *layer_backward_args(args, res2, seed), rate, h_, t)
                torch.cuda.synchronize()
                bitwise = all(torch.equal(u, v) for u, v in zip(res + grads, res2 + grads2))
                check(bitwise, f"two runs with one seed differ at B {b} {dtype} rate {rate}")
                errs, kink = against_twin(fl, args, dy, seed, rate, h_, res, grads, dtype,
                                          f"at B {b} {dtype} rate {rate}")
                worst[dtype] = max(worst[dtype], *errs.values())
                checks.append({"B": b, "dtype": str(dtype)[6:], "rate": rate,
                               "max_abs_err": errs, "bitwise_repeat": bitwise,
                               "relu_kink_flips": kink})
    timings = []
    for b, dtype in LAYER_TIMINGS:
        args, dy = layer_case(dev, rng, b, dtype)
        seed = torch.tensor([7], dtype=torch.int32, device=dev)
        res = fl.layer_forward(*args, seed, 0.3, h_, t)
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        y_ref = fl.encoder_layer_reference(*leaves, seed, 0.3, h_, t)
        n = 20 if b == 32 else 5  # calls per timing, after 10 warm-up calls
        kf = lambda: fl.layer_forward(*args, seed, 0.3, h_, t)  # noqa: E731

        def kb(fwd=res):
            return fl.layer_backward(dy, *layer_backward_args(args, fwd, seed), 0.3, h_, t)

        def pf():
            with torch.no_grad():
                fl.encoder_layer_reference(*args, seed, 0.3, h_, t)

        pb = lambda: torch.autograd.grad(y_ref, leaves, dy, retain_graph=True)  # noqa: E731
        row = {"B": b, "dtype": str(dtype)[6:], "rate": 0.3}
        for key, k, p in (("fwd", kf, pf), ("bwd", kb, pb)):
            k1, p1, p2, k2 = (time_us(f, n) / 1000.0 for f in (k, p, p, k))
            row[f"{key}_kernel_ms"], row[f"{key}_plain_ms"] = [k1, k2], [p1, p2]
        row.update(layer_device_times(kf, kb, pf, pb))
        with layer_sm90.recording() as record:
            kb(kf())
        row["launches"] = sm90_launches(record, fl.route_kernels(dtype), plain=b == 32,
                                        n=20 if b == 32 else 5, dtype=dtype)
        row["io_bounds"] = layer_io_bounds(b, dtype=str(dtype)[6:])
        row["library"] = library_layer(args, dy, b, decoder=False)
        timings.append(row)
    wide = layer_route_cases(dev, rng, decoder=False, shapes=WIDE_SHAPES)
    long = layer_route_cases(dev, rng, decoder=False, shapes=LONG_SHAPES)
    emit({"phase": "layer", "shape": LAYER_SHAPE, "checks": checks,
          "bars": {"float32": "1e-4 abs (y, residuals); 1e-4 * max|grad| (grads)",
                   "bfloat16": "2e-2 * max|ref|"},
          "kink_survey": kink_survey(dev, decoder=False), "timings": timings,
          "f32_chain_drift": [chain_drift(dev, rng, ff) for ff in DRIFT_FFS], "wide": wide,
          "long": long})
    return {"max_abs_err": worst, "timings": timings, "wide": wide, "long": long}


def decoder_case(dev, rng, b: int, dtype, ff: int = LAYER_SHAPE["ff"], d: int = LAYER_SHAPE["d"],
                 t: int = LAYER_SHAPE["t"]):
    """Flagship-shaped decoder-layer inputs from ``rng`` (ff, d and T as
    given): (y, mem and the 20 parameters in ``fdl.ARG_NAMES`` order, dy)."""
    m = b * t

    def n(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    def w(out, inp):  # nn.Linear's (out, in) layout
        return n(out, inp, scale=inp ** -0.5).to(dtype)

    def vec(width):
        return n(width, scale=0.1)

    def gain():
        return n(d, scale=0.1, offset=1.0)

    args = [n(m, d).to(dtype), n(m, d).to(dtype), w(3 * d, d), vec(3 * d), w(d, d), vec(d),
            w(d, d), vec(d), w(2 * d, d), vec(2 * d), w(d, d), vec(d), gain(), vec(d),
            w(ff, d), vec(ff), w(d, ff), vec(d), gain(), vec(d), gain(), vec(d)]
    return args, n(m, d).to(dtype)


DEC_GRAD_NAMES = tuple("d" + name for name in ("x",) + fdl.ARG_NAMES[1:])


def decoder_backward_args(args, res, seed):
    a = dict(zip(fdl.ARG_NAMES, args))
    return (a["y"], a["mem"], *res[1:], *(a[k] for k in fdl.WEIGHT_NAMES),
            a["g1"], a["b1"], a["g2"], a["b2"], a["g3"], seed)


def phase_decoder_layer(dev, rng) -> dict:
    """The decoder layer's chain, bf16 and f32, against
    ``decoder_layer_reference`` on the card: y3, the seven residuals, dx, dmem
    and the 20 parameter grads. Bars, masks and ReLU kinks as
    ``phase_layer``'s."""
    h_, t = LAYER_SHAPE["h"], LAYER_SHAPE["t"]
    checks, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b in (32, 512):
        for dtype in (torch.float32, torch.bfloat16):
            args, dy = decoder_case(dev, rng, b, dtype)
            for rate in (0.0, 0.3):
                seed = torch.tensor([4321 + b], dtype=torch.int32, device=dev)
                res = fdl.layer_forward(*args, seed, rate, h_, t)
                grads = fdl.layer_backward(dy, *decoder_backward_args(args, res, seed),
                                           rate, h_, t)
                res2 = fdl.layer_forward(*args, seed, rate, h_, t)
                grads2 = fdl.layer_backward(dy, *decoder_backward_args(args, res2, seed),
                                            rate, h_, t)
                torch.cuda.synchronize()
                bitwise = all(torch.equal(u, v) for u, v in zip(res + grads, res2 + grads2))
                check(bitwise, f"decoder layer: two runs with one seed differ at B {b} "
                               f"{dtype} rate {rate}")
                errs, kink = against_twin(fdl, args, dy, seed, rate, h_, res, grads, dtype,
                                          f"decoder at B {b} {dtype} rate {rate}")
                worst[dtype] = max(worst[dtype], *errs.values())
                checks.append({"B": b, "dtype": str(dtype)[6:], "rate": rate,
                               "max_abs_err": errs, "bitwise_repeat": bitwise,
                               "relu_kink_flips": kink})
    timings = []
    for b, dtype in LAYER_TIMINGS:
        args, dy = decoder_case(dev, rng, b, dtype)
        seed = torch.tensor([7], dtype=torch.int32, device=dev)
        res = fdl.layer_forward(*args, seed, 0.3, h_, t)
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        y_ref = fdl.decoder_layer_reference(*leaves, seed, 0.3, h_, t)
        n = 12 if b == 32 else 3  # calls per timing, after 10 warm-up calls
        kf = lambda: fdl.layer_forward(*args, seed, 0.3, h_, t)  # noqa: E731

        def kb(fwd=res):
            return fdl.layer_backward(dy, *decoder_backward_args(args, fwd, seed), 0.3, h_, t)

        def pf():
            with torch.no_grad():
                fdl.decoder_layer_reference(*args, seed, 0.3, h_, t)

        pb = lambda: torch.autograd.grad(y_ref, leaves, dy, retain_graph=True)  # noqa: E731
        row = {"B": b, "dtype": str(dtype)[6:], "rate": 0.3}
        for key, k, p in (("fwd", kf, pf), ("bwd", kb, pb)):
            k1, p1, p2, k2 = (time_us(f, n) / 1000.0 for f in (k, p, p, k))
            row[f"{key}_kernel_ms"], row[f"{key}_plain_ms"] = [k1, k2], [p1, p2]
        row.update(layer_device_times(kf, kb, pf, pb))
        with layer_sm90.recording() as record:
            kb(kf())
        row["launches"] = sm90_launches(record, fdl.route_kernels(dtype), plain=b == 32,
                                        n=20 if b == 32 else 5, dtype=dtype)
        row["io_bounds"] = layer_io_bounds(b, decoder=True, dtype=str(dtype)[6:])
        row["library"] = library_layer(args, dy, b, decoder=True)
        timings.append(row)
    wide = layer_route_cases(dev, rng, decoder=True, shapes=WIDE_SHAPES)
    long = layer_route_cases(dev, rng, decoder=True, shapes=LONG_SHAPES)
    emit({"phase": "decoder_layer", "shape": LAYER_SHAPE, "checks": checks,
          "bars": {"float32": "1e-4 abs (y, residuals); 1e-4 * max|grad| (grads)",
                   "bfloat16": "2e-2 * max|ref|"},
          "kink_survey": kink_survey(dev, decoder=True), "timings": timings,
          "f32_chain_drift": [chain_drift(dev, rng, ff, decoder=True) for ff in DRIFT_FFS],
          "wide": wide, "long": long})
    return {"max_abs_err": worst, "timings": timings, "wide": wide, "long": long}


def model_params(hp: dict, **model):
    """``initialize_model``'s params from a YAML's hyperparameters."""
    return {"model": {"d_model": hp["d_model"], "n_heads": hp["n_heads"],
                      "dim_feedforward": hp["dim_feedforward"], "dropout": hp["dropout"],
                      "num_encoder_layers": hp["num_encoder_decoder_layers"],
                      "embedding_size_src": embedding_size_src_for(hp["experiment"]),
                      "optimizer": hp["optimizer_algorithm"], **model},
            "training": {"learning_rate": hp["learning_rate"], "batch_size": hp["batch_size"],
                         "seed": 0},
            "load_model": hp["load_model"]}


flagship_params = functools.partial(model_params, FLAGSHIP_HP)
# the wide config's runs ask for the FFN kernels: auto leaves them off at its
# batches, where they were measured no faster (phase 18 checks it); and the
# unfused layers, in which the FFN kernels run (the whole-layer path, which the
# bf16 gate now admits at ff 2048, is timed beside them)
lm_params = functools.partial(model_params, LM_HP, fused_ffn=True, fused_layer=False,
                              fused_decoder_layer=False)


class Loops:
    """Seeded synthetic loops (bench.py's recipe): ``processed_inputs``
    (N, t, 16) normal, ``processed_outputs`` HVO grids with 30 % hits; t 32
    steps (2 bars at sixteenths) unless given."""

    def __init__(self, n: int, seed: int, t: int = 32):
        rng = np.random.default_rng(seed)
        self.processed_inputs = rng.standard_normal((n, t, 16)).astype(np.float32)
        h = (rng.random((n, t, 9)) < 0.3).astype(np.float32)
        self.processed_outputs = np.concatenate(
            [h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)], axis=2
        ).astype(np.float32)


# encoder and decoder layer kernels: each dtype's chain, counted apart
SM90_LAYER_KERNELS = {**fl.SM90_KERNELS, **fdl.SM90_KERNELS}
F32_LAYER_KERNELS = {**fl.SM90_F32_KERNELS, **fdl.SM90_F32_KERNELS}
# the chains' wide route (d past layer_sm90.LN_TILE), each dtype's: 16 launches an
# encoder layer, 26 a decoder layer, the shared ones the counters above
WIDE_LAYER_KERNELS = {**fl.SM90_WIDE_KERNELS, **fdl.SM90_WIDE_KERNELS,
                      **fl.SM90_WIDE_F32_KERNELS, **fdl.SM90_WIDE_F32_KERNELS}
LAYER_KERNELS = {**SM90_LAYER_KERNELS, **F32_LAYER_KERNELS, **WIDE_LAYER_KERNELS}
N_FWD = {fl: 5, fdl: 9}  # each chain's forward launches, its first
N_WIDE_FWD = {fl: 7, fdl: 12}  # likewise in the wide route
# Past d 256 on the flagship's other hyperparameters: d 512 with 4 heads and ff
# 1,024 (a draw of configs/InfillingRandom_sweep.yaml; the turns behind
# LAYER_KERNEL_MAX_D), d 1,024 with one head of 1,024 and ff 1,024 (the widest
# head the JAX gate admits at d 1,024: phases 9 and 15's wide path) and d 512
# with one head of 512 and ff 512 (the sweep files' draw)
WIDE_HP = {**FLAGSHIP_HP, "d_model": 512, "n_heads": 4, "dim_feedforward": 1024}
WIDE_HEAD_HP = {**FLAGSHIP_HP, "d_model": 1024, "n_heads": 1, "dim_feedforward": 1024}
SWEEP_HEAD_HP = {**FLAGSHIP_HP, "d_model": 512, "n_heads": 1, "dim_feedforward": 512}
WIDE_DEC_LAYERS = 2  # the encoder-decoder's layers a side past d 256 (cut from 6)
SWEEP_HEAD_K = 4  # trials of the d 512 / 1-head ranking forward


def f32_step_launches(mod, steps: int, layers: int) -> dict:
    """What ``steps`` f32 training steps launch of ``mod``'s f32 chain over
    ``layers`` layers under ``fused_layers_as("kernel")``: each forward
    launch twice a layer call (it records h), each backward launch once."""
    return {k: (2 if i < N_FWD[mod] else 1) * steps * layers
            for i, k in enumerate(mod.SM90_F32_KERNELS)}


def paired_turns(models: dict, corpus, b: int, encoder_only: int = 1) -> dict:
    """seqs/s of ``models["kernel"]`` and ``models["unfused"]`` in
    ``F32_PAIRS`` pairs of turns run back to back (each pair's order swapped
    from the last; a warm-up epoch each first; no profiler): the turns, each
    pair's ratio, the worst pair's gain (its ratio − 1), each path's spread
    between its own turns (max / min − 1), and whether the worst pair gains
    by more than the larger spread."""
    for model in models.values():
        seqs_per_s(model, corpus, b, encoder_only)
    turns = {"kernel": [], "unfused": []}
    for i in range(F32_PAIRS):
        for which in ("kernel", "unfused") if i % 2 == 0 else ("unfused", "kernel"):
            turns[which].append(seqs_per_s(models[which], corpus, b, encoder_only))
    ratios = [k / u for k, u in zip(turns["kernel"], turns["unfused"])]
    spread = max(max(v) / min(v) - 1 for v in turns.values())
    return {"seqs_per_s": turns, "pair_ratios": ratios, "worst_pair_gain": min(ratios) - 1,
            "spread": spread, "gains": min(ratios) - 1 > spread}


def launches(kernels) -> dict:
    return {name: f.launches for name, f in kernels.items()}


def reset_mha_forms() -> None:
    """#1's launches by form (``attention.FORM_LAUNCHES``) set to 0."""
    for form in attention.FORM_LAUNCHES:
        attention.FORM_LAUNCHES[form] = 0


def mha_forms() -> dict:
    """#1's launches by form since ``reset_mha_forms``, those that took any."""
    return {form: n for form, n in attention.FORM_LAUNCHES.items() if n}


def reset_launches() -> None:
    for f in (*LAYER_KERNELS.values(), *ffn.KERNELS.values(), *ln.KERNELS.values()):
        f.launches = 0
    layer_sm90.reset_form_launches()


def run_epochs(bundle, data, held, epochs: int, batch: int, encoder_only: int = 1,
               penalty: float = FLAGSHIP_HP["hit_loss_penalty"]) -> list:
    return [train_loop(dataset=data, groove_transformer=bundle, epoch=e, batch_size=batch,
                       encoder_only=encoder_only, hit_loss_penalty=penalty,
                       validation_inputs=held.processed_inputs,
                       validation_gt=held.processed_outputs) for e in range(epochs)]


def seqs_per_s(bundle, data, batch: int, encoder_only: int = 1) -> float:
    """One epoch through ``train_loop`` (it ends in the metrics' fetch)."""
    t0 = time.perf_counter()
    train_loop(dataset=data, groove_transformer=bundle, batch_size=batch,
               encoder_only=encoder_only, hit_loss_penalty=FLAGSHIP_HP["hit_loss_penalty"])
    return len(data.processed_inputs) / (time.perf_counter() - t0)


def step_breakdown(bundle, b: int, seed: int, encoder_only: int = 1, count=()) -> dict:
    """Where a step's host and device time goes: two steps on 2·b loops; with
    ``count``, the device launches a step of the kernels whose names hold each
    of those strings."""
    small = Loops(2 * b, seed)
    seqs_per_s(bundle, small, b, encoder_only)
    t0 = time.perf_counter()
    seqs_per_s(bundle, small, b, encoder_only)
    host = (time.perf_counter() - t0) / 2
    per_kernel = device_us(lambda: seqs_per_s(bundle, small, b, encoder_only), n=2)
    total = sum(us for us, _ in per_kernel.values()) / 2
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {"step_host_ms": host * 1e3, "step_device_ms": total / 1e3,
            "device_busy_share": total / 1e6 / host,
            "launches_per_step": sum(c for _, c in per_kernel.values()) / 2,
            "top_kernels_us_per_step": {k: us / 2 for k, (us, _) in top},
            **({"launches_per_step_of": {name: sum(c for k, (_, c) in per_kernel.items()
                                                   if name in k) / 2 for name in count}}
               if count else {})}


def wide_training(dev, decoder: bool) -> dict:
    """The chains' wide route in training, the encoder-only family (or the
    encoder-decoder with ``decoder``). (a) ``WIDE_HEAD_HP`` (d 1,024, one head
    of 1,024, ff 1,024; 6 layers, the encoder-decoder at ``WIDE_DEC_LAYERS``
    a side) with the chain forced (auto leaves it off past
    ``LAYER_KERNEL_MAX_D``), the counts reset just before: one bf16 epoch of
    4 steps, then 2 f32 steps, each with its held-out loss through #1 at hd
    1,024 (the parent raised there): every launch of the route once a layer
    and step, #1 once a layer's attention in a held-out forward, the loss
    finite. Encoder family: the f32 weights carried through the JAX layout
    (``torch_compat``) to ``InfillServer``, which answers a B 1 request and a
    bucket of 32 through #1 at hd 1,024 (6 launches a chunk) within 1e-4 of
    the plain path on the CPU; and the sweep files' draw ``SWEEP_HEAD_HP`` (d
    512, one head of 512) on #1 in an eval forward and in the vmapped ranking
    forward of ``SWEEP_HEAD_K`` trials (6 launches for all of them), each
    trial's loss within the dtype's bar of its eager eval forward. (b)
    ``WIDE_HP`` (d 512, 4 heads, ff 1,024; the encoder-decoder at
    ``WIDE_DEC_LAYERS`` a side), the chain against the unfused path in
    ``F32_PAIRS`` pairs of turns, each dtype at batch 32 and 512, and what
    auto picks there."""
    if decoder:
        forced, unfused = ({"fused_layer": v, "fused_decoder_layer": v} for v in (True, False))
        resolve, enc_only = resolve_fused_decoder_layer, 0
        layers = WIDE_DEC_LAYERS
    else:
        forced, unfused = {"fused_layer": True}, {"fused_layer": False}
        resolve, enc_only = resolve_fused_layer, 1
        layers = FLAGSHIP_HP["num_encoder_decoder_layers"]
    d, held, batch = WIDE_HEAD_HP["d_model"], Loops(64, 42), FLAGSHIP_HP["batch_size"]
    path = {}
    for dtype, items in ((torch.bfloat16, 128), (torch.float32, 64)):
        dname, steps = str(dtype)[6:], items // batch
        hp = {**WIDE_HEAD_HP, "num_encoder_decoder_layers": layers}
        extra = {"num_decoder_layers": layers} if decoder else {}
        bundle, _, _ = initialize_model(
            model_params(hp, bf16=dtype == torch.bfloat16, **forced, **extra), dev)
        check(bundle.config.compute_dtype == dtype, f"{bundle.config} is not {dtype}")
        route = {**fl.route_kernels(dtype, d), **(fdl.route_kernels(dtype, d) if decoder else {})}
        reset_launches()  # the main path's run starts here
        MHA.launches = 0
        metrics = run_epochs(bundle, Loops(items, 41), held, 1, batch, enc_only)[0]
        torch.cuda.synchronize()
        counts, mha = launches(route), MHA.launches  # ... and ends here
        check(all(c == steps * layers for c in counts.values()),
              f"wide route, {dname}: launches {counts}, expected {steps * layers} each")
        check(mha == (3 if decoder else 1) * layers,
              f"#1 launched {mha} times in a held-out forward")
        check(all(np.isfinite(v) for v in metrics.values()), f"non-finite: {metrics}")
        path[dname] = {"launches": counts, "fused_mha_launches": mha, "steps": steps,
                       "metrics": metrics}
    out = {"path": path}
    if not decoder:
        out["served"] = wide_served(dev, bundle)
        out["sweep_draw"] = sweep_head_draw(dev)
    turns = {}
    extra = {"num_encoder_decoder_layers": WIDE_DEC_LAYERS} if decoder else {}
    small, big = Loops(256, 43), Loops(1024, 43)  # 8 and 2 steps a turn
    for dtype in (torch.bfloat16, torch.float32):
        hp = {**WIDE_HP, **extra}
        for b in THROUGHPUT_BATCHES:
            models = {which: initialize_model(model_params(
                hp, bf16=dtype == torch.bfloat16, **switches,
                **({"num_decoder_layers": hp["num_encoder_decoder_layers"]} if decoder else {})),
                dev)[0] for which, switches in (("kernel", forced), ("unfused", unfused))}
            row = paired_turns(models, small if b == batch else big, b, enc_only)
            row["auto_picks_kernel"] = resolve(None, WIDE_HP["d_model"], WIDE_HP["n_heads"],
                                               WIDE_HP["dim_feedforward"], compute_dtype=dtype,
                                               batch_size=b)
            turns[f"{str(dtype)[6:]}_B{b}"] = row
    return {**out, "paired_turns": turns}


def wide_served(dev, bundle) -> dict:
    """The f32 weights of ``bundle`` (``WIDE_HEAD_HP``, encoder-only) carried
    through the JAX layout (``torch_compat``) to an ``InfillServer`` on the
    card: a B 1 request and a bucket of 32 through #1 at hd 1,024, 6
    launches a forward chunk, hits thresholded, v/o within 1e-4 of the plain
    path on the CPU."""
    config = dataclasses.replace(FLAGSHIP, d_model=WIDE_HEAD_HP["d_model"],
                                 n_heads=WIDE_HEAD_HP["n_heads"],
                                 dim_feedforward=WIDE_HEAD_HP["dim_feedforward"])
    flax = torch_compat.flax_params_from_state_dict(bundle.model.state_dict(), config)
    sd = torch_compat.state_dict_from_flax_params(flax, config)
    srv = serve.InfillServer(sd, config, batch_sizes=BUCKETS, device=dev)
    cpu_model = build_model(config, "cpu")
    cpu_model.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(7)
    out = {}
    for n in (1, 32):
        x = rng.standard_normal((n, 32, 16)).astype(np.float32)
        MHA.launches = 0
        y = srv.infill(x)
        mha = MHA.launches
        check(mha == 6, f"a bucket-{n} request at hd 1,024 launched #1 {mha} times, not 6")
        check(y.shape == (n, 32, 27) and np.isfinite(y).all()
              and set(np.unique(y[..., :9])) <= {0.0, 1.0}, f"bad output at N={n}")
        _, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(x))
        err = max(max_err(y[..., 9:18], v_cpu), max_err(y[..., 18:], o_cpu))
        check(err <= 1e-4, f"hd 1,024 server at N={n}: v/o differ from the CPU by {err}")
        out[f"N{n}"] = {"fused_mha_launches": mha, "max_abs_err_vs_cpu": err}
    return out


def sweep_head_draw(dev) -> dict:
    """The sweep files' draw d 512 / one head (``SWEEP_HEAD_HP``) on #1: an
    eval forward of trial 0 (6 launches) and the vmapped ranking forward of
    ``SWEEP_HEAD_K`` trials' stacked weights (``stacked_eval_loss``: 6
    launches for all of them, #1's vmap rule folding the trials), each
    trial's loss within the dtype's bar of its eager eval forward."""
    from transformergrooveinfilling_tpu_torch import sweep
    from transformergrooveinfilling_tpu_torch.train import vmap_sweep
    from transformergrooveinfilling_tpu_torch.train.loop import make_eval_loss_fn

    config = sweep.batched_config(HyperParams.from_dict(SWEEP_HEAD_HP), SWEEP_HEAD_HP, dev)
    check(config.use_fused_attention and config.d_model // config.n_heads == 512,
          f"the d 512 / 1-head sweep config: {config}")
    model = build_model(config, dev)
    params = vmap_sweep.init_stacked_params(model, config, SWEEP_HEAD_K,
                                            torch.Generator().manual_seed(3), dev)
    loops = Loops(1099, 44)  # the validation evaluator's rows (phase 22)
    x = torch.as_tensor(loops.processed_inputs, device=dev)
    y = torch.as_tensor(loops.processed_outputs, device=dev)
    pens = [SWEEP_HEAD_HP["hit_loss_penalty"] * (1 + 0.1 * k) for k in range(SWEEP_HEAD_K)]
    MHA.launches = 0
    stacked = vmap_sweep.stacked_eval_loss(model, params, x, y, pens, device=dev).tolist()
    ranking = MHA.launches
    check(ranking == config.num_encoder_layers,
          f"the stacked ranking forward launched #1 {ranking} times")
    eager, per_forward = [], []
    for k in range(SWEEP_HEAD_K):
        model.load_state_dict({name: v[k] for name, v in params.items()})
        MHA.launches = 0
        eager.append(float(make_eval_loss_fn(pens[k])(model, x, y)["loss"]))
        per_forward.append(MHA.launches)
    check(per_forward == [config.num_encoder_layers] * SWEEP_HEAD_K,
          f"eval forwards launched #1 {per_forward} times")
    err = max(abs(a - b) / abs(b) for a, b in zip(stacked, eager))
    check(all(np.isfinite(stacked)) and err <= max(MHA_BARS[config.compute_dtype][0], 1e-5),
          f"stacked eval losses {stacked} against eager {eager}")
    return {"config": SWEEP_HEAD_HP, "dtype": str(config.compute_dtype)[6:],
            "trials": SWEEP_HEAD_K, "rows": x.shape[0],
            "fused_mha_launches_ranking_forward": ranking,
            "fused_mha_launches_eval_forward": per_forward,
            "stacked_eval_losses": stacked, "eager_eval_losses": eager,
            "max_rel_err": err}


def long_training(dev, decoder: bool) -> dict:
    """8-bar loops (``LONG_T``): the flagship (the 6 + 6 encoder-decoder
    with ``decoder``) at ``max_len`` 128 through ``initialize_model``, the
    chains given (auto follows ``LAYER_KERNEL_LONG_T``), the counts reset
    just before: a bf16 epoch of 4 steps and 2 f32 steps on loops of 128
    steps, each with its held-out loss through #1: every launch of the
    chain once a layer and step (the attention's long route), #1 once a
    layer's attention in the held-out forward, the loss finite. The f32
    weights served at T 128 (``long_served``). Then the chains against the
    unfused path in ``F32_PAIRS`` pairs of turns at batch 32 in each dtype
    (4 steps a turn; the turns behind ``LAYER_KERNEL_LONG_T``), and what auto
    picks there."""
    if decoder:
        forced, unfused = ({"fused_layer": v, "fused_decoder_layer": v} for v in (True, False))
        resolve, enc_only = resolve_fused_decoder_layer, 0
        extra = {"num_decoder_layers": ENCDEC_LAYERS}
    else:
        forced, unfused = {"fused_layer": True}, {"fused_layer": False}
        resolve, enc_only, extra = resolve_fused_layer, 1, {}
    layers = FLAGSHIP_HP["num_encoder_decoder_layers"]
    held, batch = Loops(64, 52, LONG_T), FLAGSHIP_HP["batch_size"]
    path = {}
    for dtype, items in ((torch.bfloat16, 128), (torch.float32, 64)):
        dname, steps = str(dtype)[6:], items // batch
        bundle, _, _ = initialize_model(flagship_params(
            bf16=dtype == torch.bfloat16, max_len=LONG_T, **forced, **extra), dev)
        check(bundle.config.compute_dtype == dtype and bundle.config.max_len == LONG_T,
              f"{bundle.config} is not {dtype} at max_len {LONG_T}")
        route = {**fl.route_kernels(dtype), **(fdl.route_kernels(dtype) if decoder else {})}
        reset_launches()  # the main path's run starts here
        MHA.launches = 0
        reset_mha_forms()
        metrics = run_epochs(bundle, Loops(items, 51, LONG_T), held, 1, batch, enc_only)[0]
        torch.cuda.synchronize()
        counts, mha, forms = launches(route), MHA.launches, mha_forms()  # ... and ends here
        chain_forms = layer_sm90.form_launches()
        check(all(c == steps * layers for c in counts.values()),
              f"T {LONG_T}, {dname}: launches {counts}, expected {steps * layers} each")
        form = layer_sm90.attention_form(LONG_T, FLAGSHIP.d_model // FLAGSHIP.n_heads, dtype)
        check(chain_forms == {kind: {form: sum(c for name, c in counts.items()
                                               if name.endswith(kind))}
                              for kind in ("attn_fwd", "attn_bwd")},
              f"T {LONG_T}, {dname}: the chains' attention took the forms {chain_forms}, "
              f"expected every launch {form}")
        check(mha == (3 if decoder else 1) * layers and forms == {"flash": mha},
              f"#1 launched {mha} times ({forms}) in a held-out forward at T {LONG_T}")
        check(all(np.isfinite(v) for v in metrics.values()), f"non-finite: {metrics}")
        path[dname] = {"launches": counts, "fused_mha_launches": mha,
                       "fused_mha_launches_by_form": forms, "attention_forms": chain_forms,
                       "steps": steps, "metrics": metrics}
    served = long_served(dev, bundle, decoder)
    turns = {}
    for dtype in (torch.bfloat16, torch.float32):
        models = {which: initialize_model(flagship_params(
            bf16=dtype == torch.bfloat16, max_len=LONG_T, **switches, **extra), dev)[0]
            for which, switches in (("kernel", forced), ("unfused", unfused))}
        row = paired_turns(models, Loops(128, 53, LONG_T), batch, enc_only)
        row["auto_picks_kernel"] = resolve(None, FLAGSHIP.d_model, FLAGSHIP.n_heads,
                                           FLAGSHIP.dim_feedforward, compute_dtype=dtype,
                                           seq_len=LONG_T, batch_size=batch)
        turns[f"{str(dtype)[6:]}_B{batch}_T{LONG_T}"] = row
    return {"path": path, "served": served, "paired_turns": turns}


def long_served(dev, bundle, decoder: bool) -> dict:
    """The f32 weights of ``bundle`` served at T ``LONG_T`` by an
    ``InfillServer`` on the card: a B 1 request and a bucket of 32, MSO input
    and ``hvo_input`` at 120 bpm (the front end's kernels once a request),
    through #1 (6 launches a forward chunk, 18 for the 6 + 6), v/o within
    1e-4 of the plain path's server on the card (``use_kernel=False``,
    unthresholded) and the hits equal away from the threshold."""
    config = dataclasses.replace(ENCDEC if decoder else FLAGSHIP, max_len=LONG_T)
    sd = {k: v.detach() for k, v in bundle.model.state_dict().items()}
    srv, raw = (serve.InfillServer(sd, config, batch_sizes=BUCKETS, device=dev, **kw)
                for kw in ({}, {"use_kernel": False, "use_thres": False}))
    per_chunk = config.num_encoder_layers + 2 * config.num_decoder_layers
    out = {}
    for n in (1, 32):
        loops = Loops(n, 54 + n, LONG_T)
        for which in ("mso_input", "hvo_input"):
            def answer(server):
                if which == "mso_input":
                    return server.infill(loops.processed_inputs)
                return server.infill_from_hvo(loops.processed_outputs, qpm=120.0)

            MHA.launches = 0
            reset_mha_forms()
            layer_sm90.reset_form_launches()
            reset_front_end_launches()
            y = answer(srv)
            counts = {"fused_mha": MHA.launches, "band_energies": BAND_K.launches,
                      "device_synth": SYNTH_K.launches}
            forms, chain_forms = mha_forms(), layer_sm90.form_launches()
            check(chain_forms == {"attn_fwd": {}, "attn_bwd": {}},
                  f"a {which} request at T {LONG_T} launched the chains' attention: "
                  f"{chain_forms}")
            front = int(which == "hvo_input")
            check(counts == {"fused_mha": per_chunk, "band_energies": front,
                             "device_synth": front} and forms == {"flash": per_chunk},
                  f"a {which} request of {n} at T {LONG_T} launched {counts} ({forms})")
            want = answer(raw)
            sig = want[..., :9]
            check(y.shape == (n, LONG_T, 27) and np.isfinite(y).all(),
                  f"bad {which} answer at T {LONG_T}, N={n}")
            err = max_err(y[..., 9:], want[..., 9:])
            check(err <= 1e-4, f"{which} at T {LONG_T}, N={n}: v/o differ from the plain path "
                               f"by {err}")
            check(hit_agreement(y[..., :9], (sig > 0.5).astype(y.dtype), sig),
                  f"{which} at T {LONG_T}, N={n}: hits differ away from the threshold")
            out[f"{which}_N{n}"] = {"launches": counts, "fused_mha_launches_by_form": forms,
                                    "chain_attention_forms": chain_forms,
                                    "max_abs_err_vs_plain": err}
    return out


@contextlib.contextmanager
def fused_layers_as(role: str, kernel_h: list, kinks: list):
    """Stand-ins for the model's two fused layer functions, for comparing a
    few f32 steps of the kernel path with its twins. A hidden unit within
    rounding of 0 can fall on either side of the ReLU's kink, and one such
    unit moves a W1 row by lr·|grad| (on an H100: one unit of one layer in
    the first step, 1.2e-4). So as ``"kernel"`` every fused layer call also
    records the kernel's h_drop into ``kernel_h``; as ``"twin"`` the twin runs
    in place of the kernels and takes the kernel's side at the units where
    ``kink_flips`` finds the two within rounding of 0 (their number per call
    goes into ``kinks``), its own side everywhere else. Any other role leaves
    the model as it is."""
    # per module: the train function, kernel forward, twin, tensor arguments, h's place
    specs = ((fl, "encoder_layer_train", fl.layer_forward, fl.encoder_layer_reference, 14, 3),
             (fdl, "decoder_layer_train", fdl.layer_forward, fdl.decoder_layer_reference, 23, 6))
    replay = iter(kernel_h)

    def stand_in(mod, name, forward, reference, n_tensors, h_at):
        train = getattr(mod, name)

        def recording(*a):
            kernel_h.append(forward(*[t.detach() for t in a[:n_tensors]], *a[n_tensors:])[h_at])
            return train(*a)

        def replaying(*a):
            with torch.no_grad():
                own_h = reference(*[t.detach() for t in a[:n_tensors]], *a[n_tensors:],
                                  return_residuals=True)[h_at]
            flips, kink = fl.kink_flips(own_h, next(replay).to(own_h.device))
            kinks.append(kink["flips"])
            return reference(*a, relu_flips=flips)

        return {"kernel": recording, "twin": replaying}.get(role, train)

    saved = {name: getattr(transformer, name) for _, name, *_ in specs}
    for spec in specs:
        setattr(transformer, spec[1], stand_in(*spec))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(transformer, name, fn)


def phase_train(dev, rng) -> dict:
    # 1,024 loops for the epochs and the batch-32 rates, 2,048 (4 steps) at
    # batch 512; the twin, ~10x slower at batch 32, takes a quarter
    data, held, twin_data, big = Loops(1024, 1), Loops(256, 2), Loops(256, 1), Loops(2048, 1)
    batch, epochs = FLAGSHIP_HP["batch_size"], 3
    steps = epochs * (len(data.processed_inputs) // batch)
    bundle, _, _ = initialize_model(flagship_params(), dev)
    check(bundle.config.fused_layer and bundle.config.compute_dtype == torch.bfloat16,
          f"auto policy did not pick the kernel in bf16: {bundle.config}")
    reset_launches()  # the main path's run starts here
    MHA.launches = 0
    t0 = time.perf_counter()
    metrics = run_epochs(bundle, data, held, epochs, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches(fl.SM90_KERNELS)  # ... and ends here
    n_layers = FLAGSHIP_HP["num_encoder_decoder_layers"]
    check(all(c == steps * n_layers for c in counts.values())
          and not any(launches(F32_LAYER_KERNELS).values()),
          f"layer launches {counts}, expected {steps * n_layers} each ({steps} steps x "
          f"{n_layers} layers), and the f32 chain {launches(F32_LAYER_KERNELS)}, expected 0")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    plain, _, _ = initialize_model(flagship_params(fused_layer=False), dev)
    before = launches(LAYER_KERNELS)
    plain_metrics = run_epochs(plain, data, held, epochs, batch)
    plain_losses = [m["loss"] for m in plain_metrics]
    check(launches(LAYER_KERNELS) == before, "fused_layer=False launched a layer kernel")
    check(all(np.isfinite(plain_losses)) and plain_losses[-1] < plain_losses[0],
          f"plain path loss did not fall: {plain_losses}")

    # 3 f32 steps at dropout 0: the kernel path against its twin on the card
    # and on the CPU. A hidden unit within rounding of 0 can fall on either
    # side of the ReLU's kink, and one such unit moves a W1 row by lr·|grad|
    # (on an H100: one unit of layer 1 in the first step, 1.2e-4). So the
    # kernel path records its h_drop for each layer and step, and the twins
    # take the kernel's side at the units where ``kink_flips`` finds the two
    # within rounding of 0, their own side everywhere else
    # (``fused_layers_as``). The unfused plain path on the card cannot; it is
    # held to UNFUSED_BAR.
    kernel_h, kinks = [], []
    x = torch.from_numpy(data.processed_inputs[:96]).to(dev)
    y = torch.from_numpy(data.processed_outputs[:96]).to(dev)
    three = {}
    reset_launches()  # the f32 route's path: its kernels launch here only
    for name, device, fused in (("kernel", dev, True), ("card_twin", dev, True),
                                ("cpu_twin", torch.device("cpu"), True),
                                ("card_unfused", dev, False)):
        b, _, _ = initialize_model(flagship_params(bf16=False, dropout=0.0, fused_layer=fused),
                                   device)
        step = make_train_step(FLAGSHIP_HP["hit_loss_penalty"])
        gen = torch.Generator(device).manual_seed(0)
        with fused_layers_as("twin" if name.endswith("twin") else name, kernel_h, kinks):
            for i in range(3):
                step(b.state, x[32 * i:32 * i + 32].to(device),
                     y[32 * i:32 * i + 32].to(device), None, gen)
        three[name] = {k: v.detach().cpu() for k, v in b.model.state_dict().items()}
    f32_counts = launches(fl.SM90_F32_KERNELS)  # ... and ends here
    check(f32_counts == f32_step_launches(fl, 3, n_layers)
          and not any(launches(SM90_LAYER_KERNELS).values()),
          f"3 f32 steps launched {launches(LAYER_KERNELS)}")
    param_err = {other: max(max_err(three["kernel"][k], three[other][k]) for k in three["kernel"])
                 for other in ("card_twin", "cpu_twin", "card_unfused")}
    check(max(param_err["card_twin"], param_err["cpu_twin"]) <= 1e-4
          and param_err["card_unfused"] <= UNFUSED_BAR,
          f"3 f32 steps: params differ by {param_err} (kink flips per layer call: {kinks})")

    # throughput, kernel / twin / unfused in turns, at batch 32 and bench.py's 512
    throughput = {}
    for b in THROUGHPUT_BATCHES:
        runs = {"kernel": [], "twin": [], "unfused": []}
        models = {"kernel": initialize_model(flagship_params(), dev)[0],
                  "twin": initialize_model(flagship_params(), dev)[0],
                  "unfused": initialize_model(flagship_params(fused_layer=False), dev)[0]}
        for which in ("kernel", "twin", "unfused", "unfused", "twin", "kernel"):
            saved = transformer.encoder_layer_train
            if which == "twin":
                transformer.encoder_layer_train = fl.encoder_layer_reference
            corpus = twin_data if which == "twin" else data if b == batch else big
            try:
                seqs_per_s(models[which], corpus, b)  # warm-up epoch
                runs[which].append(seqs_per_s(models[which], corpus, b))
            finally:
                transformer.encoder_layer_train = saved
        throughput[b] = runs

    # where a step's device time goes (kernel path)
    breakdown = {b: step_breakdown(initialize_model(flagship_params(), dev)[0], b, 3)
                 for b in THROUGHPUT_BATCHES}

    # f32 (bf16: false), the f32 chain against fused_layer=False in paired
    # turns: the numbers that set LAYER_KERNEL_MAX_BATCH[torch.float32]
    f32_turns = {}
    for b in THROUGHPUT_BATCHES:
        models = {which: initialize_model(flagship_params(bf16=False, fused_layer=fused), dev)[0]
                  for which, fused in (("kernel", True), ("unfused", False))}
        check(models["kernel"].config.compute_dtype == torch.float32,
              f"bf16=False did not train in f32: {models['kernel'].config}")
        f32_turns[b] = paired_turns(models, data if b == batch else big, b)
        f32_turns[b]["auto_picks_kernel"] = resolve_fused_layer(
            None, FLAGSHIP.d_model, FLAGSHIP.n_heads, FLAGSHIP.dim_feedforward,
            compute_dtype=torch.float32, batch_size=b)

    wide = wide_training(dev, decoder=False)
    long = long_training(dev, decoder=False)

    # the trained weights served by the serving slice, against the CPU plain path
    sd = {k: v.detach().cpu() for k, v in bundle.model.state_dict().items()}
    srv = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev)
    xs = rng.standard_normal((6, 32, 16)).astype(np.float32)
    served = srv.infill(xs)
    cpu_model = build_model(FLAGSHIP, "cpu")
    cpu_model.load_state_dict(sd, strict=True)
    _, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(xs))
    serve_err = max(max_err(served[..., 9:18], v_cpu), max_err(served[..., 18:], o_cpu))
    check(serve_err <= 1e-4, f"trained weights served: v/o differ from the CPU by {serve_err}")
    emit({"phase": "train", "config": FLAGSHIP_HP,
          "data": "1024 seeded synthetic loops (2048 for the rates at batch 512)",
          "epochs": epochs, "steps": steps, "seconds": seconds, "launches": counts,
          "launches_per_step": {k: c / steps for k, c in counts.items()},
          "three_f32_steps_launches": f32_counts,
          "losses": losses, "last_metrics": metrics[-1], "plain_losses": plain_losses,
          "three_f32_steps_param_err": param_err,
          "three_f32_steps_kink_flips": kinks, "unfused_bar": UNFUSED_BAR,
          "seqs_per_s": throughput, "step_breakdown": breakdown,
          "f32_paired_turns": f32_turns, "served_max_abs_err_vs_cpu": serve_err,
          "wide": wide, "long": long})
    return {"launches": counts, "f32_launches": f32_counts, "seqs_per_s": throughput,
            "f32_paired_turns": f32_turns, "wide": wide, "long": long}


def augment_corpus():
    """The audio-augmented training phase's corpus: 256 seeded loops and their
    tempos."""
    return (Loops(256, 26).processed_outputs,
            np.random.default_rng(27).uniform(90.0, 150.0, 256))


@contextlib.contextmanager
def plain_front_end():
    """Route the front end through the kernels' plain versions, on whatever
    device the tensors are (the card included), for comparisons."""
    saved = (ds.synth_events, be.band_energies, be.band_energies_from_audio)
    ds.synth_events = lambda onset, row, gain, table, lengths, length: \
        ds.synth_events_plain(onset, row, gain, table, length)
    be.band_energies = be.band_energies_plain
    be.band_energies_from_audio = be.band_energies_from_audio_plain
    try:
        yield
    finally:
        ds.synth_events, be.band_energies, be.band_energies_from_audio = saved


def reset_front_end_launches() -> None:
    BAND_K.launches = SYNTH_K.launches = 0


def events_for(dev, grids: np.ndarray, qpm, params):
    """The synthesizer's inputs for ``grids`` at one tempo, or at one tempo per
    item (the waveform is then as long as the slowest needs, as the front end
    makes it): (onset, row, gain, table, lengths, length)."""
    table, _, luts, _, lengths = ds.pack_tables([None], params.sr, device=dev)
    m = grids.shape[0]
    zeros = torch.zeros(m, dtype=torch.int32, device=dev)
    qpms = np.broadcast_to(np.asarray(qpm, np.float64), (m,))
    sps = torch.from_numpy((qpms / 60.0 * 4.0).astype(np.float32)).to(dev)
    length = mso.mso_waveform_length(grids.shape[1], float(qpms.min() / 60.0 * 4.0), params)
    onset, row, gain = ds._extract_events(torch.from_numpy(grids).to(dev), sps, zeros, length,
                                          float(params.sr), luts, zeros)
    return onset, row, gain, table, lengths, length


def timed(kernel, plain, n_plain: int = 20) -> dict:
    """Stream ms in turns (kernel, plain, plain, kernel), the kernel's ms on
    the host clock over 20 queued calls and one synchronize, and the
    profiler's device ms. The profiler may report fewer launches than were
    made (``kernel_device_launches`` below 1 per call: it lost events), so the
    kernel's device time is the mean per captured launch, summed over the
    wrapper's kernels, each of which launches once per call."""
    k1, p1, p2, k2 = (time_us(kernel, 50), time_us(plain, n_plain), time_us(plain, n_plain),
                      time_us(kernel, 50))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        kernel()
    torch.cuda.synchronize()
    queued = (time.perf_counter() - t0) * 1e3 / 20
    dev_k, dev_p = device_us(kernel, 10), device_us(plain, 3)
    return {"kernel_ms": [k1 / 1e3, k2 / 1e3], "plain_ms": [p1 / 1e3, p2 / 1e3],
            "kernel_host_queued_ms": queued,
            "kernel_device_ms": sum(us / c for us, c in dev_k.values()) / 1e3,
            "kernel_device_launches": sum(c for _, c in dev_k.values()),
            "plain_device_ms": sum(us for us, _ in dev_p.values()) / 1e3,
            "plain_device_launches": sum(c for _, c in dev_p.values())}


def index_add_yardstick(dev, onset, row, gain, table, lengths, length):
    """The synthesizer's library yardstick: ONE ``index_add_`` over indices
    and sources prepared outside the timed call (the port never calls it),
    checked against the kernel → (flat output, index, source, kernel's
    waveforms)."""
    m = onset.shape[0]
    live = (gain != 0).nonzero()
    o, r = onset[live[:, 0], live[:, 1]].long(), row[live[:, 0], live[:, 1]].long()
    span = (o + lengths[r]).clamp(max=length) - o
    event = torch.repeat_interleave(torch.arange(len(span), device=dev), span)
    within = torch.arange(int(span.sum()), device=dev) - (span.cumsum(0) - span)[event]
    index = (live[:, 0] * length + o)[event] + within
    source = gain[live[:, 0], live[:, 1]][event] * table[r[event], within]
    del event, within
    flat = torch.zeros(m * length, device=dev)
    flat.index_add_(0, index, source)
    want = SYNTH(onset, row, gain, table, lengths, length)
    lib_err = max_err(flat.view(m, length), want)
    check(lib_err <= 1e-5, f"index_add_ yardstick differs from the kernel by {lib_err}")
    return flat, index, source, want


def phase_front_end_kernels(dev, rng) -> dict:
    params = mso.MSOParams()
    _, fb_t = mso._filterbank(params, dev)
    loops = Loops(64, 21).processed_outputs
    hann = mso.hann_window(params.win_length, dev)

    # device_synth against its plain version, bit for bit: M 1 and 64 at three
    # tempos, then the shapes the serving and training phases give it
    aug_grids, aug_qpms = augment_corpus()
    serve_loops = Loops(40, 25).processed_outputs
    main_path = [(serve_loops[:1], 90.0), (serve_loops[:6], 120.0), (serve_loops, 150.0),
                 (aug_grids, aug_qpms)]
    cases = ([(grids[:m], qpm) for grids, m in ((loops, 1), (loops, 64), (aug_grids, 256))
              for qpm in (90.0, 120.0, 150.0)] + main_path)
    synth_checks, worst_synth = [], 0.0
    for grids, qpm in cases:
        m, tempo = len(grids), qpm if np.isscalar(qpm) else [qpm.min(), qpm.max()]
        onset, row, gain, table, lengths, length = events_for(dev, grids, qpm, params)
        got = SYNTH(onset, row, gain, table, lengths, length)
        again = SYNTH(onset, row, gain, table, lengths, length)
        torch.cuda.synchronize()
        want = ds.synth_events_plain(onset, row, gain, table, length)
        err = max_err(got, want)
        worst_synth = max(worst_synth, err)
        check(torch.equal(got, want), f"device_synth != plain version at M {m}, {tempo} bpm: "
                                      f"max abs err {err}")
        check(torch.equal(got, again), f"device_synth reruns differ at M {m}, {tempo} bpm")
        check(bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0.1,
              "device_synth rendered silence")
        synth_checks.append({"M": m, "qpm": tempo, "length": length, "max_abs_err": err,
                             "bitwise_equal": True, "bitwise_repeat": True,
                             "live_events": int((gain != 0).sum())})
        del got, again, want
    synth_timings = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, grids in ((1, loops), (64, loops), (256, aug_grids)):
        onset, row, gain, table, lengths, length = events_for(dev, grids[:m], 120.0, params)
        row_t = timed(lambda: SYNTH(onset, row, gain, table, lengths, length),
                      lambda: ds.synth_events_plain(onset, row, gain, table, length), 3)
        flat, index, source, want = index_add_yardstick(dev, onset, row, gain, table, lengths,
                                                        length)
        lib = [time_us(lambda: flat.index_add_(0, index, source), 10) / 1e3 for _ in range(2)]
        lib_device = device_us(lambda: flat.index_add_(0, index, source), 3)
        per_thread = ds.samples_per_thread(m, length, sms)
        bnd = synth_bound(onset, row, gain, table, lengths, length)
        # every tile the kernel is built for, launched directly: the chooser's
        # pick against the others
        out = torch.empty((m, length), device=dev)
        tiles = {}
        for p in ds.PER_THREAD:
            args = ((onset, row, gain, table, lengths, out),
                    (m, onset.shape[1], table.shape[0], table.shape[1], length, p), dev)
            per = device_us(lambda: SYNTH_K.launch(*args), 5)
            tiles[ds.THREADS * p] = sum(us / c for us, c in per.values()) / 1e3
            check(torch.equal(out, want), f"device_synth with tiles of {ds.THREADS * p} differs")
        synth_timings.append({
            "M": m, "qpm": 120.0, "length": length, **row_t, "index_add_ms": lib,
            "device_ms_by_tile": tiles,
            "index_add_device_ms": sum(us for us, _ in lib_device.values()) / 1e3,
            "index_add_elements": int(index.numel()), **bnd,
            "bound_share_of_device_time": bnd["bound_ms"] / max(row_t["kernel_device_ms"], 1e-12),
            "samples_per_thread": per_thread,
            "blocks": m * -(-length // (ds.THREADS * per_thread)),
            "dynamic_smem_bytes": ds.smem_bytes(table.shape[0], onset.shape[1])})
        del index, source, flat, out

    # band_energies: the waveform entry (the front end's) against its plain
    # version on kit renders, M 1 and 64 at three tempos and the shapes phases
    # 12 and 13 give it; one request and a chunk of 64 at 120 bpm timed
    band_checks, band_timings = [], []
    hop, n_fft, window = params.hop_length, params.n_fft, mso._window(params.n_fft, dev)
    for case, (grids, qpm) in enumerate(cases):
        m, tempo = len(grids), qpm if np.isscalar(qpm) else [qpm.min(), qpm.max()]
        onset, row, gain, table, lengths, length = events_for(dev, grids, qpm, params)
        waves = SYNTH(onset, row, gain, table, lengths, length)
        y = waves / waves.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)
        del waves
        got = BAND_AUDIO(y, fb_t, window, hop, n_fft)
        again = BAND_AUDIO(y, fb_t, window, hop, n_fft)
        torch.cuda.synchronize()
        want = be.band_energies_from_audio_plain(y, fb_t, window, hop, n_fft)
        err, scale = max_err(got, want), float(want.abs().max())
        f = be.n_frames(length, hop, n_fft)
        check(got.shape == (m, f, 16) and err <= 1e-4 * scale,
              f"band_energies_from_audio != plain version at M {m}, {tempo} bpm: "
              f"{err} > 1e-4 * {scale}")
        check(torch.equal(got, again), f"band_energies_from_audio reruns differ at M {m}")
        del again, want
        # the library route from the same waveform: framing, rfft (keeps the
        # Nyquist bin), abs, one matmul; timed, never used by the port
        library = lambda: torch.fft.rfft(mso._windowed_frames(y, params)).abs() @ fb_t  # noqa: E731
        lib_err = max_err(got, library())
        check(lib_err <= 2e-4 * scale, f"kernel vs rfft route at M {m}: {lib_err}")
        band_checks.append({"entry": "waveform", "M": m, "qpm": tempo, "N": m * f,
                            "max_abs_err": err, "max_ref": scale, "bitwise_repeat": True,
                            "max_abs_err_vs_rfft": lib_err})
        if not (case < 6 and qpm == 120.0):  # M 1 and 64 at 120 bpm
            del y, got
            continue
        stft = lambda: (torch.stft(  # noqa: E731
            y, n_fft, hop, params.win_length, window=hann, center=True, pad_mode="reflect",
            return_complex=True).abs().transpose(1, 2) @ fb_t)
        conv = lambda: mso.stft_magnitude_conv(y, params) @ fb_t  # noqa: E731
        check(max_err(library(), stft()) <= 2e-4 * scale
              and max_err(library(), conv()) <= 2e-4 * scale,
              f"library routes disagree at M {m}")
        row_t = timed(lambda: BAND_AUDIO(y, fb_t, window, hop, n_fft),
                      lambda: be.band_energies_from_audio_plain(y, fb_t, window, hop, n_fft))
        lib_device = device_us(library, 5)
        bnd = band_audio_bound(m, length, f)
        band_timings.append({
            "M": m, "N": m * f, "length": length, **row_t,
            "library_ms": [time_us(library, 20) / 1e3 for _ in range(2)],
            "library_device_ms": sum(us for us, _ in lib_device.values()) / 1e3,
            "library_device_launches": sum(c for _, c in lib_device.values()),
            "stft_matmul_ms": [time_us(stft, 20) / 1e3 for _ in range(2)],
            "conv_matmul_ms": [time_us(conv, 10) / 1e3 for _ in range(2)],
            "framing_ms": time_us(lambda: mso._windowed_frames(y, params), 20) / 1e3,
            **bnd,
            "bound_share_of_device_time": bnd["bound_ms"] / max(row_t["kernel_device_ms"], 1e-12),
            "frames_bytes_bound_ms": band_bound(m * f)["bound_ms"],
            "dense_dft_ms": band_bound(m * f)["dense_dft_ms"]})
        del y, got

    # the frames entry (the JAX kernel's signature; the same kernel with hop
    # n_fft, no padding, no window) at ragged N, on frames of phase 13's 256
    # loops rendered at 90 bpm (549 frames each); N 418 and 26,752 timed
    onset, row, gain, table, lengths, length = events_for(dev, aug_grids, 90.0, params)
    waves = SYNTH(onset, row, gain, table, lengths, length)
    waves = waves / waves.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)
    all_frames = mso._windowed_frames(waves, params).reshape(-1, n_fft)
    del waves
    frame_timings = []
    for n in (1, 417, 418, 26752, 140544):
        check(all_frames.shape[0] >= n, f"the render gives {all_frames.shape[0]} frames, not {n}")
        frames = all_frames[:n]
        got, again = BAND(frames, fb_t), BAND(frames, fb_t)
        torch.cuda.synchronize()
        want = be.band_energies_plain(frames, fb_t)
        err, scale = max_err(got, want), float(want.abs().max())
        check(got.shape == (n, 16) and err <= 1e-4 * scale,
              f"band_energies != plain version at N {n}: {err} > 1e-4 * {scale}")
        check(torch.equal(got, again), f"band_energies reruns differ at N {n}")
        fft = lambda: torch.fft.rfft(frames).abs() @ fb_t  # noqa: E731
        fft_err = max_err(got, fft())
        check(fft_err <= 2e-4 * scale, f"kernel vs rfft at N {n}: {fft_err}")
        band_checks.append({"entry": "frames", "N": n, "max_abs_err": err, "max_ref": scale,
                            "bitwise_repeat": True, "max_abs_err_vs_rfft": fft_err})
        if n in (418, 26752):
            row_t = timed(lambda: BAND(frames, fb_t), lambda: be.band_energies_plain(frames, fb_t))
            frame_timings.append({"N": n, **row_t,
                                  "rfft_matmul_ms": [time_us(fft, 20) / 1e3 for _ in range(2)],
                                  **band_bound(n)})
        del got, again, want
    del all_frames
    emit({"phase": "front_end_kernels",
          "bars": {"band_energies": "1e-4 * max|ref| (an f32 FFT against the plain version's "
                                    "dense f32 products)",
                   "device_synth": "bit for bit"},
          "device_synth": {"checks": synth_checks, "timings": synth_timings,
                           "resources": kernel_resources("device_synth")},
          "band_energies": {"checks": band_checks, "timings": band_timings,
                            "frames_entry_timings": frame_timings}})
    return {"synth_err": worst_synth,
            "band_err": max(c["max_abs_err"] for c in band_checks),
            "synth_timings": synth_timings, "band_timings": band_timings,
            "band_frame_timings": frame_timings}


def onsets_agree(grids: np.ndarray, qpms: np.ndarray, length: int, sr: int = 44100):
    """Per item: does every hit's onset, computed in f32 as the device route
    computes it, equal the host mixer's f64 onset? Where the f32 value crosses
    an integer the two routes place that sample one position apart."""
    v = grids.shape[2] // 3
    sps = (qpms / 60.0) * 4.0
    cells = np.arange(grids.shape[1])[None, :, None] + grids[:, :, 2 * v:]
    host = np.clip(cells / sps[:, None, None] * sr, 0, length - 1).astype(np.int64)
    sps32 = sps.astype(np.float32)[:, None, None]
    device = np.clip(cells.astype(np.float32) / sps32 * np.float32(sr), 0, length - 1).astype(
        np.int64)
    return ((host == device) | (grids[:, :, :v] <= 0)).all(axis=(1, 2))


def phase_front_end(dev, rng) -> None:
    grids = Loops(64, 22).processed_outputs
    qpms = np.random.default_rng(23).uniform(60.0, 200.0, 64)
    reset_front_end_launches()
    got = mso.mso_batch_from_hvo(grids, None, qpms, device=dev, chunk_size=64)
    counts = {"device_synth": SYNTH_K.launches, "band_energies": BAND_K.launches}
    check(counts == {"device_synth": 1, "band_energies": 1},
          f"one chunk of 64 launched {counts}, expected each kernel once")
    got32 = mso.mso_batch_from_hvo(grids, None, qpms, device=dev, chunk_size=32)
    check((SYNTH_K.launches, BAND_K.launches) == (3, 3),
          "two chunks of 32: one launch per chunk each")
    check(got.shape == (64, 32, 16) and np.isfinite(got).all() and got.min() >= 0
          and got.max() > 0.5, "bad MSO from the kernel route")
    with plain_front_end():
        plain = mso.mso_batch_from_hvo(grids, None, qpms, device=dev, method="fused")
    check((SYNTH_K.launches, BAND_K.launches) == (3, 3), "the plain route launched a kernel")
    host = mso.mso_batch_from_hvo(grids, None, qpms, device="cpu")  # numpy mixer + "fft"
    scale = float(np.abs(host).max())
    errs = {}
    for name, ref in (("plain_route_on_card", plain), ("chunks_of_32", got32)):
        errs[name] = max_err(got, ref)
        check(np.allclose(got, ref, atol=2e-5 * scale, rtol=1e-3),
              f"kernel route vs {name}: max abs err {errs[name]} at scale {scale}")
    # the host mixer computes onsets in f64, the device route in f32 (as the
    # JAX package's two routes do): a loop whose onsets all agree is held to
    # the same bar; one with a hit placed a sample apart (a hat or a cymbal
    # shifted by 23 µs changes its top bands; 2.6 % of the scale on an H100) to
    # 5e-2 of the scale
    length = mso.mso_waveform_length(32, float(qpms.min() / 15.0), mso.MSOParams())
    same = onsets_agree(grids, qpms, length)
    errs["host_route_on_cpu_same_onsets"] = max_err(got[same], host[same])
    errs["host_route_on_cpu_shifted_onsets"] = max_err(got[~same], host[~same]) if (
        ~same).any() else 0.0
    check(same.sum() >= 32 and np.allclose(got[same], host[same], atol=2e-5 * scale, rtol=1e-3),
          f"kernel route vs host route on {int(same.sum())} loops with equal onsets: max abs "
          f"err {errs['host_route_on_cpu_same_onsets']} at scale {scale}")
    check(errs["host_route_on_cpu_shifted_onsets"] <= 5e-2 * scale,
          f"kernel route vs host route on loops with a shifted onset: "
          f"{errs['host_route_on_cpu_shifted_onsets']} at scale {scale}")
    # loops per second through grids -> MSO, by chunk size and method, 120 bpm
    many = Loops(512, 24).processed_outputs
    tempo = np.full((512,), 120.0)
    rates = {}
    for method in ("fused", "fft", "conv"):
        for chunk in (64, 128, 256):
            run = lambda: mso.mso_batch_from_hvo(  # noqa: E731
                many, None, tempo, device=dev, chunk_size=chunk, method=method)
            rates[f"{method}_chunk{chunk}"] = [512e6 / host_us(run, 3) for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    mso.mso_batch_from_hvo(many, None, tempo, device=dev, chunk_size=64)
    peak64 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mso.mso_batch_from_hvo(many, None, tempo, device=dev, chunk_size=256)
    emit({"phase": "front_end", "loops": 64, "qpm_range": [float(qpms.min()), float(qpms.max())],
          "launches_per_chunk": counts, "max_mso": scale, "max_abs_err": errs,
          "loops_with_equal_onsets": int(same.sum()),
          "bar": "atol 2e-5 * max|host route|, rtol 1e-3; 5e-2 * max where an onset differs "
                 "by a sample between the f32 and f64 routes",
          "loops_per_s_512_loops_120bpm": rates,
          "peak_bytes_chunk64": peak64,
          "peak_bytes_chunk256": torch.cuda.max_memory_allocated()})


def phase_serve_hvo(dev, rng, sd, srv) -> dict:
    """``hvo_input`` + ``qpm`` to the flagship-width server: the synth + MSO
    front end and the model on the card."""
    loops = Loops(40, 25).processed_outputs
    requests = [(loops[0], 90.0), (loops[:6], 120.0), (loops, 150.0)]
    chunks = [1, 1, 2]  # model buckets (1, 8, 32): 1 | 8 | 32 + 8; front end: 1 chunk each
    MHA.launches = 0  # the main path's run starts here
    reset_mha_forms()
    reset_front_end_launches()
    out = [srv.infill_from_hvo(g, qpm=q) for g, q in requests]
    counts = {"fused_mha": MHA.launches, "band_energies": BAND_K.launches,
              "device_synth": SYNTH_K.launches}  # ... and ends here
    forms = mha_forms()
    check(forms == {"short": counts["fused_mha"]}, f"#1 at T 32 took the forms {forms}")
    check(counts == {"fused_mha": 6 * sum(chunks), "band_energies": 3, "device_synth": 3},
          f"hvo_input requests launched {counts}; expected 6 fused_mha per model chunk "
          f"({6 * sum(chunks)}) and the front-end kernels once per request")
    cpu_model = build_model(FLAGSHIP, "cpu")
    cpu_model.load_state_dict(sd, strict=True)
    worst = 0.0
    for (g, q), y in zip(requests, out):
        g3 = g[None] if g.ndim == 2 else g
        check(y.shape == g.shape and np.isfinite(y).all(), f"bad hvo_input answer at {q} bpm")
        # the plain versions on the CPU, front end and model
        x_cpu = mso.mso_batch_from_hvo(g3, None, np.full((len(g3),), q), device="cpu",
                                       device_synth=True, method="fused")
        h_cpu, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(x_cpu))
        sig = predict(cpu_model, torch.from_numpy(x_cpu), use_thres=False)[0].numpy()
        y3 = y[None] if y.ndim == 2 else y
        err = max(max_err(y3[..., 9:18], v_cpu), max_err(y3[..., 18:], o_cpu))
        worst = max(worst, err)
        check(err <= 1e-4, f"hvo_input at {q} bpm vs the CPU plain path: v/o differ by {err}")
        check(hit_agreement(y3[..., :9], h_cpu.numpy(), sig),
              f"hvo_input at {q} bpm: hits differ away from the threshold")
    httpd = srv.serve_http(port=0, block=False)
    try:
        port = httpd.server_address[1]
        for (g, q), y in zip(requests, out):
            code, payload = post(port, {"hvo_input": g.tolist(), "qpm": q})
            check(code == 200, f"POST hvo_input answered {code}: {payload}")
            check(np.array_equal(np.asarray(payload["hvo"], np.float32), y),
                  f"HTTP hvo_input answer at {q} bpm differs from the direct path")
        code, payload = post(port, {"hvo_input": loops[0].tolist(), "sf_path": "kit.sf2"})
        check(code == 400 and '"sf_path"' in payload.get("error", ""),
              f"a body naming sf_path answered {code} {payload}, expected 400 naming the field")
        url = f"http://127.0.0.1:{port}/infill"
        http = serve.latency_benchmark(srv, n_requests=200, url=url, hvo_input=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
    runs = {"hvo_input": [], "mso_input": []}
    for which in ("hvo_input", "mso_input", "mso_input", "hvo_input"):  # in turns
        runs[which].append(serve.latency_benchmark(srv, n_requests=300,
                                                   hvo_input=which == "hvo_input"))
    # where a B = 1 hvo_input request's time goes
    g1 = loops[:1]
    x1 = srv._front_end(g1, 120.0)
    request = host_us(lambda: srv.infill_from_hvo(g1, qpm=120.0))
    front = host_us(lambda: srv._front_end(g1, 120.0))
    model = host_us(lambda: srv.infill(x1))
    per_kernel = device_us(lambda: srv.infill_from_hvo(g1, qpm=120.0), n=30)
    front_kernels = device_us(lambda: srv._front_end(g1, 120.0), n=30)
    device_total = sum(us for us, _ in per_kernel.values())
    emit({"phase": "serve_hvo_input", "config": "InfillingRandom flagship d256 h2 ff512 6L",
          "requests": [[1 if g.ndim == 2 else len(g), q] for g, q in requests],
          "launches": counts, "fused_mha_launches_by_form": forms,
          "max_abs_err_vs_cpu_plain": worst})
    emit({"phase": "serve_hvo_input_latency", "batch": 1, "qpm": 120.0,
          "in_process": runs, "http_hvo_input": http})
    emit({"phase": "serve_hvo_input_split",
          "breakdown_us": {"request": request, "front_end": front, "model_request": model},
          "request_device_us": device_total,
          "front_end_device_us": sum(us for us, _ in front_kernels.values()),
          "device_launches_per_request": sum(c for _, c in per_kernel.values()),
          "front_end_launches_per_request": sum(c for _, c in front_kernels.values()),
          "device_busy_share": device_total / request,
          "top_front_end_kernels_us_launches": sorted(
              front_kernels.items(), key=lambda kv: -kv[1][0])[:8]})
    return {"launches": counts}


def phase_train_augment(dev, rng) -> dict:
    """The flagship config trained on MSO inputs rendered inside the epoch:
    random masking, synthesis and MSO on the card, every epoch anew."""
    batch, epochs = FLAGSHIP_HP["batch_size"], 3
    grids, qpms = augment_corpus()
    n = len(grids)
    base = torch.from_numpy(grids).to(dev)
    augment = make_on_device_augment(qpms=qpms, mode="audio")
    bundle, _, _ = initialize_model(flagship_params(), dev)
    epoch_fn = make_epoch_fn(FLAGSHIP_HP["hit_loss_penalty"], batch, n, augment=augment)
    gen = torch.Generator(dev).manual_seed(0)
    reset_launches()  # the main path's run starts here
    reset_front_end_launches()
    metrics = [fetch(epoch_fn(bundle.state, base, base, gen)) for _ in range(epochs)]
    counts = {**launches(fl.SM90_KERNELS), "band_energies": BAND_K.launches,
              "device_synth": SYNTH_K.launches}  # ... and ends here
    steps, n_layers = epochs * (n // batch), FLAGSHIP_HP["num_encoder_decoder_layers"]
    n_chunks = epochs * -(-n // ds.DEFAULT_CHUNK)
    want = {**{k: steps * n_layers for k in fl.SM90_KERNELS},
            "band_energies": n_chunks, "device_synth": n_chunks}
    check(counts == want, f"augmented training launched {counts}, expected {want}")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    # seqs/s with the front end inside the epoch, beside the same epoch on
    # inputs rendered once
    inputs, outputs = augment(torch.Generator(dev).manual_seed(1), base, base)
    before = (SYNTH_K.launches, BAND_K.launches)
    with plain_front_end():  # the same call, same draws, through the plain versions
        plain_inputs, plain_outputs = augment(torch.Generator(dev).manual_seed(1), base, base)
    check((SYNTH_K.launches, BAND_K.launches) == before, "the plain augment launched a kernel")
    augment_err, scale = max_err(inputs, plain_inputs), float(plain_inputs.abs().max())
    check(torch.equal(outputs, plain_outputs)
          and torch.allclose(inputs, plain_inputs, atol=2e-5 * scale, rtol=1e-3),
          f"augment through the kernels vs the plain versions: {augment_err} at scale {scale}")
    del plain_inputs, plain_outputs
    plain_fn = make_epoch_fn(FLAGSHIP_HP["hit_loss_penalty"], batch, n)

    def seqs(fn, x, y):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fetch(fn(bundle.state, x, y, gen))
        return n / (time.perf_counter() - t0)

    rates = {"augmented": [], "rendered_once": []}
    for which in ("augmented", "rendered_once", "rendered_once", "augmented"):
        if which == "augmented":
            rates[which].append(seqs(epoch_fn, base, base))
        else:
            rates[which].append(seqs(plain_fn, inputs, outputs))
    augment_ms = host_us(lambda: augment(gen, base, base), 5) / 1e3
    emit({"phase": "train_audio_augment", "config": FLAGSHIP_HP,
          "data": f"{n} seeded synthetic loops, 90-150 bpm", "epochs": epochs, "steps": steps,
          "launches": counts, "losses": losses, "last_metrics": metrics[-1],
          "augment_max_abs_err_vs_plain": augment_err, "augment_max": scale,
          "augment_bar": "atol 2e-5 * max, rtol 1e-3; targets equal",
          "seqs_per_s": rates, "augment_ms_per_epoch": augment_ms})
    return {"launches": counts}


def phase_train_encdec(dev, rng) -> dict:
    """The encoder-decoder family (6 + 6 layers at the flagship width) trained
    with teacher forcing through ``initialize_model`` +
    ``train_loop(encoder_only=0)``: every encoder and decoder layer's forward
    and backward through its kernels."""
    # 256 loops for the epochs and the batch-32 rates, 512 (one step) at batch 512
    data, held, big = Loops(256, 31), Loops(256, 32), Loops(512, 31)
    batch, epochs = FLAGSHIP_HP["batch_size"], 3
    steps = epochs * (len(data.processed_inputs) // batch)
    params = lambda **model: flagship_params(num_decoder_layers=ENCDEC_LAYERS, **model)  # noqa: E731
    unfused = dict(fused_layer=False, fused_decoder_layer=False)
    bundle, _, _ = initialize_model(params(), dev)
    cfg = bundle.config
    check(cfg.fused_layer and cfg.fused_decoder_layer and cfg.compute_dtype == torch.bfloat16
          and cfg.num_decoder_layers == ENCDEC_LAYERS and not cfg.encoder_only,
          f"auto policy did not pick both layer kernels in bf16: {cfg}")
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    metrics = run_epochs(bundle, data, held, epochs, batch, encoder_only=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches(SM90_LAYER_KERNELS)  # ... and ends here
    check(all(c == steps * ENCDEC_LAYERS for c in counts.values())
          and not any(launches(F32_LAYER_KERNELS).values()),
          f"layer launches {counts}, expected {steps * ENCDEC_LAYERS} each ({steps} steps x "
          f"{ENCDEC_LAYERS} encoder and {ENCDEC_LAYERS} decoder layers), and the f32 chains "
          f"{launches(F32_LAYER_KERNELS)}, expected 0")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    plain, _, _ = initialize_model(params(**unfused), dev)
    before = launches(LAYER_KERNELS)
    plain_losses = [m["loss"] for m in run_epochs(plain, data, held, epochs, batch, 0)]
    check(launches(LAYER_KERNELS) == before, "the unfused path launched a layer kernel")
    check(all(np.isfinite(plain_losses)) and plain_losses[-1] < plain_losses[0],
          f"unfused path loss did not fall: {plain_losses}")

    # 3 f32 steps at dropout 0 through make_epoch_fn: the kernel path against
    # the twin path (the kernel's side of a ReLU kink, ``fused_layers_as``)
    # and the unfused path, on the card
    kernel_h, kinks, three = [], [], {}
    x = torch.from_numpy(data.processed_inputs[:96]).to(dev)
    y = torch.from_numpy(data.processed_outputs[:96]).to(dev)
    reset_launches()  # the f32 route's path: its kernels launch here only
    for name in ("kernel", "twin", "unfused"):
        b, _, _ = initialize_model(
            params(bf16=False, dropout=0.0, **(unfused if name == "unfused" else {})), dev)
        epoch_fn = make_epoch_fn(FLAGSHIP_HP["hit_loss_penalty"], 32, 96, shuffle=False,
                                 encoder_only=False)
        with fused_layers_as(name, kernel_h, kinks):
            epoch_fn(b.state, x, y, torch.Generator(dev).manual_seed(0))
        check(b.state.step == 3, f"{name}: {b.state.step} steps, expected 3")
        three[name] = {k: v.detach().cpu() for k, v in b.model.state_dict().items()}
    f32_counts = launches(F32_LAYER_KERNELS)  # ... and ends here
    check(f32_counts == {**f32_step_launches(fl, 3, ENCDEC_LAYERS),
                         **f32_step_launches(fdl, 3, ENCDEC_LAYERS)}
          and not any(launches(SM90_LAYER_KERNELS).values()),
          f"3 f32 steps launched {launches(LAYER_KERNELS)}")
    param_err = {other: max(max_err(three["kernel"][k], three[other][k]) for k in three["kernel"])
                 for other in ("twin", "unfused")}
    check(param_err["twin"] <= 1e-4 and param_err["unfused"] <= UNFUSED_BAR,
          f"3 f32 steps: params differ by {param_err} (kink flips per layer call: {kinks})")

    # throughput, kernel path and unfused path in turns
    throughput = {}
    for b in THROUGHPUT_BATCHES:
        runs = {"kernel": [], "unfused": []}
        models = {"kernel": initialize_model(params(), dev)[0],
                  "unfused": initialize_model(params(**unfused), dev)[0]}
        corpus = data if b == batch else big
        for which in ("kernel", "unfused", "unfused", "kernel"):
            seqs_per_s(models[which], corpus, b, 0)  # warm-up epoch
            runs[which].append(seqs_per_s(models[which], corpus, b, 0))
        throughput[b] = runs

    # where a step's device time goes (kernel path)
    breakdown = {b: step_breakdown(initialize_model(params(), dev)[0], b, 33, 0)
                 for b in THROUGHPUT_BATCHES}

    # f32, both f32 chains against both fused switches off in paired turns
    # (4 steps a turn at batch 512)
    f32_turns, f32_big = {}, Loops(2048, 31)
    for b in THROUGHPUT_BATCHES:
        models = {"kernel": initialize_model(params(bf16=False, fused_layer=True,
                                                    fused_decoder_layer=True), dev)[0],
                  "unfused": initialize_model(params(bf16=False, **unfused), dev)[0]}
        f32_turns[b] = paired_turns(models, data if b == batch else f32_big, b, 0)
        f32_turns[b]["auto_picks_kernel"] = resolve_fused_decoder_layer(
            None, ENCDEC.d_model, ENCDEC.n_heads, ENCDEC.dim_feedforward,
            compute_dtype=torch.float32, batch_size=b)
    wide = wide_training(dev, decoder=True)
    long = long_training(dev, decoder=True)
    emit({"phase": "train_encdec",
          "config": {**FLAGSHIP_HP, "encoder_only": 0, "num_decoder_layers": ENCDEC_LAYERS},
          "data": "256 seeded synthetic loops (512 for the rates at batch 512)",
          "epochs": epochs, "steps": steps,
          "seconds": seconds, "launches": counts,
          "launches_per_step": {k: c / steps for k, c in counts.items()},
          "three_f32_steps_launches": f32_counts, "losses": losses,
          "last_metrics": metrics[-1], "unfused_losses": plain_losses,
          "three_f32_steps_param_err": param_err, "three_f32_steps_kink_flips": kinks,
          "unfused_bar": UNFUSED_BAR, "seqs_per_s": throughput, "step_breakdown": breakdown,
          "f32_paired_turns": f32_turns, "wide": wide, "long": long})
    return {"launches": counts, "f32_launches": f32_counts, "seqs_per_s": throughput,
            "f32_paired_turns": f32_turns, "wide": wide, "long": long}


def phase_serve_encdec(dev, rng, enc_srv) -> dict:
    """``InfillServer`` over the encoder-decoder config: no target is passed,
    the decoder reads zeros, and every chunk's 6 encoder, 6 causal decoder
    self- and 6 decoder cross-attentions go through ``fused_mha``."""
    sd = build_model(ENCDEC, "cpu", torch.Generator().manual_seed(16)).state_dict()
    srv = serve.InfillServer(sd, ENCDEC, batch_sizes=BUCKETS, device=dev)
    xs = {n: rng.standard_normal((n, 32, 16)).astype(np.float32) for n in (1, 6, 40)}
    chunks = {1: 1, 6: 1, 40: 2}  # buckets (1, 8, 32): 1 | 8 | 32 + 8
    per_chunk = ENCDEC.num_encoder_layers + 2 * ENCDEC.num_decoder_layers
    MHA.launches = 0  # the main path's run starts here
    reset_mha_forms()
    out = {n: srv.infill(x) for n, x in xs.items()}
    launches_mha = MHA.launches  # ... and ends here
    forms = mha_forms()
    check(forms == {"short": launches_mha}, f"#1 at T 32 took the forms {forms}")
    check(launches_mha == per_chunk * sum(chunks.values()),
          f"fused_mha launched {launches_mha} times, expected {per_chunk} per forward chunk "
          f"({per_chunk * sum(chunks.values())})")
    cpu_model = build_model(ENCDEC, "cpu")
    cpu_model.load_state_dict(sd, strict=True)

    def against_cpu(x_cpu, y, what):
        h_cpu, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(x_cpu))
        sig = predict(cpu_model, torch.from_numpy(x_cpu), use_thres=False)[0].numpy()
        check(y.shape == x_cpu.shape[:2] + (27,) and np.isfinite(y).all(), f"bad output, {what}")
        err = max(max_err(y[..., 9:18], v_cpu), max_err(y[..., 18:], o_cpu))
        check(err <= 1e-4, f"{what}: v/o differ from the CPU plain path by {err}")
        check(hit_agreement(y[..., :9], h_cpu.numpy(), sig),
              f"{what}: hits differ away from the threshold")
        return err

    worst = max(against_cpu(x, out[n], f"encoder-decoder server at N={n}")
                for n, x in xs.items())
    # one hvo_input request: the front end's kernels, then 18 attentions
    grid = Loops(1, 34).processed_outputs
    MHA.launches = 0
    reset_front_end_launches()
    y_hvo = srv.infill_from_hvo(grid[0], qpm=120.0)
    hvo_counts = {"fused_mha": MHA.launches, "band_energies": BAND_K.launches,
                  "device_synth": SYNTH_K.launches}
    check(hvo_counts == {"fused_mha": per_chunk, "band_energies": 1, "device_synth": 1},
          f"one hvo_input request launched {hvo_counts}")
    x_cpu = mso.mso_batch_from_hvo(grid, None, np.full((1,), 120.0), device="cpu",
                                   device_synth=True, method="fused")
    hvo_err = against_cpu(x_cpu, y_hvo[None], "encoder-decoder hvo_input")

    runs = {"encoder_decoder": [], "encoder_only": []}
    for which in ("encoder_decoder", "encoder_only", "encoder_only", "encoder_decoder"):
        runs[which].append(serve.latency_benchmark(
            srv if which == "encoder_decoder" else enc_srv, n_requests=200, batch=1))
    x1 = np.zeros((1, 32, 16), np.float32)
    request = host_us(lambda: srv.infill(x1))
    per_kernel = device_us(lambda: srv.infill(x1), n=30)
    device_total = sum(us for us, _ in per_kernel.values())
    emit({"phase": "serve_encdec", "config": "d256 h2 ff512, 6 + 6 layers, f32",
          "requests": sorted(xs), "chunks": sum(chunks.values()), "launches": launches_mha,
          "fused_mha_launches_by_form": forms,
          "launches_per_chunk": per_chunk, "max_abs_err_vs_cpu_plain": worst,
          "hvo_input": {"launches": hvo_counts, "max_abs_err_vs_cpu_plain": hvo_err},
          "latency_b1_in_process": runs,
          "request_us": request, "request_device_us": device_total,
          "device_launches_per_request": sum(c for _, c in per_kernel.values()),
          "device_busy_share": device_total / request,
          "top_device_kernels_us_launches": sorted(
              per_kernel.items(), key=lambda kv: -kv[1][0])[:6]})
    return {"launches": launches_mha}


# ---------------------------------------------------------------- slice 5

# rows × d × ff and the config's dropout rate: configs/
# InfillingRandomLow_lm_training.yaml at batch 32 and 512, then GrooveXL
# (scripts/bench_groovexl_ffn.py) at batch 128
FFN_SHAPES = ((1024, 256, 2048, 0.16), (16384, 256, 2048, 0.16), (4096, 1024, 4096, 0.1))
# widths that are no multiples of the tiles, rows of no whole tile; then f32
# widths of 4 mod 8 (the f32 route's 16-byte rows; bf16 asks multiples of 8)
RAGGED_FFN_SHAPE = (100, 72, 200, 0.16)
F32_ONLY_FFN_SHAPE = (100, 36, 100, 0.16)
FFN_GRADS = ("dx", "dw1", "db1", "dw2", "db2")
LN_GRADS = ("dx", "dy", "dscale", "dbias")
NEW_KERNELS = {**ffn.KERNELS, **ln.KERNELS}
# "GrooveXL", scripts/bench_groovexl_ffn.py: the one shape with remat on. That
# script's SGD rate of 0.05 makes the loss climb on these loops, with the FFN
# kernels and with fused_ffn=False alike (8.6 → 20 → 36 in three steps on an
# H100); 0.003 lets it fall
# phase 20: epochs of the checkpointed flagship run, its loops, its watch cadence
CKPT_EPOCHS, CKPT_LOOPS, CKPT_WATCH_FREQ = 4, 512, 32
XL_HP = {
    "d_model": 1024, "n_heads": 8, "dim_feedforward": 4096, "dropout": 0.1,
    "num_encoder_layers": 12, "batch_size": 128, "remat": True, "learning_rate": 0.003,
    "hit_loss_penalty": 0.73, "optimizer": "sgd", "fused_ffn": True,  # auto leaves it off
}


def ffn_splits(rows, d, ff, dtype) -> int:
    """Row splits of the weight-gradient launch the wrappers make."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ffn.wgrad_splits(rows, d, ff, sms, ffn.tile_configs(rows, d, ff, sms, dtype)[4])[0]


def ffn_bounds(rows, d, ff, dtype) -> dict:
    """Bounds of each FFN launch type of ``dtype``'s route: a product of
    2·rows·d·ff FLOP (bf16 at its peak, f32 at the split-TF32 rate), its
    inputs read once and its outputs written once (storage dtype s; biases,
    seed, gradients and the weight partials f32); ``fwd`` and ``bwd``: the
    whole call's own bound, 4·rows·d·ff FLOP forward and twice that backward,
    its own inputs and outputs (no h, dh or partials)."""
    f32 = dtype == "float32"
    s, peak, suffix = (4, "tf32x3", "_f32") if f32 else (2, "bfloat16", "")
    flops = 2 * rows * d * ff
    total = 2 * d * ff + ff + d
    splits = ffn_splits(rows, d, ff, torch.float32 if f32 else torch.bfloat16)
    act, hid, wts = rows * d * s, rows * ff * s, d * ff * s
    return {f"fused_ffn_{name}{suffix}": b for name, b in {
        "fwd_h": bound(act + wts + ff * 4 + 4 + hid, flops, peak),  # x, W1, b1 → h
        "fwd_out": bound(hid + wts + d * 4 + act, flops, peak),  # h, W2, b2 → out
        "bwd_dh": bound(act + wts + 2 * hid, flops, peak),  # dy, W2, h → dh
        "bwd_dx": bound(hid + wts + act, flops, peak),  # dh, W1 → dx
        "bwd_weights": bound(2 * act + 2 * hid + splits * total * 4,
                             2 * flops + rows * (ff + d), peak),
        "reduce": bound((splits + 1) * total * 4, (splits - 1) * total, "float32"),
        # x, W1, b1, W2, b2 → out; dy, x, W1, W2 (h kept) → dx and the f32 gradients
        "fwd": bound(2 * act + 2 * wts + (ff + d) * 4 + 4, 2 * flops, peak),
        "bwd": bound(3 * act + hid + 2 * wts + total * 4, 4 * flops, peak),
    }.items()}


def ffn_launches(rows, d, ff, dtype, sites: int, forward_passes: int = 1) -> dict:
    """FFN launches of ``sites`` forward and backward passes at ``rows``, each
    forward run ``forward_passes`` times (2 under remat), on ``dtype``'s
    counters: two forward products, two row-backward products, one weight
    launch and, when it splits the rows, one reduce."""
    suffix = "_f32" if dtype == torch.float32 else ""
    splits = ffn_splits(rows, d, ff, dtype)
    per = {"fwd_h": forward_passes, "fwd_out": forward_passes, "bwd_dh": 1, "bwd_dx": 1,
           "bwd_weights": 1, "reduce": int(splits > 1)}
    return {k: 0 for k in ffn.KERNELS} | {f"fused_ffn_{name}{suffix}": sites * n
                                          for name, n in per.items()}


def ln_bounds(rows, d, dtype) -> dict:
    """Bounds of the two LN kernels: x, y (and g) read, out (or dx, dy)
    written; about 10 operations an element forward (mask, add, two-pass
    statistics, normalise, affine) and 25 backward."""
    s = 4 if dtype == "float32" else 2
    return {"fused_ln_fwd": bound(3 * rows * d * s + 2 * d * 4 + 4, 10 * rows * d, dtype),
            "fused_ln_bwd": bound(5 * rows * d * s + 3 * d * 4 + 4, 25 * rows * d, dtype)}


def time_ms(fn, n: int, warm: int = 2) -> float:
    """Mean ms per call on the stream over ``n`` calls after ``warm``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def normal(dev, rng, *shape, scale=1.0, offset=0.0) -> torch.Tensor:
    """f32 normal draws from ``rng``, on ``dev``."""
    a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).to(dev)


def ffn_case(dev, rng, rows, d, ff, dtype):
    """(x, w1, b1, w2, b2) in the port's layout, then dy, y (a second
    (rows, d) input for the LN kernels) and LN's scale and bias, from ``rng``."""
    n = functools.partial(normal, dev, rng)
    return ([n(rows, d).to(dtype), n(ff, d, scale=d ** -0.5).to(dtype), n(ff, scale=0.1),
             n(d, ff, scale=ff ** -0.5).to(dtype), n(d, scale=0.1)],
            n(rows, d).to(dtype), n(rows, d).to(dtype), n(d, scale=0.1, offset=1.0),
            n(d, scale=0.1))


def held_to(errs, name, got, want, dtype, what) -> None:
    """Phase 8's bars: f32 within 1e-4 (``relative``: of max|want|, for
    gradients, whose sums run over thousands of rows), bf16 within 2e-2 of
    max|want|."""
    want = want.detach().float()
    top = float(want.abs().max())
    relative = name.startswith("d")
    bar = (1e-4 * (top if relative else 1.0)) if dtype == torch.float32 else 2e-2 * top
    errs[name] = max_err(got, want)
    check(errs[name] <= bar, f"{name} at {what}: {errs[name]} > {bar}")


# the chain's own bias and plain-rounding launches (csrc/layer_sm90.cu): the
# f32 FFN's h·W2ᵀ and dh·W1 without promotion, counted apart (phase 17 only)
UNPROMOTED = layer_sm90.counted_kernels("chip_smoke_unpromoted", {"bias": "bias",
                                                                   "round": "round"})


def ffn_tile_shapes(dev, args, dy, seed, rate) -> dict:
    """Device µs per launch of each product with each of the two tile shapes
    it is built for in the inputs' dtype (``ffn.PRODUCT_TILES``; the weight
    gradients with their row splits for it), launched directly with
    preallocated outputs, and the shapes the wrappers pick. Every shape's
    results are held to the wrappers' within 2e-2 of their maxima in bf16 and
    1e-5 in f32 (phase 17 holds the wrappers to the plain version). f32 also:
    the drift of the two products that reduce over ff, h·W2ᵀ and dh·W1, from
    their f64 products on the same inputs, promoted (the FFN's launches) and
    not (the layer chain's bias and rounding launches), each · max|f64|."""
    x, w1, b1, w2, b2 = args
    (rows, d), ff, dtype = x.shape, w1.shape[0], x.dtype
    f32 = int(dtype == torch.float32)
    want_out, want_h = ffn.ffn_forward(*args, seed, rate)
    want_dx, *want_grads = ffn.ffn_backward(dy, x, want_h, w1, w2, rate)
    want = {"h": want_h, "out": want_out, "dx": want_dx,
            "weights": torch.cat([g.flatten() for g in want_grads])}  # dW1 | db1 | dW2 | db2
    out, h, dh, dx = (torch.empty_like(t) for t in (x, want_h, want_h, x))
    thresh, k = quantized_threshold(rate), ffn.route_kernels(dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    total = 2 * d * ff + ff + d
    built = ffn.PRODUCT_TILES[dtype]
    bar = 1e-5 if f32 else 2e-2

    def launches_with(cfgs, part):
        splits, per = ffn.wgrad_splits(rows, d, ff, sms, cfgs[4])
        return lambda: (
            k["fwd_h"].launch((x, w1, b1, seed, h), (rows, d, ff, thresh, cfgs[0], f32), dev),
            k["fwd_out"].launch((h, w2, b2, out), (rows, d, ff, cfgs[1], f32), dev),
            k["bwd_dh"].launch((dy, w2, h, dh), (rows, d, ff, thresh, cfgs[2], f32), dev),
            k["bwd_dx"].launch((dh, w1, dx), (rows, d, ff, cfgs[3], f32), dev),
            k["bwd_weights"].launch((dy, x, h, dh, part),
                                    (rows, d, ff, splits, per, cfgs[4], f32), dev))

    names = ("fwd_h", "fwd_out", "bwd_dh", "bwd_dx", "bwd_weights")
    result = {name: {} for name in names}
    suffix = "_f32" if f32 else ""
    for i in range(2):
        cfgs = tuple(shapes[i] for shapes in built)
        part = torch.empty((ffn.wgrad_splits(rows, d, ff, sms, cfgs[4])[0], total), device=dev)
        per = device_us(launches_with(cfgs, part), n=5)
        # the partials in the wrappers' order: dW1 | dW2 | db1 | db2 → dW1 | db1 | dW2 | db2
        dw1, dw2, db1, db2 = part.sum(0).split([d * ff, d * ff, ff, d])
        got = {"h": h, "out": out, "dx": dx, "weights": torch.cat([dw1, db1, dw2, db2])}
        for key, ref in want.items():
            err, top = max_err(got[key], ref.float()), float(ref.float().abs().max())
            check(err <= bar * top, f"{key} with tiles {cfgs} at rows {rows} d {d} ff {ff} "
                                    f"rate {rate} {dtype}: {err} > {bar} * {top}")
        for name, cfg in zip(names, cfgs):
            result[name]["x".join(map(str, ffn.TILES[cfg]))] = sum(
                us / c for kn, (us, c) in per.items()
                if FFN_DEVICE_NAMES[f"fused_ffn_{name}{suffix}"][0] in kn)
    picked = ffn.tile_configs(rows, d, ff, sms, dtype)
    result["picked"] = dict(zip(names, picked))
    if f32:  # the launches at the picked tiles, then the drift over ff
        launches_with(picked, torch.empty((ffn.wgrad_splits(rows, d, ff, sms, picked[4])[0],
                                           total), device=dev))()
        plain_out = layer_sm90.bias_product(UNPROMOTED["chip_smoke_unpromoted_bias"], h, w2, b2)
        plain_dx = layer_sm90.round_product(UNPROMOTED["chip_smoke_unpromoted_round"], dh, w1)
        want64 = {"out": h.double() @ w2.double().t() + b2.double(),
                  "dx": dh.double() @ w1.double()}
        result["drift_over_ff_of_max"] = {}
        for key, promoted, unpromoted in (("out", out, plain_out), ("dx", dx, plain_dx)):
            top = float(want64[key].abs().max())
            result["drift_over_ff_of_max"][key] = {
                "promoted": float((promoted.double() - want64[key]).abs().max()) / top,
                "unpromoted": float((unpromoted.double() - want64[key]).abs().max()) / top,
                "max_abs_f64": top}
    return result


def ln_grids(dev, rows: int, d: int) -> dict:
    """The LN kernels' grids at one bf16 shape: blocks, backward warps a block
    and the backward's tree of tickets."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bwd = ln.ln_grid(rows, d, torch.bfloat16, sms, True)
    return {"fwd_blocks": ln.ln_grid(rows, d, torch.bfloat16, sms, False), "bwd_blocks": bwd,
            "bwd_warps_a_block": ln.bwd_warps(d, torch.bfloat16),
            "bwd_ticket_tree": ln.ticket_tree(bwd)}


def phase_ffn_ln(dev, rng) -> dict:
    """The FFN's launches in both dtypes (wrapped: ``ffn_forward`` and
    ``ffn_backward``) against ``ffn_reference`` and its autograd, and the two
    LN kernels against ``dropout_add_layernorm_reference`` on the card, with
    the same masks, at the shapes phases 18 and 19 give them, a ragged one,
    and in f32 widths of 4 mod 8; each shape's timings. A hidden unit within
    rounding of 0 may fall on either side of the ReLU's kink: the plain
    version takes the kernel's side at such units only (``kink_flips``)."""
    checks, worst = [], {"ffn": 0.0, "ln": 0.0}
    cases = [(shape, dtype) for shape in (*FFN_SHAPES, RAGGED_FFN_SHAPE)
             for dtype in (torch.float32, torch.bfloat16)]
    for (rows, d, ff, cfg_rate), dtype in cases + [(F32_ONLY_FFN_SHAPE, torch.float32)]:
        args, dy, y, scale, bias = ffn_case(dev, rng, rows, d, ff, dtype)
        x, w1, _, w2, _ = args
        active = None
        for rate in (0.0, cfg_rate):
            what = f"rows {rows} d {d} ff {ff} {dtype} rate {rate}"
            seed = torch.tensor([1234 + rows], dtype=torch.int32, device=dev)
            runs = []
            for _ in range(2):
                out, h = ffn.ffn_forward(*args, seed, rate)
                runs.append((out, h, *ffn.ffn_backward(dy, x, h, w1, w2, rate)))
            torch.cuda.synchronize()
            bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
            check(bitwise, f"two FFN runs with one seed differ at {what}")
            out, h, *grads = runs[0]
            with torch.no_grad():
                own_h = ffn.ffn_reference(*args, seed, rate, return_hidden=True)[1]
            flips, kink = fl.kink_flips(own_h, h)
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            want_out, want_h = ffn.ffn_reference(*leaves, seed, rate, return_hidden=True,
                                                 relu_flips=flips)
            want_out.backward(dy)
            errs = {}
            held_to(errs, "out", out, want_out, dtype, what)
            held_to(errs, "h", h, want_h, dtype, what)
            for name, g, leaf in zip(FFN_GRADS, grads, leaves):
                held_to(errs, name, g, leaf.grad, dtype, what)
            # the share of the ReLU's live units that the mask kept: within
            # 2e-3 of the quantised rate, or 5 standard deviations where
            # the units are too few for that (the ragged shape)
            live = int((h > 0).sum())
            active = live if rate == 0.0 else active
            kept, p_keep = live / active, quantized_keep_rate(rate)
            check(abs(kept - p_keep) < max(2e-3, 5 * (p_keep * (1 - p_keep) / active) ** 0.5),
                  f"FFN mask kept {kept} at {what}")
            if dtype == torch.float32:
                worst["ffn"] = max(worst["ffn"], errs["out"], errs["h"], errs["dx"])
            checks.append({"kernel": "fused_ffn", "rows": rows, "d": d, "ff": ff,
                           "dtype": str(dtype)[6:], "rate": rate, "max_abs_err": errs,
                           "bitwise_repeat": bitwise, "relu_kink_flips": kink,
                           "kept_share": kept})
            del leaves, want_out, want_h, own_h, flips, runs

            runs = []
            for _ in range(2):
                runs.append((ln.ln_forward(x, y, scale, bias, seed, rate),
                             *ln.ln_backward(dy, x, y, scale, seed, rate)))
            torch.cuda.synchronize()
            bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
            check(bitwise, f"two LN runs with one seed differ at {what}")
            out, *grads = runs[0]
            leaves = [a.detach().clone().requires_grad_(True) for a in (x, y, scale, bias)]
            want = ln.dropout_add_layernorm_reference(*leaves, seed, rate)
            want.backward(dy)
            errs = {}
            held_to(errs, "out", out, want, dtype, what)
            for name, g, leaf in zip(LN_GRADS, grads, leaves):
                held_to(errs, name, g, leaf.grad, dtype, what)
            kept = float((grads[1] != 0).float().mean())  # dy is 0 where y was dropped
            n_el = rows * d
            check(abs(kept - (1 - rate)) < 5 * (rate * (1 - rate) / n_el) ** 0.5 + 1e-4,
                  f"LN mask kept {kept} at {what}")
            if dtype == torch.float32:
                worst["ln"] = max(worst["ln"], errs["out"], errs["dx"], errs["dy"])
            checks.append({"kernel": "fused_ln", "rows": rows, "d": d,
                           "dtype": str(dtype)[6:], "rate": rate, "max_abs_err": errs,
                           "bitwise_repeat": bitwise, "kept_share": kept})
            del leaves, want, runs

    timings = []
    for rows, d, ff, rate in FFN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            args, dy, y, scale, bias = ffn_case(dev, rng, rows, d, ff, dtype)
            x, w1, b1, w2, b2 = args
            seed = torch.tensor([7], dtype=torch.int32, device=dev)
            h = ffn.ffn_forward(*args, seed, rate)[1]
            n = 20 if rows * d * ff < 2 ** 31 else 5
            row = {"rows": rows, "d": d, "ff": ff, "dtype": name, "rate": rate,
                   "bounds": {**ffn_bounds(rows, d, ff, name), **ln_bounds(rows, d, name)}}

            # the FFN: kernels, plain version, library composition (cuBLAS
            # products, eager relu and dropout, autograd's backward)
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            ref_out = ffn.ffn_reference(*leaves, seed, rate)
            lib = [a.detach().clone().requires_grad_(True) for a in args]
            lib[2], lib[4] = (lib[i].detach().to(dtype).requires_grad_(True) for i in (2, 4))

            def lib_ffn(p=lib):
                hid = F.dropout(torch.relu(F.linear(p[0], p[1], p[2])), rate, training=True)
                return F.linear(hid, p[3], p[4])

            lib_out = lib_ffn()

            def plain_ffn():
                with torch.no_grad():
                    ffn.ffn_reference(*args, seed, rate)

            fns = {
                "ffn_fwd": (lambda: ffn.ffn_forward(*args, seed, rate), plain_ffn,
                            lambda: lib_ffn()),
                "ffn_bwd": (lambda: ffn.ffn_backward(dy, x, h, w1, w2, rate),
                            lambda: torch.autograd.grad(ref_out, leaves, dy, retain_graph=True),
                            lambda: torch.autograd.grad(lib_out, lib, dy, retain_graph=True)),
            }
            # LN: kernels, plain version, F.layer_norm(x + F.dropout(y))
            ln_leaves = [a.detach().clone().requires_grad_(True) for a in (x, y, scale, bias)]
            ln_ref = ln.dropout_add_layernorm_reference(*ln_leaves, seed, rate)
            ln_lib = [a.detach().clone().to(dtype).requires_grad_(True)
                      for a in (x, y, scale, bias)]

            def lib_ln(p=ln_lib):
                return F.layer_norm(p[0] + F.dropout(p[1], rate, training=True), (d,), p[2], p[3])

            ln_lib_out = lib_ln()

            def plain_ln():
                with torch.no_grad():
                    ln.dropout_add_layernorm_reference(x, y, scale, bias, seed, rate)

            fns["ln_fwd"] = (lambda: ln.ln_forward(x, y, scale, bias, seed, rate), plain_ln,
                             lambda: lib_ln())
            fns["ln_bwd"] = (
                lambda: ln.ln_backward(dy, x, y, scale, seed, rate),
                lambda: torch.autograd.grad(ln_ref, ln_leaves, dy, retain_graph=True),
                lambda: torch.autograd.grad(ln_lib_out, ln_lib, dy, retain_graph=True))
            for key, (k, p, lb) in fns.items():
                k1, p1, l1, l2, p2, k2 = (time_ms(f, m) for f, m in
                                          ((k, n), (p, 3), (lb, n), (lb, n), (p, 3), (k, n)))
                row[f"{key}_kernel_ms"], row[f"{key}_plain_ms"] = [k1, k2], [p1, p2]
                row[f"{key}_library_ms"] = [l1, l2]
            for key in ("ffn_fwd", "ffn_bwd", "ln_fwd", "ln_bwd"):
                lib_device = device_us(fns[key][2], 5)
                row[f"{key}_library_device_ms"] = sum(us for us, _ in lib_device.values()) / 1e3
                row[f"{key}_library_device_launches"] = sum(c for _, c in lib_device.values())
            # the LN backward is one launch, dscale and dbias summed inside it
            one = device_us(fns["ln_bwd"][0], 5)
            check(all("ln_bwd" in k for k in one) and sum(c for _, c in one.values()) <= 1.0 + 1e-9,
                  f"an LN backward launched {one}, not one ln_bwd")
            row["ln_bwd_device_launches_per_call"] = {k: c for k, (_, c) in one.items()}
            dev_k = device_us(lambda: [fns[key][0]() for key in fns], n=3)
            row["kernel_device_us"] = {k: us / c for k, (us, c) in dev_k.items()}
            row["kernel_device_launches"] = {k: c for k, (_, c) in dev_k.items()}
            for key in ("ffn_fwd", "ffn_bwd"):
                row[f"{key}_over_library"] = (float(np.mean(row[f"{key}_kernel_ms"]))
                                              / float(np.mean(row[f"{key}_library_ms"])))
            row["tile_shapes_device_us"] = ffn_tile_shapes(dev, args, dy, seed, rate)
            timings.append(row)
            del leaves, ref_out, lib, lib_out, ln_leaves, ln_ref, ln_lib, ln_lib_out, fns
    emit({"phase": "ffn_ln_kernels", "checks": checks,
          "bars": {"float32": "1e-4 abs (out, h); 1e-4 * max|grad| (grads)",
                   "bfloat16": "2e-2 * max|ref|",
                   "kept_share": "max(2e-3, 5 sigma) of the quantised keep rate, sigma "
                                 "from the ReLU's live units (5 sigma only at the ragged "
                                 "shape's ~10,000)"},
          "library": "F.linear, relu, F.dropout, F.linear and autograd's backward; "
                     "F.layer_norm(x + F.dropout(y)) and autograd's backward",
          "timings": timings,
          "ln_resources": {"ptxas": kernel_resources("fused_ln"),
                           "ln_bwd_dynamic_smem_bytes": {
                               f"d {d} {str(t)[6:]}": ln.bwd_smem_bytes(d, t)
                               for d in (72, 256, 1024) for t in (torch.float32, torch.bfloat16)},
                           "grids_bf16": {f"rows {rows} d {d}": ln_grids(dev, rows, d)
                                          for rows, d in ((1024, 256), (16384, 256),
                                                          (4096, 1024))}}})
    return {"max_abs_err": worst, "timings": timings}


@contextlib.contextmanager
def ffn_as(role: str, kernel_h: list, kinks: list):
    """A stand-in for the model's ``ffn_train``, as ``fused_layers_as`` is for
    the layer functions: as ``"kernel"`` every call also records the kernel's
    h; as ``"plain"`` the plain version runs in place of the kernels and takes
    the kernel's side of the ReLU's kink at the units ``kink_flips`` finds
    within rounding of 0. Any other role leaves the model as it is."""
    train, replay = transformer.ffn_train, iter(kernel_h)

    def recording(*a):
        kernel_h.append(ffn.ffn_forward(*[t.detach() for t in a[:6]], a[6])[1])
        return train(*a)

    def replaying(*a):
        with torch.no_grad():
            own_h = ffn.ffn_reference(*[t.detach() for t in a[:6]], a[6], return_hidden=True)[1]
        flips, kink = fl.kink_flips(own_h, next(replay).to(own_h.device))
        kinks.append(kink["flips"])
        return ffn.ffn_reference(*a, relu_flips=flips)

    transformer.ffn_train = {"kernel": recording, "plain": replaying}.get(role, train)
    try:
        yield
    finally:
        transformer.ffn_train = train


def reconfigure(bundle, **switches) -> None:
    """Flip training switches of a model in place (they change no parameter):
    a model takes up to seconds to initialise on the host (GrooveXL has 151 M
    parameters), so the variants of one comparison share one."""
    cfg = dataclasses.replace(bundle.config, **switches)
    for m in bundle.model.modules():
        if hasattr(m, "config"):
            m.config = cfg
    bundle.config = cfg


def phase_train_wide(dev, rng) -> dict:
    """The slice's main path: the InfillingRandomLow_lm config (d 256, ff 2048,
    8 layers, dropout 0.16, batch 32; nothing cut) through ``initialize_model``
    + ``train_loop``, the layers unfused (``fused_layer=False`` given) with
    the FFN kernels in them; then with the LN kernels, then rematerialised;
    3 f32 steps through the f32 FFN launches (their main path); a 1 + 1 layer
    encoder-decoder model; paired turns in bf16 and in f32."""
    data, held = Loops(1024, 41), Loops(256, 42)
    batch, epochs, n_layers = LM_HP["batch_size"], 2, LM_HP["num_encoder_decoder_layers"]
    penalty = LM_HP["hit_loss_penalty"]
    per_epoch = len(data.processed_inputs) // batch
    steps = epochs * per_epoch
    bundle, _, _ = initialize_model(lm_params(), dev)
    cfg = bundle.config
    check(cfg.fused_ffn and not cfg.fused_layer and not cfg.remat and not cfg.fused_dropout_ln
          and cfg.compute_dtype == torch.bfloat16,
          f"the wide config did not take the FFN kernels alone in bf16: {cfg}")
    check(not resolve_fused_ffn(None, LM_HP["dim_feedforward"], LM_HP["d_model"], torch.bfloat16,
                                dev), "fused_ffn's auto is on at the lm config")
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    metrics = run_epochs(bundle, data, held, epochs, batch, penalty=penalty)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches(NEW_KERNELS)  # ... and ends here
    lm_rows, d, ff = batch * 32, LM_HP["d_model"], LM_HP["dim_feedforward"]
    want = {**ffn_launches(lm_rows, d, ff, torch.bfloat16, steps * n_layers),
            **{k: 0 for k in ln.KERNELS}}
    check(counts == want and not any(launches(LAYER_KERNELS).values()),
          f"wide-FFN training launched {counts}, expected {want} ({steps} steps x {n_layers} "
          f"layers), and the layer kernels {launches(LAYER_KERNELS)}")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    # the same with every LN(x + dropout(y)) site through the LN kernels: the
    # LN kernels' main path
    ln_bundle, _, _ = initialize_model(lm_params(fused_dropout_ln=True), dev)
    reset_launches()  # the LN kernels' main path starts here
    ln_losses = [m["loss"] for m in run_epochs(ln_bundle, data, held, 2, batch, penalty=penalty)]
    ln_counts = launches(NEW_KERNELS)  # ... and ends here
    want = {**ffn_launches(lm_rows, d, ff, torch.bfloat16, 2 * per_epoch * n_layers),
            **{k: 2 * per_epoch * 2 * n_layers for k in ln.KERNELS}}
    check(ln_counts == want, f"with fused_dropout_ln: launched {ln_counts}, expected {want}")
    check(all(np.isfinite(ln_losses)) and ln_losses[-1] < ln_losses[0],
          f"with fused_dropout_ln the loss did not fall: {ln_losses}")
    # a step's device launches: one ln_bwd a backward site and nothing else of
    # the LN's (dscale and dbias are summed inside it; the design before it
    # launched a sum of its partials as well)
    ln_step = step_breakdown(ln_bundle, batch, 48, count=("ln_fwd", "ln_bwd", "reduce"))
    sites = 2 * n_layers
    check(ln_step["launches_per_step_of"]["ln_fwd"] <= sites
          and ln_step["launches_per_step_of"]["ln_bwd"] <= sites,
          f"the LN path's step launched {ln_step['launches_per_step_of']}, more than "
          f"{sites} of each LN kernel")

    # rematerialised: every layer's forward runs again in the backward
    remat_bundle, _, _ = initialize_model(lm_params(remat=True), dev)
    reset_launches()
    remat_losses = [m["loss"] for m in
                    run_epochs(remat_bundle, data, held, 2, batch, penalty=penalty)]
    remat_counts = launches(ffn.KERNELS)
    want = ffn_launches(lm_rows, d, ff, torch.bfloat16, 2 * per_epoch * n_layers, 2)
    check(remat_counts == want, f"with remat: launched {remat_counts}, expected {want}")
    check(all(np.isfinite(remat_losses)) and remat_losses[-1] < remat_losses[0],
          f"with remat the loss did not fall: {remat_losses}")

    # one step's gradients with and without remat, at dropout 0.16: equal only
    # if the recompute replays the forward's masks
    x = torch.from_numpy(data.processed_inputs[:batch]).to(dev)
    y = torch.from_numpy(data.processed_outputs[:batch]).to(dev)
    grads = {}
    probe, _, _ = initialize_model(lm_params(), dev)
    probe.model.train()
    for name, switches in (("plain", {}), ("remat", dict(remat=True)),
                           ("remat_dots", dict(remat=True, remat_policy="dots")),
                           ("remat_ln", dict(remat=True, fused_dropout_ln=True)),
                           ("plain_ln", dict(fused_dropout_ln=True))):
        reconfigure(probe, remat=False, remat_policy=None, fused_dropout_ln=False)
        reconfigure(probe, **switches)
        probe.model.zero_grad(set_to_none=True)
        pred = probe.model(x, generator=torch.Generator(dev).manual_seed(5))
        calculate_loss(pred, y, penalty).total_loss.backward()
        grads[name] = [p.grad for p in probe.model.parameters()]
    remat_err = {}
    for name, other in (("remat", "plain"), ("remat_dots", "plain"), ("remat_ln", "plain_ln")):
        top = max(float(g.abs().max()) for g in grads[other])
        remat_err[name] = {
            "max_abs_err": max(max_err(a, g) for a, g in zip(grads[name], grads[other])),
            "max_abs_grad": top,
            "bitwise": all(torch.equal(a, g) for a, g in zip(grads[name], grads[other]))}
        check(remat_err[name]["max_abs_err"] <= 1e-6 * top,
              f"gradients with {name} differ from {other}: {remat_err[name]}")
    del grads, probe

    # peak memory of a step at batch 512, with and without remat
    big = Loops(1024, 43)
    peak = {}
    for name, b in (("plain", bundle), ("remat", remat_bundle)):
        seqs_per_s(b, big, 512)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        seqs_per_s(b, big, 512)
        peak[name] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                      "over_resident_bytes": torch.cuda.max_memory_allocated() - base}
    check(peak["remat"]["over_resident_bytes"] < peak["plain"]["over_resident_bytes"],
          f"remat did not lower the step's peak memory: {peak}")

    # 3 f32 steps at dropout 0: the kernel path against the plain-version path
    # (the kernel's side of a ReLU kink, ``ffn_as``) and against fused_ffn=False
    kernel_h, kinks, three = [], [], {}
    x = torch.from_numpy(data.processed_inputs[:96]).to(dev)
    y = torch.from_numpy(data.processed_outputs[:96]).to(dev)
    reset_launches()  # the f32 route's path: its kernels launch here only
    for name in ("kernel", "plain", "unfused"):
        b, _, _ = initialize_model(
            lm_params(bf16=False, dropout=0.0, fused_ffn=name != "unfused"), dev)
        epoch_fn = make_epoch_fn(penalty, 32, 96, shuffle=False)
        with ffn_as(name, kernel_h, kinks):
            epoch_fn(b.state, x, y, torch.Generator(dev).manual_seed(0))
        check(b.state.step == 3, f"{name}: {b.state.step} steps, expected 3")
        three[name] = {k: v.detach().cpu() for k, v in b.model.state_dict().items()}
    f32_counts = launches(ffn.F32_KERNELS)  # the forward twice a call: ffn_as records h
    check(f32_counts == {k: v for k, v in ffn_launches(32 * 32, d, ff, torch.float32,
                                                       3 * n_layers, 2).items()
                         if k in ffn.F32_KERNELS}
          and not any(launches(ffn.BF16_KERNELS).values()),
          f"3 f32 steps launched {launches(ffn.KERNELS)}")
    param_err = {other: max(max_err(three["kernel"][k], three[other][k]) for k in three["kernel"])
                 for other in ("plain", "unfused")}
    check(param_err["plain"] <= 1e-4 and param_err["unfused"] <= UNFUSED_BAR,
          f"3 f32 steps: params differ by {param_err} (kink flips per FFN call: {kinks})")

    # a 1 + 1 layer encoder-decoder model at the same width, FFN and LN kernels
    # in both layers
    small = Loops(128, 44)
    encdec, _, _ = initialize_model(
        lm_params(num_encoder_layers=1, num_decoder_layers=1, fused_dropout_ln=True), dev)
    check(encdec.config.fused_ffn and not encdec.config.fused_layer
          and not encdec.config.fused_decoder_layer, f"1 + 1 model's switches: {encdec.config}")
    reset_launches()
    encdec_losses = [m["loss"] for m in
                     run_epochs(encdec, small, held, 3, batch, encoder_only=0, penalty=penalty)]
    encdec_counts = launches(NEW_KERNELS)
    encdec_steps = 3 * (128 // batch)
    want = {**ffn_launches(lm_rows, d, ff, torch.bfloat16, encdec_steps * 2),
            **{k: encdec_steps * 5 for k in ln.KERNELS}}
    check(encdec_counts == want, f"1 + 1 model launched {encdec_counts}, expected {want}")
    check(all(np.isfinite(encdec_losses)) and encdec_losses[-1] < encdec_losses[0],
          f"1 + 1 model's loss did not fall: {encdec_losses}")

    # throughput: fused_ffn on and off, then with the LN kernels, then with
    # remat on and off, in turns; 16 steps at batch 32, 4 at batch 512
    models = {"fused_ffn": bundle, "unfused": initialize_model(lm_params(fused_ffn=False), dev)[0],
              "fused_ffn_ln": ln_bundle, "fused_ffn_remat": remat_bundle,
              "unfused_remat": initialize_model(lm_params(fused_ffn=False, remat=True), dev)[0],
              "fused_layer": initialize_model(lm_params(fused_layer=True), dev)[0]}
    check(models["fused_layer"].config.fused_layer, "fused_layer=True was not kept")
    reset_launches()
    throughput, breakdown = {}, {}
    for b in THROUGHPUT_BATCHES:
        corpus, warm = Loops(512 if b == 32 else 2048, 45), Loops(2 * b, 46)
        runs = {k: [] for k in models}
        for which in [*models, *reversed(models)]:
            seqs_per_s(models[which], warm, b)
            runs[which].append(seqs_per_s(models[which], corpus, b))
        throughput[b] = runs
        breakdown[b] = step_breakdown(bundle, b, 47)
    layer_counts = launches(fl.SM90_KERNELS)
    check(len(set(layer_counts.values())) == 1 and min(layer_counts.values()) > 0,
          f"the forced whole-layer path launched {layer_counts}")

    # f32 (bf16: false): fused_ffn on against off in F32_PAIRS pairs of turns
    # a batch, the layers unfused (lm_params forces fused_layer=False: under
    # auto the f32 chain would take the whole layer at d 256)
    f32_models = {"kernel": initialize_model(lm_params(bf16=False), dev)[0],
                  "unfused": initialize_model(lm_params(bf16=False, fused_ffn=False), dev)[0]}
    check(f32_models["kernel"].config.compute_dtype == torch.float32
          and f32_models["kernel"].config.fused_ffn and not f32_models["kernel"].config.fused_layer
          and not f32_models["unfused"].config.fused_ffn, "the f32 turns' switches")
    before = launches(ffn.F32_KERNELS)
    f32_turns = {b: paired_turns(f32_models, Loops(512 if b == 32 else 2048, 45), b)
                 for b in THROUGHPUT_BATCHES}
    check(all(v > before[k] for k, v in launches(ffn.F32_KERNELS).items()
              if not k.startswith("fused_ffn_reduce")),
          f"the f32 turns did not run the f32 FFN launches: {launches(ffn.F32_KERNELS)}")
    f32_breakdown = {which: step_breakdown(m, 512, 49) for which, m in f32_models.items()}
    del f32_models
    emit({"phase": "train_wide_ffn", "config": LM_HP, "data": "1024 seeded synthetic loops",
          "epochs": epochs, "steps": steps, "seconds": seconds, "launches": counts,
          "losses": losses, "last_metrics": metrics[-1],
          "fused_dropout_ln": {"launches": ln_counts, "losses": ln_losses,
                               "step_breakdown_batch_32": ln_step},
          "remat": {"launches": remat_counts, "losses": remat_losses,
                    "one_step_gradients_vs_unrematerialised": remat_err,
                    "step_memory_batch_512": peak},
          "three_f32_steps_param_err": param_err, "three_f32_steps_kink_flips": kinks,
          "three_f32_steps_launches": f32_counts,
          "unfused_bar": UNFUSED_BAR,
          "encoder_decoder_1_plus_1": {"steps": encdec_steps, "launches": encdec_counts,
                                       "losses": encdec_losses},
          "seqs_per_s": throughput, "step_breakdown": breakdown,
          "fused_layer_launches_in_its_turns": layer_counts,
          "f32_paired_turns_fused_ffn": f32_turns,
          "f32_step_breakdown_batch_512": f32_breakdown})
    return {"launches": counts, "ln_launches": ln_counts, "encdec_launches": encdec_counts,
            "f32_launches": f32_counts, "f32_turns": f32_turns}


def phase_train_groovexl(dev, rng) -> dict:
    """GrooveXL (d 1024, 8 heads, ff 4096, 12 layers, dropout 0.1, batch 128,
    bf16, remat on; nothing cut but the number of steps) through
    ``initialize_model`` + ``make_epoch_fn``; then the same in f32 through the
    f32 FFN launches, with fused_ffn on against off in paired turns."""
    hp = XL_HP
    n_layers, batch = hp["num_encoder_layers"], hp["batch_size"]
    params = {"model": {k: hp[k] for k in ("d_model", "n_heads", "dim_feedforward", "dropout",
                                           "num_encoder_layers", "remat", "optimizer",
                                           "fused_ffn")},
              "training": {"learning_rate": hp["learning_rate"], "batch_size": batch, "seed": 0}}
    t0 = time.perf_counter()
    bundle, _, _ = initialize_model(params, dev)
    init_seconds = time.perf_counter() - t0
    cfg = bundle.config
    check(cfg.fused_ffn and cfg.remat and not cfg.fused_layer
          and cfg.compute_dtype == torch.bfloat16, f"GrooveXL's switches: {cfg}")
    auto_remat = resolve_remat(None, d_model=hp["d_model"], n_heads=hp["n_heads"],
                               dim_feedforward=hp["dim_feedforward"], n_layers=n_layers,
                               batch_size=batch, compute_dtype=torch.bfloat16, device=dev)
    n = 4 * batch  # scripts/bench_groovexl_ffn.py's corpus: 4 steps an epoch
    data = Loops(n, 51)
    x = torch.from_numpy(data.processed_inputs).to(dev)
    y = torch.from_numpy(data.processed_outputs).to(dev)
    epoch_fn = make_epoch_fn(hp["hit_loss_penalty"], batch, n)
    gen = torch.Generator(dev).manual_seed(0)
    one_step = make_epoch_fn(hp["hit_loss_penalty"], batch, batch)  # warm-ups, breakdown
    epochs, steps = 2, 2 * 4
    reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    metrics = [fetch(epoch_fn(bundle.state, x, y, gen)) for _ in range(epochs)]
    seconds = time.perf_counter() - t0
    counts = launches(NEW_KERNELS)  # ... and ends here
    xl_rows = batch * 32
    want = {**ffn_launches(xl_rows, hp["d_model"], hp["dim_feedforward"], torch.bfloat16,
                           steps * n_layers, 2),
            **{k: 0 for k in ln.KERNELS}}
    check(counts == want, f"GrooveXL launched {counts}, expected {want} ({steps} steps x "
                          f"{n_layers} layers, the forward twice under remat)")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    def epoch_rate(epochs: int = 2) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(epochs):
            fetch(epoch_fn(bundle.state, x, y, gen))
        return epochs * n / (time.perf_counter() - t0)

    def step_peak() -> dict:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fetch(epoch_fn(bundle.state, x, y, gen))
        return {"peak_bytes": torch.cuda.max_memory_allocated(),
                "over_resident_bytes": torch.cuda.max_memory_allocated() - base}

    peak = {"remat": step_peak()}
    reconfigure(bundle, remat=False)
    before = launches(ffn.KERNELS)
    peak["plain"] = step_peak()
    no_remat_counts = {k: v - before[k] for k, v in launches(ffn.KERNELS).items()}
    check(no_remat_counts == ffn_launches(xl_rows, hp["d_model"], hp["dim_feedforward"],
                                          torch.bfloat16, 4 * n_layers),
          f"GrooveXL without remat launched {no_remat_counts} in 4 steps")
    check(peak["remat"]["over_resident_bytes"] < peak["plain"]["over_resident_bytes"],
          f"remat did not lower GrooveXL's peak memory: {peak}")
    rates = {"fused_ffn_remat": [], "unfused_remat": [], "fused_ffn": [], "unfused": []}
    for which in [*rates, *reversed(rates)]:
        reconfigure(bundle, fused_ffn=which.startswith("fused_ffn"),
                    remat=which.endswith("remat"))
        fetch(one_step(bundle.state, x[:batch], y[:batch], gen))
        rates[which].append(epoch_rate())
    reconfigure(bundle, fused_ffn=True, remat=True)
    per_kernel = device_us(lambda: fetch(one_step(bundle.state, x[:batch], y[:batch], gen)), n=2)
    total = sum(us for us, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    n_params = sum(p.numel() for p in bundle.model.parameters())
    del bundle

    # f32 (bf16: false) at the same width and depth, under remat: 2 epochs
    # through the f32 FFN launches, then fused_ffn on against off in
    # F32_PAIRS pairs of turns, the same model reconfigured
    f32_bundle, _, _ = initialize_model(dict(params, model={**params["model"], "bf16": False}),
                                        dev)
    check(f32_bundle.config.compute_dtype == torch.float32 and f32_bundle.config.fused_ffn
          and f32_bundle.config.remat and not f32_bundle.config.fused_layer,
          f"GrooveXL f32's switches: {f32_bundle.config}")
    f32_epoch = make_epoch_fn(hp["hit_loss_penalty"], batch, n)
    reset_launches()  # the f32 route's GrooveXL run starts here
    f32_metrics = [fetch(f32_epoch(f32_bundle.state, x, y, gen)) for _ in range(epochs)]
    f32_counts = launches(NEW_KERNELS)  # ... and ends here
    want = {**ffn_launches(xl_rows, hp["d_model"], hp["dim_feedforward"], torch.float32,
                           steps * n_layers, 2), **{k: 0 for k in ln.KERNELS}}
    check(f32_counts == want, f"GrooveXL f32 launched {f32_counts}, expected {want}")
    f32_losses = [m["loss"] for m in f32_metrics]
    check(all(np.isfinite(v) for m in f32_metrics for v in m.values())
          and f32_losses[-1] < f32_losses[0], f"GrooveXL f32: {f32_metrics}")

    def f32_rate(fused: bool) -> float:
        reconfigure(f32_bundle, fused_ffn=fused)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            fetch(f32_epoch(f32_bundle.state, x, y, gen))
        return 2 * n / (time.perf_counter() - t0)

    for fused in (True, False):  # a warm-up epoch each
        reconfigure(f32_bundle, fused_ffn=fused)
        fetch(f32_epoch(f32_bundle.state, x, y, gen))
    f32_turns = {"kernel": [], "unfused": []}
    for i in range(F32_PAIRS):
        for which in ("kernel", "unfused") if i % 2 == 0 else ("unfused", "kernel"):
            f32_turns[which].append(f32_rate(which == "kernel"))
    ratios = [a / b for a, b in zip(f32_turns["kernel"], f32_turns["unfused"])]
    spread = max(max(v) / min(v) - 1 for v in f32_turns.values())
    f32_paired = {"seqs_per_s": f32_turns, "pair_ratios": ratios,
                  "worst_pair_gain": min(ratios) - 1, "spread": spread,
                  "gains": min(ratios) - 1 > spread}
    f32_steps = {}
    for which in ("unfused", "kernel"):
        reconfigure(f32_bundle, fused_ffn=which == "kernel")
        f32_steps[which] = device_us(
            lambda: fetch(one_step(f32_bundle.state, x[:batch], y[:batch], gen)), n=2)
    emit({"phase": "train_groovexl", "config": hp, "auto_remat_on_this_card": auto_remat,
          "parameters": n_params,
          "initialize_model_seconds": init_seconds, "data": f"{n} seeded synthetic loops",
          "epochs": epochs, "steps": steps, "seconds": seconds, "launches": counts,
          "losses": losses, "last_metrics": metrics[-1], "step_memory": peak,
          "seqs_per_s": rates,
          # each turn's pair of paths ran back to back
          "fused_over_unfused": {
              "remat": [a / b for a, b in zip(rates["fused_ffn_remat"], rates["unfused_remat"])],
              "plain": [a / b for a, b in zip(rates["fused_ffn"], rates["unfused"])]},
          "step_breakdown": {"step_device_ms": total / 1e3,
                             "launches_per_step": sum(c for _, c in per_kernel.values()),
                             "top_kernels_us_per_step": {k: us for k, (us, _) in top}},
          "f32": {"launches": f32_counts, "losses": f32_losses,
                  "last_metrics": f32_metrics[-1], "paired_turns_fused_ffn": f32_paired,
                  "step_breakdown": {which: {
                      "step_device_ms": sum(us for us, _ in step.values()) / 1e3,
                      "launches_per_step": sum(c for _, c in step.values()),
                      "top_kernels_us_per_step": {
                          k: us for k, (us, _) in sorted(step.items(),
                                                         key=lambda kv: -kv[1][0])[:8]}}
                      for which, step in f32_steps.items()}}})
    return {"launches": counts, "f32_launches": f32_counts, "f32_turns": f32_paired}


class StopAfterBlocks(_GracefulStop):
    """``run_training``'s ``_stopper`` hook: a stop requested at the end of
    block ``blocks`` (the loop reads ``requested`` once a block)."""

    def __init__(self, blocks: int):
        super().__init__()
        self._reads, self._blocks = 0, blocks

    @property
    def requested(self):
        self._reads += 1
        return self._reads >= self._blocks

    @requested.setter
    def requested(self, value):
        pass


def train_run(hp, data, dev, root, name, augment, bundle=None, initial_epoch=0, stopper=None):
    """``run_training`` logging into its own run directory under ``root`` →
    (bundle, metrics.jsonl's records, checkpoint directory)."""
    xlog.init(run_dir=os.path.join(root, "runs", name))
    run_dir, ckpt_dir = xlog.run.dir, os.path.join(root, name)
    try:
        bundle = run_training(hp, data, device=dev, bundle=bundle, initial_epoch=initial_epoch,
                              ckpt_dir=ckpt_dir, on_device_augment=augment,
                              watch_log_freq=CKPT_WATCH_FREQ, _stopper=stopper)
    finally:
        xlog.finish()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return bundle, [json.loads(line) for line in f], ckpt_dir


def resumed_run(hp, data, dev, root, name, augment, stop_after: int) -> dict:
    """``hp.epochs`` epochs uninterrupted against ``stop_after`` blocks, a stop,
    a fresh ``initialize_model(load_model=...)`` and the rest: parameters and
    the last block's metrics must be equal bit for bit."""
    reset_launches()  # the main path's run starts here
    reset_front_end_launches()
    full, full_lines, _ = train_run(hp, data, dev, root, f"{name}_full", augment)
    counts = {**launches(fl.SM90_KERNELS), "band_energies": BAND_K.launches,
              "device_synth": SYNTH_K.launches}  # ... and ends here
    _, stopped_lines, stopped_dir = train_run(hp, data, dev, root, f"{name}_stopped", augment,
                                              stopper=StopAfterBlocks(stop_after))
    check([r["epoch"] for r in stopped_lines] == list(range(stop_after)),
          f"{name}: the stopped run logged epochs {[r['epoch'] for r in stopped_lines]}")
    spec = hp.to_dict()
    params = model_params({**FLAGSHIP_HP, **spec, "load_model": {"dir": stopped_dir}})
    bundle, _opt, initial = initialize_model(params, dev)
    check(initial == stop_after and bundle.config == full.config,
          f"{name}: resumed at epoch {initial} with {bundle.config}")
    resumed, resumed_lines, _ = train_run(hp, data, dev, root, f"{name}_resumed", augment,
                                          bundle=bundle, initial_epoch=initial)
    torch.cuda.synchronize()
    unequal = [k for (k, a), b in zip(full.model.state_dict().items(),
                                      resumed.model.state_dict().values())
               if not torch.equal(a, b)]
    check(not unequal, f"{name}: resumed parameters differ from the uninterrupted run's: "
                       f"{unequal[:4]}")
    keys = ("loss", "grad_norm", "hit_accuracy", "hit_perplexity", "bce_hits",
            "mse_velocities", "mse_offsets")
    differ = {k: (full_lines[-1][k], resumed_lines[-1][k]) for k in keys
              if full_lines[-1][k] != resumed_lines[-1][k]}
    check(not differ and full_lines[-1]["epoch"] == resumed_lines[-1]["epoch"],
          f"{name}: the last block's metrics differ: {differ}")
    return {"full": full, "last_metrics": {k: full_lines[-1][k] for k in keys},
            "losses": [r["loss"] for r in full_lines], "records": full_lines, "counts": counts}


def save_costs(state, config, root: str, name: str) -> dict:
    """What a save costs the training thread, synchronous (fetch, serialise,
    write on the caller) and by snapshot (a device copy and a queued job),
    the save worker's seconds, the file's size and the restore's seconds
    (read and parse the file, map it to the state dict, load that into a
    model on the card; the model is built before the clock starts)."""
    sync_dir, async_dir = os.path.join(root, f"{name}_sync"), os.path.join(root, f"{name}_async")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(sync_dir, name, 0, state, 1.0, config)
    sync_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_snapshot_async(async_dir, name, 0, ckpt.snapshot_state_on_device(state), 1.0,
                             config)
    held_s = time.perf_counter() - t0
    ckpt.flush_async_saves()
    worker_s = time.perf_counter() - t0
    model = build_model(config, next(state.model.parameters()).device)
    ckpt._blob_cache.clear()  # a restore that parses the file
    t0 = time.perf_counter()
    params, opt_state, epoch = ckpt.restore({"dir": async_dir}, config)
    model.load_state_dict(torch_compat.state_dict_from_flax_params(params, config), strict=True)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    live = state.model.state_dict()
    check(epoch == 1 and all(torch.equal(model.state_dict()[k], v) for k, v in live.items()),
          f"{name}: the restored weights differ from the saved ones")
    with open(path, "rb") as a, open(os.path.join(async_dir, os.path.basename(path)), "rb") as b:
        check(a.read() == b.read(), f"{name}: the snapshot file differs from the sync file")
    return {"ckpt_bytes": os.path.getsize(path),
            "parameters": sum(v.numel() for v in live.values()),
            "sync_save_held_s": sync_s, "snapshot_save_held_s": held_s,
            "save_worker_s": worker_s, "restore_s": restore_s}


def phase_checkpoint(dev, rng, smi: str) -> dict:
    """20. save, resume, serve: ``run_training`` at the flagship width from
    the YAML (read on the card by the port's reader), 512 loops rendered by
    the audio augment inside every epoch, 4 epochs in blocks of 1, a save
    after each, watch histograms every 32 steps; 2 + 2 epochs with a stop and
    a resume equal to it bit for bit, and Adam 1 + 1 against 2; the newest
    ``.ckpt`` served by ``serve.main`` with no architecture flags; what a
    save and a restore cost at the flagship and at GrooveXL width."""
    import tempfile

    yaml_hp = load_hyperparameters(os.path.join(ROOT, "configs", "InfillingRandom_training.yaml"))
    check(yaml_hp.to_dict() == HyperParams.from_dict(FLAGSHIP_HP).to_dict(),
          "the YAML read on the card differs from FLAGSHIP_HP")
    hp = HyperParams.from_dict({**yaml_hp.to_dict(), "epochs": CKPT_EPOCHS})
    grids = Loops(CKPT_LOOPS, 28).processed_outputs
    qpms = np.random.default_rng(29).uniform(90.0, 150.0, CKPT_LOOPS)
    augment = make_on_device_augment(qpms=qpms, mode="audio")

    class Grids:
        processed_inputs = processed_outputs = grids

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        sgd = resumed_run(hp, Grids, dev, root, "sgd", augment, stop_after=2)
        counts = sgd["counts"]  # the uninterrupted run's
        steps = CKPT_EPOCHS * (CKPT_LOOPS // hp.batch_size)
        watches = steps // CKPT_WATCH_FREQ
        renders = CKPT_EPOCHS * -(-CKPT_LOOPS // ds.DEFAULT_CHUNK) + watches
        want = {**{k: (steps + watches) * hp.num_encoder_decoder_layers
                   for k in fl.SM90_KERNELS},
                "band_energies": renders, "device_synth": renders}
        check(counts == want, f"the checkpointed run launched {counts}, expected {want}")
        check(all(np.isfinite(v) for v in sgd["last_metrics"].values()),
              f"non-finite metrics: {sgd['last_metrics']}")
        check(sgd["losses"][-1] < sgd["losses"][0], f"loss did not fall: {sgd['losses']}")
        watch_lines = sum(any(k.startswith("gradients/") for k in r) for r in sgd["records"])
        check(watch_lines == watches, f"{watch_lines} records hold watch histograms, "
                                      f"expected {watches}")
        adam_hp = HyperParams.from_dict({**hp.to_dict(), "optimizer_algorithm": "adam",
                                         "learning_rate": 1e-3, "epochs": 2})
        adam = resumed_run(adam_hp, Grids, dev, root, "adam", augment, stop_after=1)

        # serve the newest .ckpt of the uninterrupted run: the file carries
        # the architecture (and the run's bf16), so no flags
        ckpt_dir = os.path.join(root, "sgd_full")
        trained = sgd["full"]
        sd_live = {k: v.detach().cpu() for k, v in trained.model.state_dict().items()}
        memory_srv = serve.InfillServer(sd_live, trained.config, batch_sizes=(1,), device=dev)
        x = rng.standard_normal((1, 32, 16)).astype(np.float32)
        grid = (rng.random((32, 27)) < 0.25).astype(np.float32)
        httpd = serve.main(["--ckpt", ckpt_dir, "--port", "0", "--batch-sizes", "1"],
                           block=False)
        try:
            MHA.launches = 0  # the serving path's run starts here
            reset_front_end_launches()
            code, mso_reply = post(httpd.server_address[1], {"input": x.tolist()})
            mso_launches = MHA.launches
            code2, hvo_reply = post(httpd.server_address[1],
                                    {"hvo_input": grid.tolist(), "qpm": 120})
            serve_counts = {"fused_mha": MHA.launches, "band_energies": BAND_K.launches,
                            "device_synth": SYNTH_K.launches}  # ... and ends here
        finally:
            httpd.shutdown()
            httpd.server_close()
        check(code == 200 and code2 == 200, f"the served .ckpt answered {code}, {code2}")
        check(mso_launches == 6 and serve_counts == {"fused_mha": 12, "band_energies": 1,
                                                     "device_synth": 1},
              f"serving the .ckpt launched {mso_launches} then {serve_counts}")
        mso_y = np.asarray(mso_reply["hvo"], np.float32)
        hvo_y = np.asarray(hvo_reply["hvo"], np.float32)
        check(np.array_equal(mso_y.reshape(1, 32, 27), memory_srv.infill(x))
              and np.array_equal(hvo_y, memory_srv.infill_from_hvo(grid, qpm=120)),
              "the served .ckpt answers unlike the in-memory model's server")
        # the serving bar on the loaded weights: an f32 server on the card
        # against the in-memory model's plain path on the CPU
        loaded, cfg, epoch, _loss = ckpt.load_params_and_config(ckpt_dir)
        check(epoch == CKPT_EPOCHS - 1 and cfg == trained.config,
              f"the newest .ckpt is epoch {epoch} with {cfg}")
        f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
        y32 = serve.InfillServer(loaded, f32, batch_sizes=(1,), device=dev).infill(x)[0]
        cpu_model = build_model(f32, "cpu")
        cpu_model.load_state_dict(sd_live, strict=True)
        _h, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(x))
        serve_err = max(max_err(y32[:, 9:18], v_cpu[0]), max_err(y32[:, 18:], o_cpu[0]))
        check(serve_err <= 1e-4, f"the loaded weights served in f32 vs the CPU plain path: "
                                 f"{serve_err}")

        costs = {"flagship": save_costs(trained.state, trained.config, root, "flagship")}
        xl_cfg = GrooveTransformerConfig(
            d_model=XL_HP["d_model"], n_heads=XL_HP["n_heads"],
            dim_feedforward=XL_HP["dim_feedforward"], dropout=XL_HP["dropout"],
            num_encoder_layers=XL_HP["num_encoder_layers"], compute_dtype=torch.bfloat16)
        xl_state = create_train_state(xl_cfg, "sgd", XL_HP["learning_rate"], 0, dev)
        costs["groovexl"] = save_costs(xl_state, xl_cfg, root, "groovexl")
        del xl_state
    torch.cuda.empty_cache()
    emit({"phase": "checkpoint", "card": smi, "config": hp.to_dict(),
          "data": f"{CKPT_LOOPS} seeded synthetic loops, 90-150 bpm, audio augment",
          "launches": counts, "losses": sgd["losses"], "last_metrics": sgd["last_metrics"],
          "resume": "bit for bit (SGD 2 + 2 against 4, Adam 1 + 1 against 2)",
          "adam_last_metrics": adam["last_metrics"], "serving_launches": serve_counts,
          "served_max_abs_err_f32_vs_cpu_plain": serve_err, "save_costs": costs})
    return {"launches": counts, "serving_launches": serve_counts, "save_costs": costs}


# phase 21: the command lines as a user runs them, each in a child process.
# The child runs the module as ``python -m`` does (runpy) and, when it exits,
# writes its kernels' launch counts (each starts at 0 in a new process) and
# the module's own seconds to the file named after the module
CLI_RUNNER = """
import json, os, runpy, sys, time
from transformergrooveinfilling_tpu_torch.ops import (
    attention, band_energies, device_synth, fused_layer)
kernels = {"fused_mha": attention.KERNEL, "band_energies": band_energies.KERNEL,
           "device_synth": device_synth.KERNEL, **fused_layer.SM90_KERNELS}
for step in json.loads(sys.argv[1]):
    os.chdir(step["cwd"])
    os.environ.update(step["env"])
    for k in kernels.values():
        k.launches = 0
    print(step["mark"], flush=True)
    sys.argv = [step["module"]] + step["args"]
    t0 = time.perf_counter()
    try:
        runpy.run_module(step["module"], run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (None, 0):
            raise
    finally:
        with open(step["out"], "w") as f:
            json.dump({"seconds": time.perf_counter() - t0,
                       "launches": {k: v.launches for k, v in kernels.items()}}, f)
    for key in step["env"]:
        os.environ.pop(key)
"""
STEP_MARK = "=== chip_smoke step "  # the runner's line before each command line's output
CLI_PROCESS = "transformergrooveinfilling_tpu_torch.process_dataset"
CLI_TRAIN = "transformergrooveinfilling_tpu_torch.train"
CLI_SPLITS = {"train": 3300, "test": 1100, "validation": 1100}  # 330 / 110 / 110 loops x 10
CLI_WALL_S = 5.0  # --max_wall_s of each training run: a few flagship blocks
CLI_TRACE_S = 7.0  # and more for the traced run: its first block writes a ~90 MB trace
CLI_MSO_ITEMS = 64
CLI_CONFIG = os.path.join(ROOT, "configs", "InfillingRandom_training.yaml")
# the kernels a trace of the first block must name: #2's bf16 chain (its
# products, attention and LayerNorm launches), #6 and #7
TRACE_KERNELS = ("gemm_kernel", "attn_fwd", "attn_bwd", "ln_rows", "synth_kernel",
                 "band_energies_kernel")


def runner_steps(steps) -> tuple[str, list]:
    """:data:`CLI_RUNNER`'s argument for ``steps``, each ``(module, args,
    cwd, env)``: one ``python -m module args`` after another in one
    process, each in its cwd with its environment and its launch counts
    written beside it → (argument, counts files)."""
    spec, counts = [], []
    for i, (module, args, cwd, env) in enumerate(steps):
        os.makedirs(cwd, exist_ok=True)
        counts.append(os.path.join(cwd, f"{module.rsplit('.', 1)[-1]}.launches.json"))
        spec.append({"module": module, "args": list(args), "cwd": cwd, "env": env,
                     "out": counts[-1], "mark": f"{STEP_MARK}{i}"})
    return json.dumps(spec), counts


def start_steps(steps, threads: int | None = None):
    """Start the command lines ``steps`` (:func:`runner_steps`) in one child
    process with this checkout on the path → (process, counts files, start)."""
    arg, counts = runner_steps(steps)
    child_env = {**os.environ, "PYTHONPATH": ROOT}
    if threads:
        child_env["OMP_NUM_THREADS"] = str(threads)
    proc = subprocess.Popen([sys.executable, "-c", CLI_RUNNER, arg], cwd=steps[0][2],
                            env=child_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, counts, time.perf_counter()


def start_cli(module: str, args, cwd: str, threads: int | None = None, **env):
    """Start ``python -m module args`` (through :data:`CLI_RUNNER`) in
    ``cwd`` → (process, counts files, start)."""
    return start_steps([(module, args, cwd, env)], threads)


def finish_steps(started, what: str, timeout: float = 300.0) -> list:
    """Wait for a child of :func:`start_steps`; it must exit 0 → per command
    line its module seconds, launch counts and output, the first also the
    child's wall seconds (its start included) and all of its errors."""
    proc, counts, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n{err[-6000:]}")
    parts = re.split(rf"^{re.escape(STEP_MARK)}\d+\n", out, flags=re.M)[1:]
    check(len(parts) == len(counts), f"{what}: {len(parts)} outputs for {len(counts)} steps")
    results = []
    for path, part in zip(counts, parts):
        with open(path) as f:
            results.append({**json.load(f), "stdout": part, "stderr": err})
    results[0]["wall_seconds"] = wall
    return results


def finish_cli(started, what: str, timeout: float = 300.0) -> dict:
    """:func:`finish_steps` of one command line: its wall seconds, module
    seconds, launch counts and output."""
    return finish_steps(started, what, timeout)[0]


def run_cli(module: str, args, cwd: str, what: str, **env) -> dict:
    return finish_cli(start_cli(module, args, cwd, **env), what)


def run_records(cwd: str) -> tuple:
    """The run directory of the one run logged under ``cwd`` and its records."""
    found = [d for d, _subs, files in os.walk(cwd) if "metrics.jsonl" in files]
    check(len(found) == 1, f"{cwd}: {len(found)} metrics.jsonl files")
    with open(os.path.join(found[0], "metrics.jsonl")) as f:
        return found[0], [json.loads(line) for line in f]


def newest_epoch(ckpt_dir: str) -> int:
    epochs = [int(m.group(1)) for f in os.listdir(ckpt_dir)
              if (m := re.search(r"_Epoch_(\d+)\.ckpt$", f))]
    check(bool(epochs), f"no .ckpt in {ckpt_dir}")
    return max(epochs)


def trace_kernels(run_cwd: str) -> dict:
    """The ``TGI_PROFILE`` trace of a run under ``run_cwd``: its path, and
    the device kernels it holds by the names of :data:`TRACE_KERNELS`."""
    found = [os.path.join(d, f) for d, _subs, files in os.walk(run_cwd) for f in files
             if os.path.basename(d) == "profile"]
    check(len(found) == 1, f"{run_cwd}: {len(found)} profile traces: {found}")
    with open(found[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {k: sum(k in e.get("name", "") for e in kernels) for k in TRACE_KERNELS}
    return {"file": os.path.relpath(found[0], run_cwd), "bytes": os.path.getsize(found[0]),
            "kernel_events": len(kernels), "by_name": by_name,
            "device_busy_us": sum(e.get("dur", 0) for e in kernels)}


def generation_costs(dev, train_dir: str) -> dict:
    """One host generation (``StreamingAugmenter``, audio, on the producer's
    stream) and one fused render (``make_on_device_augment``, once a block)
    of the train split, each with its seconds and the launches of #6 and #7."""
    from transformergrooveinfilling_tpu_torch.data import load_processed_dataset
    from transformergrooveinfilling_tpu_torch.data.pipeline import StreamingAugmenter

    data = load_processed_dataset(train_dir, "InfillingRandom")
    base = np.stack([s.hvo for s in data.hvo_sequences]).astype(np.float32)
    qpms = np.asarray([s.tempos[0].qpm for s in data.hvo_sequences], np.float64)
    reset_front_end_launches()
    with StreamingAugmenter(base, qpms=qpms, aug_per_item=data.max_aug_items, mode="audio",
                            device=dev) as streamer:
        seconds = []
        for _ in range(3):
            streamer.next_epoch_delta()
            seconds.append(streamer.last_generation_seconds)
        host_n = streamer.n_samples
    # a generation the consumer has not taken may be in flight when close() ran
    per_generation = sum(-(-min(2048, host_n - s) // ds.DEFAULT_CHUNK)
                         for s in range(0, host_n, 2048))  # 2048-item slabs, 256-item chunks
    host = {"items": host_n, "seconds": seconds,
            "launches_per_generation": {"band_energies": per_generation,
                                        "device_synth": per_generation},
            "launches_seen": {"band_energies": BAND_K.launches,
                              "device_synth": SYNTH_K.launches}}
    check(BAND_K.launches >= 3 * host["launches_per_generation"]["band_energies"]
          and SYNTH_K.launches >= 3 * host["launches_per_generation"]["device_synth"],
          f"3 host generations launched {host['launches_seen']}")
    grids = np.repeat(base, data.max_aug_items, axis=0)
    n = len(grids) // 64 * 64
    augment = make_on_device_augment(qpms=np.repeat(qpms, data.max_aug_items)[:n], mode="audio")
    g = torch.from_numpy(grids[:n]).to(dev)
    fused = []
    for i in range(3):
        torch.cuda.synchronize()
        reset_front_end_launches()
        t0 = time.perf_counter()
        inputs, _outputs = augment(torch.Generator(dev).manual_seed(i), g, g)
        torch.cuda.synchronize()
        fused.append({"seconds": time.perf_counter() - t0,
                      "launches": {"band_energies": BAND_K.launches,
                                   "device_synth": SYNTH_K.launches}})
    check(bool(torch.isfinite(inputs).all()), "the fused render is not finite")
    return {"host": host, "fused": {"items": n, "calls": fused}}


def cli_launches(cli: dict, kernel: str) -> dict:
    """A front-end kernel's launches in each command line of phase 21."""
    return {"process_dataset": cli["process_dataset"]["launches"][kernel],
            **{f"train_{mode}": run["launches"][kernel] for mode, run in cli["train"].items()}}


def phase_cli(dev, smi: str, root: str) -> dict:
    """21. the command lines: ``process_dataset --experiments InfillingRandom``
    at the default synthetic sizes on the card, beside a CPU build of the
    validation split (outputs bit for bit, 64 MSO inputs at the MSO bar);
    ``train --config configs/InfillingRandom_training.yaml`` at the flagship
    width for a few blocks each with ``--streaming off``, ``host`` (auto
    cadence) and ``fused``, the last resumed from the off run's newest
    ``.ckpt`` under ``TGI_PROFILE=1``, the build and the three runs one after
    another in one child process; one host generation and one fused render
    timed in process. All under ``root``, a temporary directory that phase 22
    goes on to use."""
    from transformergrooveinfilling_tpu_torch.data import load_processed_dataset

    on_dev = ["--device", dev.type]
    data_dir = os.path.join(root, "card", "datasets", "InfillingRandom", "0.0.0")
    paths = os.path.join(root, "paths.yaml")
    with open(paths, "w") as f:
        f.write("InfillingRandom:\n  datasets:\n" + "".join(
            f"    {s}: {os.path.join(data_dir, s)}\n" for s in CLI_SPLITS))
    common = ["--config", CLI_CONFIG, "--paths", paths, "--wandb", "False", "--eval_train",
              "False", "--eval_validation", "False", "--dump_eval", "False", *on_dev]
    # the build on the card, then training on it: off and host from fresh
    # weights, fused resumed from the off run's newest .ckpt, its first block
    # traced; the four command lines one after another in one child process,
    # so one process start is paid; beside it the CPU build of the validation
    # split
    runs, resumed = {}, {}
    steps = [(CLI_PROCESS, ["--experiments", "InfillingRandom", *on_dev],
              os.path.join(root, "card"), {})]
    modes = (("off", [], {}), ("host", ["--regen_cadence", "auto"], {}),
             ("fused", ["--load_model", os.path.join(root, "off", "ck")], {"TGI_PROFILE": "1"}))
    for mode, extra, env in modes:
        cwd = os.path.join(root, mode)
        wall = CLI_WALL_S + (CLI_TRACE_S if mode == "fused" else 0.0)
        steps.append((CLI_TRAIN, common + extra + [
            "--streaming", mode, "--max_wall_s", str(wall),
            "--ckpt_dir", os.path.join(cwd, "ck")], cwd, env))
    card = start_steps(steps)
    cpu = start_cli(CLI_PROCESS, ["--experiments", "InfillingRandom", "--splits",
                                  "validation", "--device", "cpu"],
                    os.path.join(root, "cpu"), threads=2)
    cpu_built = finish_cli(cpu, "process_dataset --device cpu")
    built, *trained = finish_steps(card, "process_dataset on the card, then train --streaming "
                                   "off, host and fused", timeout=900.0)
    sizes = {s: len(load_processed_dataset(os.path.join(data_dir, s), "InfillingRandom"))
             for s in CLI_SPLITS}
    check(sizes == CLI_SPLITS, f"process_dataset built {sizes}")
    on_card = load_processed_dataset(os.path.join(data_dir, "validation"), "InfillingRandom")
    on_cpu = load_processed_dataset(os.path.join(root, "cpu", "datasets", "InfillingRandom",
                                                 "0.0.0", "validation"), "InfillingRandom")
    check(np.array_equal(on_card.processed_outputs, on_cpu.processed_outputs)
          and on_card.hvo_index == on_cpu.hvo_index
          and on_card.soundfonts == on_cpu.soundfonts,
          "the card's validation split differs from the CPU build's in its outputs")
    got, want = on_card.processed_inputs[:CLI_MSO_ITEMS], on_cpu.processed_inputs[:CLI_MSO_ITEMS]
    mso_err = max_err(got, want)
    check(np.allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-4),
          f"64 MSO inputs from the card against the CPU route: {mso_err}")
    check(built["launches"]["device_synth"] > 0 and built["launches"]["band_energies"] > 0,
          f"process_dataset on the card launched {built['launches']}")
    resumed["from_epoch"] = newest_epoch(os.path.join(root, "off", "ck"))
    for (mode, _extra, _env), run in zip(modes, trained):
        _run_dir, records = run_records(os.path.join(root, mode))
        losses = [r["loss"] for r in records]
        check(len(records) >= 2 and all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"--streaming {mode}: losses {losses}")
        chain = {k: v for k, v in run["launches"].items() if k in fl.SM90_KERNELS}
        check(all(v > 0 for v in chain.values()),
              f"--streaming {mode} did not run #2's bf16 chain: {chain}")
        if mode != "off":
            check(run["launches"]["device_synth"] > 0 and run["launches"]["band_energies"] > 0,
                  f"--streaming {mode} launched {run['launches']}")
        runs[mode] = {"module_seconds": run["seconds"],
                      "launches": run["launches"], "losses": losses,
                      "epochs": [r["epoch"] for r in records],
                      "seqs_per_sec": [r["seqs_per_sec"] for r in records],
                      "epoch_time_s": [r["epoch_time_s"] for r in records],
                      "printed": [line for line in run["stdout"].splitlines()
                                  if line.startswith("streaming")]}
    check(runs["fused"]["epochs"][0] == resumed["from_epoch"] + 1,
          f"resumed from epoch {resumed['from_epoch']}, logged epochs "
          f"{runs['fused']['epochs']}")
    resumed["trace"] = trace_kernels(os.path.join(root, "fused"))
    check(all(resumed["trace"]["by_name"].values()),
          f"the trace misses kernels: {resumed['trace']['by_name']}")
    costs = generation_costs(dev, os.path.join(data_dir, "train"))
    out = {"card": smi, "process_dataset": {
               "items": CLI_SPLITS, "module_seconds": built["seconds"],
               # the child's wall seconds and, less its four command lines',
               # a process's start
               "child_wall_seconds_with_train": built["wall_seconds"],
               "process_start_seconds": built["wall_seconds"] - built["seconds"]
               - sum(run["seconds"] for run in trained),
               "items_per_s": sum(CLI_SPLITS.values()) / built["seconds"],
               "launches": {k: built["launches"][k] for k in ("device_synth", "band_energies")},
               "cpu_validation_wall_seconds": cpu_built["wall_seconds"],
               "mso_max_abs_err_vs_cpu": mso_err},
           "train": runs, "resumed": resumed, "generations": costs}
    emit({"phase": "cli", **out})
    return out


# phase 22: evaluation, the command lines of phase 21's datasets with evaluators
CLI_PROCESS_EVALUATOR = "transformergrooveinfilling_tpu_torch.process_evaluator"
CLI_EVALUATE = "transformergrooveinfilling_tpu_torch.evaluate"
EVAL_SPLITS = ("train", "validation")
EVAL_WALL_S = 12.0  # --max_wall_s of the training run with both evaluators: a few blocks
EVAL_MEDIA_FAILED = "media worker: a deferred media pass failed"


def evaluator_pickle(cwd: str, split: str) -> str:
    return os.path.join(cwd, "datasets", "preprocessed_evaluators", "InfillingEvaluator_0.3.2",
                        f"InfillingRandom_{split}_0.0.0_evaluator.pickle")


def families_of(records: list, epoch: int, ident: str) -> dict:
    return {k: v for r in records if r.get("epoch") == epoch for k, v in r.items()
            if k.startswith(ident + "_") and ("_Accuracy_" in k or "_MSE_" in k)}


def media_of(run_dir: str, records: list, epoch: int, ident: str) -> dict:
    """What epoch ``epoch``'s media pass of the set ``ident`` wrote: the
    files of its piano rolls, heatmaps and audio (each checked to exist and
    hold data) and its stats CSV."""
    (record,) = [r for r in records if r.get("epoch") == epoch and f"{ident}_stats" in r]
    # {ident: {"{ident}.{kind}": {"{ident}.{kind}.{name}": path or [paths]}}}
    files = [(kind.split(".")[1], p) for kind, group in record[ident].items()
             for v in group.values() for p in (v if isinstance(v, list) else [v])]
    for kind in ("piano_roll_html", "velocity_heatmaps", "audios"):
        check(any(k == kind for k, _ in files), f"epoch {epoch} {ident}: no {kind}")
    paths = [p for _, p in files] + [record[f"{ident}_stats"]]
    sizes = {p: os.path.getsize(os.path.join(run_dir, p)) for p in paths}
    wavs = [p for p in paths if p.endswith(".wav")]
    check(bool(wavs) and all(sizes[p] > 44 for p in wavs), f"{ident}: empty audio {wavs[:3]}")
    check(all(sizes[p] > 0 for p in paths), f"{ident}: an empty media file")
    csv = [f for f in os.listdir(run_dir) if f.startswith("stats_") and f.endswith(
        f"_Epoch_{epoch}.csv")]
    check(len(csv) == 1, f"epoch {epoch}: stats CSV {csv}")
    return {"files": len(paths), "wav": len(wavs), "bytes": sum(sizes.values()), "csv": csv[0]}


def phase_eval(dev, smi: str, root: str) -> dict:
    """22. evaluation on the card, at the flagship width, nothing cut, the
    command lines in child processes ((a)'s card build and (b) one after the
    other in one), on phase 21's datasets under ``root``:
    (a) ``process_evaluator --experiments InfillingRandom --splits train
    validation`` on the card (#6, #7), beside the validation evaluator built
    with ``--device cpu``: tags, indices and GT arrays bit for bit, MSO inputs
    within atol 1e-5 · max and rtol 1e-4 of the CPU's host route, or where an
    onset moves by a sample between the routes (ROADMAP C9) of the device
    route's plain versions on the CPU; (b) ``train --config
    configs/InfillingRandom_training.yaml`` with the evaluator flags at their
    defaults (train and validation, media asynchronous, evaluator dumps) for
    a few blocks: every block logs both sets' held-out losses, every block but
    the stop's their metric families; epoch 0's media pass writes piano
    rolls, heatmaps, audio and the stats CSV; no held error of the media
    worker; #1 six launches a forward (two forwards a set a block, one more on
    a media epoch), #2's bf16 chain in training; (c) ``evaluate`` of the last
    evaluated epoch's ``.ckpt`` with the validation evaluator on the card,
    its families equal to the run's within 1e-6, and with ``--device cpu``
    (bf16 on the CPU, as the checkpoint says); the same weights in f32 on the
    card and on the CPU, hits by ``hit_agreement`` at 0.5 and at the threshold
    that makes 5 % of the cells hits, velocities and offsets within 1e-4; (d) in process, the seconds and launches of a scalar-only
    eval pass over both sets (``train/driver.py::_make_eval_pass`` and one
    fetch of each packed result) and of a media pass (``log_eval`` of both
    sets, rendering inline), once."""
    from transformergrooveinfilling_tpu_torch.eval.evaluator import init_evaluator, log_eval
    from transformergrooveinfilling_tpu_torch.train.driver import ModelBundle, _make_eval_pass

    data_dir = os.path.join(root, "card", "datasets", "InfillingRandom", "0.0.0")
    card_cwd, cpu_cwd = os.path.join(root, "eval_card"), os.path.join(root, "eval_cpu")
    paths = os.path.join(root, "paths_eval.yaml")
    with open(paths, "w") as f:
        f.write("InfillingRandom:\n  datasets:\n"
                + "".join(f"    {s}: {os.path.join(data_dir, s)}\n" for s in CLI_SPLITS)
                + "  evaluators:\n"
                + "".join(f"    {s}: {evaluator_pickle(card_cwd, s)}\n" for s in EVAL_SPLITS))
    # (a) the evaluators on the card, then (b) training with both of them,
    # the evaluator flags at their defaults, one after the other in one child
    # process; beside it the validation evaluator built on the CPU
    train_cwd = os.path.join(root, "eval_train")
    card = start_steps([
        (CLI_PROCESS_EVALUATOR, ["--experiments", "InfillingRandom", "--splits", *EVAL_SPLITS,
                                 "--paths", paths], card_cwd, {}),
        (CLI_TRAIN, ["--config", CLI_CONFIG, "--paths", paths, "--wandb", "False",
                     "--max_wall_s", str(EVAL_WALL_S), "--ckpt_dir",
                     os.path.join(train_cwd, "ck"), "--device", dev.type], train_cwd, {})])
    cpu = start_cli(CLI_PROCESS_EVALUATOR, ["--experiments", "InfillingRandom", "--splits",
                                            "validation", "--paths", paths, "--device", "cpu"],
                    cpu_cwd, threads=2)
    cpu_built = finish_cli(cpu, "process_evaluator --device cpu")
    built, run = finish_steps(card, "process_evaluator on the card, then train with evaluators")
    evs = {s: init_evaluator(evaluator_pickle(card_cwd, s), device=dev) for s in EVAL_SPLITS}
    on_cpu = init_evaluator(evaluator_pickle(cpu_cwd, "validation"), device="cpu")
    on_card = evs["validation"]
    for name in ("_gt_tags", "_gt_hvos_array_tags", "hvo_index", "unused_items",
                 "audio_sample_locations", "soundfonts"):
        check(getattr(on_card, name) == getattr(on_cpu, name),
              f"the validation evaluators' {name} differ between the card and the CPU")
    for name in ("_gt_hvos_array", "_gmd_gt_hvos_array", "processed_gt"):
        check(np.array_equal(getattr(on_card, name), getattr(on_cpu, name)),
              f"the validation evaluators' {name} differ between the card and the CPU")
    # the CPU build takes the host route (numpy mixer, onsets in f64), the card
    # the device route (onsets in f32): where an onset lands a sample apart
    # (ROADMAP C9) a row is held to the device route's plain versions instead
    got, want = on_card.processed_inputs, on_cpu.processed_inputs
    bar = dict(atol=1e-5 * np.abs(want).max(), rtol=1e-4)
    moved = np.nonzero(~np.isclose(got, want, **bar).all(axis=(1, 2)))[0]
    mso_err = max_err(np.delete(got, moved, 0), np.delete(want, moved, 0))
    if moved.size:
        rows_in = on_cpu.hvo_sequences_inputs
        plain = mso.mso_batch_from_hvo(
            np.stack([rows_in[i].hvo for i in moved]).astype(np.float32),
            [on_cpu.soundfonts[i] for i in moved],
            np.asarray([rows_in[i].tempos[0].qpm for i in moved], np.float32),
            params=mso.MSOParams(**on_cpu.dataset.mso_params), device="cpu",
            device_synth=True, method="fused")
        check(np.allclose(got[moved], plain, **bar),
              f"{moved.size} MSO rows off the host route are off the device route's plain "
              f"versions too: {max_err(got[moved], plain)}")
        mso_err = max(mso_err, max_err(got[moved], plain))
    rows = {s: len(ev.processed_inputs) for s, ev in evs.items()}
    check(rows == EVAL_ROWS, f"evaluator rows {rows}, phase 3 held #1 at {EVAL_ROWS}")
    check(built["launches"]["device_synth"] > 0 and built["launches"]["band_energies"] > 0,
          f"process_evaluator on the card launched {built['launches']}")

    # (b) training with both evaluators
    check(EVAL_MEDIA_FAILED not in run["stdout"],
          "the media worker held errors:\n" + "\n".join(
              line for line in run["stdout"].splitlines() if EVAL_MEDIA_FAILED in line))
    run_dir, records = run_records(train_cwd)
    blocks = [r for r in records if "loss" in r]
    losses = [r["loss"] for r in blocks]
    check(len(blocks) >= 2 and all(np.isfinite(losses)), f"training losses {losses}")
    for r in blocks:
        check(all(f"{s}_{k}" in r and np.isfinite(r[f"{s}_{k}"]) for s in EVAL_SPLITS
                  for k in ("loss", "hit_accuracy", "bce_hits", "mse_velocities", "mse_offsets")),
              f"epoch {r['epoch']} lacks a held-out loss: {sorted(r)}")
    evaluated = [r["epoch"] for r in blocks if not r.get("graceful_stop")]
    for epoch in evaluated:
        for s in EVAL_SPLITS:
            fam = families_of(records, epoch, f"{s.capitalize()}_Set")
            check(len(fam) == 30 and all(np.isfinite(list(fam.values()))),
                  f"epoch {epoch}: {s}'s families {len(fam)}")
    hp = load_hyperparameters(CLI_CONFIG)
    _partial, save_all = eval_log_freq(hp.epochs, 10, 1, 1, 10, 20)
    media_epochs = [e for e in evaluated if e in set(int(x) for x in save_all)]
    check(evaluated[0] == 0 and media_epochs[:1] == [0], f"evaluated epochs {evaluated}")
    media = {s: media_of(run_dir, records, 0, f"{s.capitalize()}_Set") for s in EVAL_SPLITS}
    forwards = len(EVAL_SPLITS) * (2 * len(blocks) + len(media_epochs))
    check(run["launches"]["fused_mha"] == 6 * forwards,
          f"#1 launched {run['launches']['fused_mha']} times in training with evaluators, "
          f"expected 6 a forward, {forwards} forwards")
    chain = {k: v for k, v in run["launches"].items() if k in fl.SM90_KERNELS}
    check(all(v > 0 for v in chain.values()), f"training did not run #2's bf16 chain: {chain}")
    dumps = sorted(os.listdir(os.path.join(train_cwd, "evaluator")))
    check(len(dumps) == len(EVAL_SPLITS) * len(media_epochs), f"evaluator dumps {dumps}")

    # (c) re-score the last evaluated epoch's checkpoint
    epoch = evaluated[-1]
    rescore = ["--ckpt", os.path.join(train_cwd, "ck"), "--epoch", str(epoch), "--evaluator",
               evaluator_pickle(card_cwd, "validation"), "--media", "0"]
    card_eval = start_cli(CLI_EVALUATE, rescore + ["--run_dir", os.path.join(root, "rescore")],
                          os.path.join(root, "rescore_card"))
    cpu_eval = start_cli(CLI_EVALUATE, rescore + ["--run_dir", os.path.join(root, "rescore_cpu"),
                                                  "--device", "cpu"],
                         os.path.join(root, "rescore_cpu_cwd"), threads=4)
    card_scored = finish_cli(card_eval, "evaluate on the card")
    cpu_scored = finish_cli(cpu_eval, "evaluate --device cpu")
    ident = "Validation_Set"
    in_run = families_of(records, epoch, ident)
    rescored = families_of(run_records(os.path.join(root, "rescore"))[1], epoch, ident)
    rescored_cpu = families_of(run_records(os.path.join(root, "rescore_cpu"))[1], epoch, ident)
    check(rescored.keys() == in_run.keys() == rescored_cpu.keys(), "families' keys differ")
    rescore_err = max(abs(rescored[k] - in_run[k]) for k in in_run)
    check(rescore_err <= 1e-6, f"evaluate's families against the run's: {rescore_err}")
    check(card_scored["launches"]["fused_mha"] == 6, f"evaluate launched {card_scored['launches']}")
    state_dict, config, _e, _loss = ckpt.load_params_and_config(
        os.path.join(train_cwd, "ck", next(f for f in os.listdir(os.path.join(train_cwd, "ck"))
                                           if f.endswith(f"_Epoch_{epoch}.ckpt"))))
    f32 = dataclasses.replace(config, compute_dtype=torch.float32)
    x = on_card.processed_inputs
    card_model, cpu_model = build_model(f32, dev), build_model(f32, "cpu")
    for m in (card_model, cpu_model):
        m.load_state_dict(state_dict, strict=True)
        m.eval()
    sig_card, v, o = (a.cpu().numpy() for a in predict(
        card_model, torch.from_numpy(x).to(dev), use_thres=False))
    sig, v_cpu, o_cpu = (a.numpy() for a in predict(cpu_model, torch.from_numpy(x),
                                                    use_thres=False))
    vo_err = max(max_err(v, v_cpu), max_err(o, o_cpu))
    check(vo_err <= 1e-4, f"f32 predictions, card against CPU: v/o differ by {vo_err}")
    # a young run may predict no hit at 0.5: hold the hits at 0.5 and at the
    # threshold that makes 5 % of the CPU's cells hits
    thresholds = (0.5, float(np.quantile(sig, 0.95)))
    for thres in thresholds:
        check(hit_agreement(sig_card > thres, sig > thres, sig - thres + 0.5),
              f"f32 predictions: hits at {thres} differ away from the threshold")

    # (d) a scalar-only eval pass and a media pass, timed in process
    state = create_train_state(config, "sgd", 0.1, 0, dev)
    state.model.load_state_dict(state_dict, strict=True)
    bundle = ModelBundle(model=state.model, config=config, state=state, device=dev)
    sets = {s: tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                     for a in (ev.processed_inputs, ev.processed_gt, ev._gt_hvos_array))
            for s, ev in evs.items()}
    eval_pass = _make_eval_pass(bundle.model, sets, hp.hit_loss_penalty)
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        MHA.launches = 0
        t0 = time.perf_counter()
        losses_t, stacks_t = eval_pass()
        losses_np, stacks_np = losses_t.cpu().numpy(), stacks_t.cpu().numpy()
        passes.append({"seconds": time.perf_counter() - t0, "launches": MHA.launches})
    check(all(p["launches"] == 6 * 2 * len(sets) for p in passes), f"eval pass {passes}")
    check(np.isfinite(losses_np).all() and np.isfinite(stacks_np).all(), "eval pass not finite")
    check(abs(float(stacks_np[1, 0].mean()) - in_run[f"{ident}_Hits_Accuracy_mean"]) <= 1e-6,
          "the eval pass's validation hit accuracy differs from the run's")
    media_passes = []
    xlog.init(config={}, project="chip_smoke_media", run_dir=os.path.join(root, "media_pass"))
    try:
        for _ in range(1):
            MHA.launches = 0
            t0 = time.perf_counter()
            for s, ev in evs.items():
                ev._identifier = f"{s.capitalize()}_Set"
                log_eval(ev, bundle, log_media=True, epoch=epoch, dump=False)
            torch.cuda.synchronize()
            media_passes.append({"seconds": time.perf_counter() - t0, "launches": MHA.launches})
    finally:
        xlog.finish()
    check(all(p["launches"] == 6 * len(evs) for p in media_passes), f"media pass {media_passes}")
    out = {"card": smi,
           "process_evaluator": {
               "rows": rows, "child_wall_seconds_with_train": built["wall_seconds"],
               "module_seconds": built["seconds"],
               "launches": {k: built["launches"][k] for k in ("device_synth", "band_energies")},
               "cpu_validation_wall_seconds": cpu_built["wall_seconds"],
               "mso_max_abs_err_vs_cpu": mso_err,
               "mso_rows_held_to_the_device_route": int(moved.size)},
           "train": {"module_seconds": run["seconds"],
                     "launches": run["launches"], "epochs": [r["epoch"] for r in blocks],
                     "evaluated": evaluated, "media_epochs": media_epochs, "losses": losses,
                     "validation_loss": [r["validation_loss"] for r in blocks],
                     "seqs_per_sec": [r["seqs_per_sec"] for r in blocks],
                     "epoch_time_s": [r["epoch_time_s"] for r in blocks],
                     "media_epoch_0": media, "evaluator_dumps": len(dumps)},
           "rescore": {"epoch": epoch, "max_abs_err_vs_run": rescore_err,
                       "card_wall_seconds": card_scored["wall_seconds"],
                       "cpu_wall_seconds": cpu_scored["wall_seconds"],
                       "launches": card_scored["launches"]["fused_mha"],
                       "hits_accuracy_mean": {
                           "run": in_run[f"{ident}_Hits_Accuracy_mean"],
                           "card": rescored[f"{ident}_Hits_Accuracy_mean"],
                           "cpu_bf16": rescored_cpu[f"{ident}_Hits_Accuracy_mean"]},
                       "f32_vo_max_abs_err_card_vs_cpu": vo_err,
                       "f32_hit_thresholds": thresholds,
                       "f32_hit_share_at_0.5": float((sig > 0.5).mean())},
           "scalar_eval_pass": passes, "media_pass": media_passes}
    emit({"phase": "eval", **out})
    ckpt_path = os.path.join(train_cwd, "ck", next(
        f for f in os.listdir(os.path.join(train_cwd, "ck")) if f.endswith(f"_Epoch_{epoch}.ckpt")))
    return {**out, "rescored_families": rescored,
            "paths": {"ckpt": ckpt_path, "evaluator": evaluator_pickle(card_cwd, "validation")}}


# phase 23: MIDI in and out, and SoundFont kits through #6 and #7
MIDI_SPLITS = {"train": 165, "test": 55, "validation": 55}  # loops of the archive
MIDI_SEEDS = {"train": 100, "test": 200, "validation": 300}
KIT_MS = (1, 64, 256)  # #6 on the three-kit table
KIT_MSO_ITEMS = 32
KIT_TRAIN_BLOCKS = 2
KIT_LATENCY_REQUESTS = 100


def cents(hz: float) -> int:
    """Absolute cents of ``hz`` (8.176 Hz = 0), as SF2 generators take them."""
    return int(round(1200 * np.log2(hz / 8.176)))


def write_kits(directory: str, sr: int = 44100) -> list:
    """Three ``.sf2`` kits (the tests' too, ``tests/kit_fixtures.py``): the
    procedural kit exported; three velocity layers a voice with
    attenuation, a lowpass and a volume envelope; a looped, panned kit with a
    modulation-envelope filter sweep (rows of 2.24 s unrolled) → their paths."""
    from transformergrooveinfilling_tpu_torch.audio.drumkit import default_kit
    from transformergrooveinfilling_tpu_torch.audio.sf2 import write_minimal_sf2
    from transformergrooveinfilling_tpu_torch.hvo.mapping import VOICE_TO_MIDI_NOTE as keys

    os.makedirs(directory, exist_ok=True)
    kit = default_kit(sr)
    t = np.arange(int(0.05 * sr)) / sr
    paths = [os.path.join(directory, n) for n in ("procedural.sf2", "layered.sf2", "looped.sf2")]
    write_minimal_sf2(paths[0], {key: kit[v] for v, key in enumerate(keys)}, sr=sr)
    write_minimal_sf2(paths[1], {key: [
        {"sample": kit[v][: int(0.2 * sr)], "vel_lo": 0, "vel_hi": 42, "atten_cb": 120,
         "filter_fc": cents(1500.0 + 300.0 * v)},
        {"sample": kit[v], "vel_lo": 43, "vel_hi": 85, "atten_cb": 40, "decay_tc": -1200,
         "sustain_cb": 300},
        {"sample": np.clip(1.3 * kit[v], -1, 1), "vel_lo": 86, "vel_hi": 127,
         "attack_tc": -6000}] for v, key in enumerate(keys)}, sr=sr)
    write_minimal_sf2(paths[2], {key: [
        {"sample": (0.6 * np.sin(2 * np.pi * 110.0 * (v + 1) * t)).astype(np.float32),
         "loop": (200, 2000), "release_tc": -2400, "pan": -400 + 100 * v,
         "filter_fc": cents(400.0), "mod_env_to_filter_fc": 5000, "decay_modenv_tc": -1800,
         "sustain_modenv": 800}] for v, key in enumerate(keys)}, sr=sr)
    return paths


def write_gmd_archive(root: str) -> int:
    """A GMD-style archive (``info.csv`` + one ``.mid`` a loop) of the seeded
    synthetic corpus, written by ``hvo_to_midi`` → the number of files."""
    import csv

    from transformergrooveinfilling_tpu_torch.data.midi import hvo_to_midi
    from transformergrooveinfilling_tpu_torch.data.synthetic import synthetic_gmd_sequences

    os.makedirs(os.path.join(root, "d", "s"))
    rows = []
    for split, n in MIDI_SPLITS.items():
        for i, seq in enumerate(synthetic_gmd_sequences(n, seed=MIDI_SEEDS[split])):
            rel = f"d/s/{split}_{i}.mid"
            hvo_to_midi(seq, os.path.join(root, rel))
            rows.append({"drummer": "d", "session": "s", "id": f"{split}_{i}",
                         "style": seq.metadata.style_primary, "bpm": seq.metadata.bpm,
                         "beat_type": "beat", "time_signature": "4-4", "midi_filename": rel,
                         "audio_filename": "", "duration": "", "split": split})
    with open(os.path.join(root, "info.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return len(rows)


def kit_events(dev, grids: np.ndarray, kits: list, packed, params, qpm: float = 120.0):
    """#6's inputs for ``grids`` at ``qpm``, item i through ``kits[i % 3]``
    of the packed table: (onset, row, gain, length)."""
    _table, base, luts, sf_index, _lengths = packed
    m = len(grids)
    item_kits = [kits[i % len(kits)] for i in range(m)]
    sf_base = torch.tensor([base[k] for k in item_kits], dtype=torch.int32, device=dev)
    sf_k = torch.tensor([sf_index[k] for k in item_kits], dtype=torch.int32, device=dev)
    length = mso.mso_waveform_length(grids.shape[1], qpm / 15.0, params)
    onset, row, gain = ds._extract_events(torch.from_numpy(grids).to(dev),
                                          torch.full((m,), qpm / 15.0, device=dev), sf_base,
                                          length, float(params.sr), luts, sf_k)
    return onset, row, gain, length


def smf_hits(hvo: np.ndarray, steps_per_loop: int = 32) -> set:
    """The (step, voice) cells a grid's hits land on after ``hvo_to_midi``
    (480 ticks a quarter, 120 a step: the tick rounded, clipped at 0) and
    ``midi_to_hvo_sequences`` (the step rounded half to even)."""
    v = hvo.shape[1] // 3
    steps, voices = np.nonzero(hvo[:, :v] > 0)
    ticks = [max(int(round((s + hvo[s, 2 * v + k]) * 120)), 0) for s, k in zip(steps, voices)]
    return {(int(round(t / 120)), int(k)) for t, k in zip(ticks, voices)}


def phase_midi_sf2(dev, smi: str, root: str, srv, sd) -> dict:
    """23. MIDI in and out, and SoundFont kits on the card, all under ``root``:
    (a) three ``.sf2`` kits written by ``write_minimal_sf2`` and read back;
    (b) #6 on their packed table (45 rows, velocity-layer LUTs) at M 1, 64
    and 256 against its plain version bit for bit, timed beside its bound and
    one ``index_add_``, with the padded and the true table bytes; (c)
    ``mso_batch_from_hvo_device`` with a kit an item against the device
    route's plain versions on the CPU (atol 2e-5 · max, rtol 1e-3); (d) an
    archive of the synthetic corpus (330 / 110 / 110 loops) written by
    ``hvo_to_midi``, ``gmd_to_processed_tree``, ``process_dataset --source
    <tree> --experiments InfillingRandom --params-json`` (``sf_path``: the
    kits' directory) on the card, then ``train --config`` (the flagship YAML
    with its epochs cut to 3) ``--streaming fused`` on it, each in a child
    process (#2, #6, #7 counted); (e) ``infill_from_hvo(grid, 120,
    sf_path=kit)`` on the flagship server against the CPU plain path (v/o
    within 1e-4, hits by ``hit_agreement``), B = 1 p50/p99 with the kit and
    the first request (which parses the kit and packs its table) apart; an
    HTTP ``"format": "midi"`` reply parsed back to its hits; a body naming
    ``sf_path`` answered 400."""
    from transformergrooveinfilling_tpu_torch.audio import sf2
    from transformergrooveinfilling_tpu_torch.data import load_processed_dataset
    from transformergrooveinfilling_tpu_torch.data.midi import (
        gmd_to_processed_tree, midi_to_hvo_sequences, parse_midi,
    )

    params, t_phase = mso.MSOParams(), time.perf_counter()
    kits = write_kits(os.path.join(root, "kits"), params.sr)
    reads = {}
    for path in kits:
        t0 = time.perf_counter()
        kit = sf2.kit_from_sf2(path, params.sr)
        reads[os.path.basename(path)] = {
            "seconds": time.perf_counter() - t0, "rows": len(kit.samples),
            "longest": max(len(x) for x in kit.samples), "file_bytes": os.path.getsize(path)}

    # (b) #6 on the packed three-kit table
    packed = ds.pack_tables(kits, params.sr, device=dev)
    table, _base, _luts, _sf_index, lengths = packed
    rows, s_max = table.shape
    check(rows == 45, f"the three kits packed {rows} rows, not 45")
    check(ds.smem_bytes(rows, 288) <= ds.MAX_SMEM,
          f"{rows} rows and 288 events need {ds.smem_bytes(rows, 288)} B of shared memory")
    table_bytes = {"rows": rows, "s_max": s_max, "padded_bytes": 4 * rows * s_max,
                   "true_bytes": 4 * int(lengths.sum()),
                   "padded_over_true": rows * s_max / int(lengths.sum())}
    loops = Loops(256, 31).processed_outputs
    synth_rows, worst = [], 0.0
    for m in KIT_MS:
        onset, row, gain, length = kit_events(dev, loops[:m], kits, packed, params)
        got = SYNTH(onset, row, gain, table, lengths, length)
        want = ds.synth_events_plain(onset, row, gain, table, length)
        err = max_err(got, want)
        worst = max(worst, err)
        check(torch.equal(got, want), f"#6 on the kit table != plain version at M {m}: {err}")
        check(bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0.1,
              f"#6 rendered silence at M {m}")
        if m > 1:  # the layered kit's items pick rows by velocity
            layered = row[1::3][gain[1::3] != 0]
            check(len(layered.unique()) > 9, f"M {m}: the velocity layers picked "
                                             f"{len(layered.unique())} rows")
        kernel = lambda: SYNTH(onset, row, gain, table, lengths, length)  # noqa: E731
        row_t = timed(kernel, lambda: ds.synth_events_plain(onset, row, gain, table, length), 3)
        flat, index, source, _ = index_add_yardstick(dev, onset, row, gain, table, lengths,
                                                     length)
        library = lambda: flat.index_add_(0, index, source)  # noqa: E731
        lib = [time_us(library, 10) / 1e3 for _ in range(2)]
        lib_device = device_us(library, 3)
        bnd = synth_bound(onset, row, gain, table, lengths, length)
        in_graph = graph_ms(kernel)
        synth_rows.append({
            "M": m, "qpm": 120.0, "length": length, **row_t, "index_add_ms": lib,
            "kernel_graph_ms": in_graph, "index_add_graph_ms": graph_ms(library, 5),
            "index_add_device_ms": sum(us for us, _ in lib_device.values()) / 1e3,
            "index_add_device_launches": sum(c for _, c in lib_device.values()),
            "index_add_elements": int(index.numel()), "live_events": int((gain != 0).sum()),
            **bnd, "bound_share_of_graph_time": bnd["bound_ms"] / in_graph,
            "samples_per_thread": ds.samples_per_thread(m, length, _build.sm_count(dev))})
        del got, want, flat, index, source

    # (c) the front end with a kit an item against its plain versions on the CPU
    grids = loops[:KIT_MSO_ITEMS]
    item_kits = [kits[i % 3] for i in range(KIT_MSO_ITEMS)]
    qpms = np.linspace(90.0, 150.0, KIT_MSO_ITEMS)
    reset_front_end_launches()
    got = ds.mso_batch_from_hvo_device(grids, item_kits, qpms, device=dev)
    mso_launches = {"device_synth": SYNTH_K.launches, "band_energies": BAND_K.launches}
    want = mso.mso_batch_from_hvo(grids, item_kits, qpms, device="cpu", device_synth=True,
                                  method="fused")
    mso_err, scale = max_err(got, want), float(np.abs(want).max())
    check(np.allclose(got, want, atol=2e-5 * scale, rtol=1e-3),
          f"kit MSOs on the card vs the plain versions on the CPU: {mso_err} (max {scale})")

    # (d) the data path: MIDI archive → tree → process_dataset → train
    t0 = time.perf_counter()
    n_files = write_gmd_archive(os.path.join(root, "gmd"))
    archive_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = gmd_to_processed_tree(os.path.join(root, "gmd"), os.path.join(root, "tree"))
    tree_s = time.perf_counter() - t0
    check(counts == MIDI_SPLITS, f"gmd_to_processed_tree gave {counts}")
    params_json = os.path.join(root, "params.json")
    with open(params_json, "w") as f:
        json.dump({"InfillingRandom": {"sf_path": os.path.join(root, "kits")}}, f)
    cwd = os.path.join(root, "run")
    data_dir = os.path.join(cwd, "datasets", "InfillingRandom", "0.0.0")
    paths, config = os.path.join(root, "paths.yaml"), os.path.join(root, "config.yaml")
    with open(paths, "w") as f:
        f.write("InfillingRandom:\n  datasets:\n" + "".join(
            f"    {s}: {os.path.join(data_dir, s)}\n" for s in MIDI_SPLITS))
    with open(CLI_CONFIG) as f:
        yaml_text = f.read()
    check("epochs: 500\n" in yaml_text, "the flagship YAML no longer says epochs: 500")
    with open(config, "w") as f:
        f.write(yaml_text.replace("epochs: 500\n", f"epochs: {KIT_TRAIN_BLOCKS}\n"))
    # the two command lines one after the other in one child process
    built, trained = finish_steps(start_steps([
        (CLI_PROCESS, ["--experiments", "InfillingRandom", "--source",
                       os.path.join(root, "tree"), "--params-json", params_json,
                       "--device", dev.type], cwd, {}),
        (CLI_TRAIN, ["--config", config, "--paths", paths, "--wandb", "False",
                     "--eval_train", "False", "--eval_validation", "False",
                     "--dump_eval", "False", "--streaming", "fused", "--device", dev.type,
                     "--ckpt_dir", os.path.join(cwd, "ck")], cwd, {})]),
        "process_dataset --source <tree>, then train --streaming fused on the kits")
    sizes = {split: len(load_processed_dataset(os.path.join(data_dir, split), "InfillingRandom"))
             for split in MIDI_SPLITS}
    check(sizes == {k: 10 * v for k, v in MIDI_SPLITS.items()}, f"process_dataset built {sizes}")
    train_set = load_processed_dataset(os.path.join(data_dir, "train"), "InfillingRandom")
    check(set(train_set.soundfonts) == set(kits), f"the items drew {set(train_set.soundfonts)}")
    check(bool(np.isfinite(train_set.processed_inputs).all()), "non-finite MSO inputs")
    check(built["launches"]["device_synth"] > 0 and built["launches"]["band_energies"] > 0,
          f"process_dataset launched {built['launches']}")
    _run_dir, records = run_records(cwd)
    losses = [r["loss"] for r in records]
    check(len(records) == KIT_TRAIN_BLOCKS and all(np.isfinite(losses))
          and losses[-1] < losses[0], f"train on the kits: losses {losses}")
    chain = {k: v for k, v in trained["launches"].items() if k in fl.SM90_KERNELS}
    check(all(v > 0 for v in chain.values()) and trained["launches"]["device_synth"] > 0
          and trained["launches"]["band_energies"] > 0,
          f"train on the kits launched {trained['launches']}")

    # (e) serving through a kit
    kit = kits[1]
    requests = [(loops[200], 120.0), (loops[201:207], 120.0), (loops[207:247], 96.0)]
    sf2.kit_from_sf2.cache_clear()  # the first request reads the kit and packs its table
    ds._table_cache.clear()
    g1 = loops[:1]
    t0 = time.perf_counter()
    srv.infill_from_hvo(g1, qpm=120.0, sf_path=kit)
    first_ms = (time.perf_counter() - t0) * 1e3
    MHA.launches = 0  # the main path's run starts here
    reset_front_end_launches()
    answers = [srv.infill_from_hvo(g, qpm=q, sf_path=kit) for g, q in requests]
    serve_launches = {"fused_mha": MHA.launches, "device_synth": SYNTH_K.launches,
                      "band_energies": BAND_K.launches}  # ... and ends here
    check(serve_launches == {"fused_mha": 6 * 4, "device_synth": 3, "band_energies": 3},
          f"kit requests launched {serve_launches}")
    cpu_model = build_model(FLAGSHIP, "cpu")
    cpu_model.load_state_dict(sd, strict=True)
    serve_err = 0.0
    for (g, q), y in zip(requests, answers):
        g3, y3 = (g[None], y[None]) if g.ndim == 2 else (g, y)
        x_cpu = mso.mso_batch_from_hvo(g3, [kit] * len(g3), np.full((len(g3),), q), device="cpu",
                                       device_synth=True, method="fused")
        h_cpu, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(x_cpu))
        sig = predict(cpu_model, torch.from_numpy(x_cpu), use_thres=False)[0].numpy()
        err = max(max_err(y3[..., 9:18], v_cpu), max_err(y3[..., 18:], o_cpu))
        serve_err = max(serve_err, err)
        check(err <= 1e-4, f"kit hvo_input at {q} bpm vs the CPU plain path: {err}")
        check(hit_agreement(y3[..., :9], h_cpu.numpy(), sig),
              f"kit hvo_input at {q} bpm: hits differ away from the threshold")
    latency = []
    for _ in range(KIT_LATENCY_REQUESTS):
        t0 = time.perf_counter()
        srv.infill_from_hvo(g1, qpm=120.0, sf_path=kit)
        latency.append((time.perf_counter() - t0) * 1e3)
    httpd = srv.serve_http(port=0, block=False)
    try:
        port = httpd.server_address[1]
        x = Loops(2, 33).processed_inputs
        code, payload = post(port, {"input": x.tolist(), "format": "midi", "qpm": 100.0})
        check(code == 200 and "midi_base64" in payload, f"format midi answered {code}")
        import base64

        blob = base64.b64decode(payload["midi_base64"])
        first = np.asarray(payload["hvo"], np.float32)[0]
        mid = parse_midi(blob)
        back = midi_to_hvo_sequences(blob, drop_empty=False)
        got_hits = {(32 * i + int(s), int(v)) for i, seq in enumerate(back)
                    for s, v in zip(*np.nonzero(seq.hits))}
        check(got_hits == smf_hits(first) and len(mid["notes"]) == int(first[:, :9].sum())
              and back[0].tempos[0].qpm == 100.0,
              f"the MIDI reply parses back to {len(got_hits)} hits, the reply has "
              f"{len(smf_hits(first))}")
        code, payload = post(port, {"hvo_input": loops[0].tolist(), "sf_path": kit})
        check(code == 400 and '"sf_path"' in payload.get("error", ""),
              f"a body naming sf_path answered {code} {payload}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    out = {
        "card": smi, "kits": reads, "table": table_bytes,
        "synth": {"bar": "bit for bit", "max_abs_err": worst, "timings": synth_rows},
        "mso": {"items": KIT_MSO_ITEMS, "max_abs_err_vs_cpu_plain": mso_err, "max_ref": scale,
                "launches": mso_launches},
        "archive": {"files": n_files, "seconds": archive_s},
        "tree": {"counts": counts, "seconds": tree_s},
        "process_dataset": {"items": sizes, "module_seconds": built["seconds"],
                            "child_wall_seconds_with_train": built["wall_seconds"],
                            "items_per_s": sum(sizes.values()) / built["seconds"],
                            "launches": {k: built["launches"][k]
                                         for k in ("device_synth", "band_energies")}},
        "train": {"module_seconds": trained["seconds"],
                  "launches": trained["launches"], "losses": losses,
                  "seqs_per_sec": [r["seqs_per_sec"] for r in records],
                  "epoch_time_s": [r["epoch_time_s"] for r in records]},
        "serve": {"launches": serve_launches, "max_abs_err_vs_cpu_plain": serve_err,
                  "first_request_ms": first_ms, "b1_p50_ms": float(np.percentile(latency, 50)),
                  "b1_p99_ms": float(np.percentile(latency, 99)), "kit": os.path.basename(kit)},
        "seconds": time.perf_counter() - t_phase}
    emit({"phase": "midi_sf2", **out})
    return out


# phase 24: serving artifacts (export.py) on the card
ARTIFACT_REQUESTS = 50  # B = 1 requests a latency run
CLI_SERVE = "transformergrooveinfilling_tpu_torch.serve"
CLI_TUTORIAL = "transformergrooveinfilling_tpu_torch.tutorial"


def artifact_bytes(path: str) -> dict:
    """An artifact's file bytes, its ``params.msgpack``'s and each program's."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        sizes = {i.filename: i.file_size for i in z.infolist()}
    return {"file": os.path.getsize(path), "params_msgpack": sizes["params.msgpack"],
            "programs": {k: v for k, v in sizes.items() if k.endswith(".pt2")}}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def wait_healthy(port: int, proc, timeout: float = 120.0) -> None:
    """Poll a child server's ``/healthz`` until it answers (or it exits)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            check(False, f"serve --artifact exited {proc.returncode}:\n"
                         f"{proc.stderr.read()[-6000:]}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                if r.status == 200:
                    return
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.25)
    check(False, f"serve --artifact did not answer within {timeout} s")


def phase_artifact(dev, smi: str, root: str, srv, sd, evaluation) -> dict:
    """24. serving artifacts on the card, under ``root``: (a) the flagship
    server's weights (d 256, 6 layers, buckets 1/8/32) and the 6 + 6 model's
    exported (``export_infill``, traced on the CPU) and loaded on the card
    (``load_infill``): export and load seconds, artifact against
    ``params.msgpack`` bytes; each held to ``InfillServer`` on the card within
    1e-5 and to the CPU plain path within 1e-4 by ``hit_agreement`` (phase 7's
    bars) at N 1, 6 and 40, #1 launched by the programs 6 (18) times a chunk;
    (b) ``InfillServer.from_exported`` answers a B = 1 ``hvo_input`` through
    #6, #7 and #1 like the server on the in-memory weights; (c) in child
    processes, started together: ``serve --artifact`` answers over HTTP like
    ``InfillServer``; ``evaluate --artifact`` of phase 22's checkpoint on its
    validation evaluator gives the families of ``evaluate --ckpt`` within
    1e-6 (the artifact's one bucket is the set's 1,099 rows, so both run one
    forward of the same shape: a bf16 product over other rows may take
    another library kernel and round otherwise); ``python -m
    transformergrooveinfilling_tpu_torch.
tutorial`` on the card, #1, #6 and #7 launched; (d) B = 1 in-process
    p50/p99 of the program beside ``InfillServer``, in turns, after the
    children have ended."""
    from transformergrooveinfilling_tpu_torch import export

    t_phase = time.perf_counter()
    rows = EVAL_ROWS["validation"]
    paths = evaluation["paths"]
    # (c) first, so the children run while (a) and (b) run here
    eval_sd, eval_cfg, _epoch, _loss = ckpt.load_params_and_config(paths["ckpt"])
    t0 = time.perf_counter()
    eval_art = export.export_infill(eval_sd, eval_cfg, os.path.join(root, "rescore.tgix"),
                                    batch_sizes=(rows,))
    eval_export_s = time.perf_counter() - t0
    flagship_art = export.export_infill(sd, FLAGSHIP, os.path.join(root, "flagship.tgix"),
                                        batch_sizes=BUCKETS)
    flagship_export_s = time.perf_counter() - t0 - eval_export_s
    port = free_port()
    serve_proc = subprocess.Popen(
        [sys.executable, "-m", CLI_SERVE, "--artifact", flagship_art, "--port", str(port)],
        cwd=root, env={**os.environ, "PYTHONPATH": ROOT}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    children = [serve_proc]
    try:
        evaluating = start_cli(CLI_EVALUATE, [
            "--artifact", eval_art, "--evaluator", paths["evaluator"], "--media", "0",
            "--epoch", str(evaluation["rescore"]["epoch"]),
            "--run_dir", os.path.join(root, "rescore_artifact")],
            os.path.join(root, "rescore_artifact_cwd"))
        children.append(evaluating[0])
        touring = start_cli(CLI_TUTORIAL, [], os.path.join(root, "tutorial"))
        children.append(touring[0])

        # (a) the flagship and the 6 + 6 model through their programs
        enc_sd = build_model(ENCDEC, "cpu", torch.Generator().manual_seed(16)).state_dict()
        t0 = time.perf_counter()
        encdec_art = export.export_infill(enc_sd, ENCDEC, os.path.join(root, "encdec.tgix"),
                                          batch_sizes=BUCKETS)
        encdec_export_s = time.perf_counter() - t0
        xs = {n: Loops(n, 24 + n).processed_inputs for n in (1, 6, 40)}
        chunks = 4  # buckets (1, 8, 32): 1 | 8 | 32 + 8
        models = {}
        for name, path, cfg, weights, server, export_s in (
                ("flagship", flagship_art, FLAGSHIP, sd, srv, flagship_export_s),
                ("encdec_6_6", encdec_art, ENCDEC, enc_sd, None, encdec_export_s)):
            if server is None:
                server = serve.InfillServer(weights, cfg, batch_sizes=BUCKETS, device=dev)
            t0 = time.perf_counter()
            loaded = export.load_infill(path, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            per_chunk = cfg.num_encoder_layers + 2 * cfg.num_decoder_layers
            loaded.predict(xs[1])  # the first call of each program builds nothing more
            loaded.predict(xs[6])
            loaded.predict(xs[40])
            MHA.launches = 0  # the artifact path's run starts here
            out = {n: loaded.predict(x) for n, x in xs.items()}
            launches = MHA.launches  # ... and ends here
            check(launches == per_chunk * chunks,
                  f"{name} artifact: fused_mha launched {launches} times, expected "
                  f"{per_chunk} a chunk ({per_chunk * chunks})")
            cpu_model = build_model(cfg, "cpu")
            cpu_model.load_state_dict(weights, strict=True)
            err_srv = err_cpu = 0.0
            for n, x in xs.items():
                y = out[n]
                check(y.shape == (n, 32, 27) and np.isfinite(y).all(), f"{name}: bad output")
                err_srv = max(err_srv, max_err(y, server.infill(x)))
                h_cpu, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(x))
                sig = predict(cpu_model, torch.from_numpy(x), use_thres=False)[0].numpy()
                err_cpu = max(err_cpu, max_err(y[..., 9:18], v_cpu), max_err(y[..., 18:], o_cpu))
                check(hit_agreement(y[..., :9], h_cpu.numpy(), sig),
                      f"{name} artifact at N={n}: hits differ from the CPU plain path")
            check(err_srv <= 1e-5, f"{name} artifact against InfillServer on the card: {err_srv}")
            check(err_cpu <= 1e-4, f"{name} artifact against the CPU plain path: {err_cpu}")
            models[name] = {"export_seconds": export_s, "load_seconds": load_s,
                            "bytes": artifact_bytes(path), "launches": launches,
                            "launches_per_chunk": per_chunk,
                            "max_abs_err_vs_server": err_srv, "max_abs_err_vs_cpu_plain": err_cpu,
                            "loaded": loaded, "server": server}

        # (b) from_exported answers hvo_input through #6, #7 and #1
        served = serve.InfillServer.from_exported(flagship_art, device=dev)
        check(served.batch_sizes == list(BUCKETS) and served.config.use_fused_attention,
              "from_exported: buckets or kernel not as exported")
        grid = Loops(1, 41).processed_outputs[0]
        MHA.launches = 0
        reset_front_end_launches()
        y_hvo = served.infill_from_hvo(grid, qpm=120.0)
        hvo_launches = {"fused_mha": MHA.launches, "band_energies": BAND_K.launches,
                        "device_synth": SYNTH_K.launches}
        check(hvo_launches == {"fused_mha": 6, "band_energies": 1, "device_synth": 1},
              f"from_exported hvo_input launched {hvo_launches}")
        hvo_err = max_err(y_hvo, srv.infill_from_hvo(grid, qpm=120.0))
        check(hvo_err <= 1e-5, f"from_exported hvo_input against the server: {hvo_err}")

        # (c) the children
        wait_healthy(port, serve_proc)
        x = xs[6]
        code, reply = post(port, {"input": x.tolist()})
        check(code == 200, f"serve --artifact answered {code}: {reply}")
        http_err = max_err(np.asarray(reply["hvo"], np.float32), srv.infill(x))
        check(http_err <= 1e-5, f"serve --artifact over HTTP against InfillServer: {http_err}")
        serve_proc.terminate()
        serve_proc.communicate(timeout=60)
        scored = finish_cli(evaluating, "evaluate --artifact")
        toured = finish_cli(touring, "the tutorial on the card")
    finally:  # no child outlives the phase, whatever failed
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ident, epoch = "Validation_Set", evaluation["rescore"]["epoch"]
    by_artifact = families_of(run_records(os.path.join(root, "rescore_artifact"))[1], epoch,
                              ident)
    by_ckpt = evaluation["rescored_families"]
    check(by_artifact.keys() == by_ckpt.keys(), "evaluate --artifact: families' keys differ")
    eval_err = max(abs(by_artifact[k] - by_ckpt[k]) for k in by_ckpt)
    check(eval_err <= 1e-6, f"evaluate --artifact against --ckpt: families differ by {eval_err}")
    # the server warms its one bucket (and, an audio model on the card, the
    # front end: #6 and #7 once), then forwards the set
    check(scored["launches"]["fused_mha"] == 2 * 6,
          f"evaluate --artifact launched {scored['launches']}")
    check("tutorial complete." in toured["stdout"], "the tutorial did not finish")
    check(all(toured["launches"][k] > 0 for k in ("fused_mha", "band_energies", "device_synth")),
          f"the tutorial on the card launched {toured['launches']}")

    # (d) B = 1 in process, the program and the server in turns
    x1 = xs[1][0]
    latency = {}
    for name in models:
        loaded, server = models[name].pop("loaded"), models[name].pop("server")
        runs = {"artifact": [], "server": []}
        for which in ("artifact", "server", "server", "artifact"):
            call = loaded.predict if which == "artifact" else server.infill
            call(x1)
            lat = []
            for _ in range(ARTIFACT_REQUESTS):
                t0 = time.perf_counter()
                call(x1)
                lat.append((time.perf_counter() - t0) * 1000.0)
            runs[which].append({"p50_ms": float(np.percentile(lat, 50)),
                                "p99_ms": float(np.percentile(lat, 99))})
        latency[name] = runs
    out = {"card": smi, "models": models, "latency_b1_in_process": latency,
           "from_exported_hvo_input": {"launches": hvo_launches, "max_abs_err_vs_server": hvo_err},
           "serve_artifact_http_max_abs_err": http_err,
           "evaluate_artifact": {"export_seconds": eval_export_s,
                                 "buckets": [rows],
                                 "wall_seconds": scored["wall_seconds"],
                                 "module_seconds": scored["seconds"],
                                 "launches": scored["launches"]["fused_mha"],
                                 "max_abs_err_vs_ckpt": eval_err},
           "tutorial": {"wall_seconds": toured["wall_seconds"],
                        "module_seconds": toured["seconds"],
                        "launches": {k: toured["launches"][k]
                                     for k in ("fused_mha", "band_energies", "device_synth")}},
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "artifact", **out})
    return out


# phase 25: batched sweeps
SWEEP_CONFIG = os.path.join(ROOT, "configs", "InfillingRandom_sweep.yaml")
CLI_SWEEP = "transformergrooveinfilling_tpu_torch.sweep"
SWEEP_TRIALS = 8  # K of the in-process group
SWEEP_EPOCHS = 1
SWEEP_THROUGHPUT_STEPS = 6  # steps a throughput turn (batch 32)
SWEEP_KS = (1, 2, 4, 5, 8)
# --count of the batched command lines: the pinned one a group that vmaps
# (sweep.VMAP_MIN_TRIALS), both within the 5 ranked lines a sweep prints
SWEEP_CLI_TRIALS = {"pinned": 5, "unpinned": 3}
# the flagship's architecture, pinned in the command lines' sweep files
SWEEP_PINNED = {k: FLAGSHIP_HP[k] for k in (
    "batch_size", "d_model", "dim_feedforward", "n_heads", "num_encoder_decoder_layers")}


def sweep_file(path: str, metric: str, **pinned) -> dict:
    """configs/InfillingRandom_sweep.yaml with ``pinned`` parameters as
    values and ``metric`` minimised, written to ``path`` in flow style (the
    port's YAML reader reads it back to the same parameters)."""
    spec = yaml_subset.load_file(SWEEP_CONFIG)
    params = {**spec["parameters"], **{k: {"value": v} for k, v in pinned.items()}}
    lines = [f"method: {spec['method']}", f"metric: {{goal: minimize, name: {metric}}}",
             f"project: '{spec['project']}'", "parameters:"]
    lines += ["  " + k + ": {" + ", ".join(f"{a}: {b!r}" for a, b in v.items()) + "}"
              for k, v in params.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    check(yaml_subset.load_file(path)["parameters"] == params, f"{path} reads back otherwise")
    return params


def phase_sweep(dev, smi: str, root: str) -> dict:
    """25. batched sweeps on phase 21's datasets under ``root``: (a) in
    process, one group of 8 trials at the flagship width (batch 32, the
    flagship's resolved dtype, the whole-layer kernels off as in any batched
    group) with learning rate, hit-loss penalty and dropout drawn from
    configs/InfillingRandom_sweep.yaml (seed 0; trial 0's lr set to 0), 1
    SGD epoch on the 3,300-item train split through
    ``make_batched_sweep_fn``: losses finite and distinct, the lr-0 trial's
    weights bit for bit; (b) ``stacked_eval_loss`` over the whole set: #1
    launched 6 times a stacked forward for the 8 trials (its vmap rule folds
    them), each trial's loss within the dtype's bar of the same trial's eager
    eval forward (#1 by the ctypes call), and the folded launch at (K·B, 2,
    32, 128) against its plain version (phase 3's bars), K 8 × B 32 and
    3,300; (c) in child processes ``python -m
    transformergrooveinfilling_tpu_torch.sweep``, 1 epoch: ``--count 5
    --batched`` on the sweep file with the flagship's architecture pinned
    (one group of 5, vmapped, every trial ranked), ``--count 3 --batched`` on
    configs/InfillingRandom_sweep.yaml as it stands (its draws sample the
    architecture: 3 groups of one trial, each through the regular step, #2's
    chain where its auto resolves on), and ``--count 1`` on the pinned file
    with the metric ``validation_loss`` (which loads the validation evaluator
    of phase 22, so the trial's final eval runs #1 beside #2's chain in its
    training), no trial failed; the group sizes that ``--count 32`` (seed 0)
    draws of every configs/*_sweep*.yaml give. The children start first and
    run beside (a) and (b), whose seconds are therefore the card shared;
    (d), timed after they end, the card to itself: the ranking forward, the
    folded call at K 8 × B 3,300 in bf16 beside SDPA on the folded views,
    and trial·seqs/s of the vmapped step at K 1, 2, 4, 5 and 8 (10 steps of
    batch 32 a turn, launches a step) beside one trial through
    ``make_epoch_fn`` with the flagship's auto switches (#2's bf16 chain)."""
    import glob
    import random

    from torch.func import vmap

    from transformergrooveinfilling_tpu_torch import sweep
    from transformergrooveinfilling_tpu_torch.data import load_processed_dataset
    from transformergrooveinfilling_tpu_torch.train import vmap_sweep
    from transformergrooveinfilling_tpu_torch.train.config import derive_model_config
    from transformergrooveinfilling_tpu_torch.train.loop import make_eval_loss_fn

    t_phase = time.perf_counter()
    data = load_processed_dataset(os.path.join(root, "card", "datasets", "InfillingRandom",
                                               "0.0.0", "train"), "InfillingRandom")
    x = torch.as_tensor(data.processed_inputs, dtype=torch.float32, device=dev)
    y = torch.as_tensor(data.processed_outputs, dtype=torch.float32, device=dev)
    n = x.shape[0]
    hp = HyperParams.from_dict(FLAGSHIP_HP)
    config = sweep.batched_config(hp, FLAGSHIP_HP, dev)
    dtype = config.compute_dtype
    check(config.use_fused_attention and not config.fused_layer and not config.remat,
          f"the batched group's config: {config}")
    spec = yaml_subset.load_file(SWEEP_CONFIG)
    draw = random.Random(0)
    drawn = [sweep.sample_config(spec, draw) for _ in range(SWEEP_TRIALS)]
    lrs = [0.0] + [t["learning_rate"] for t in drawn[1:]]
    pens = [t["hit_loss_penalty"] for t in drawn]
    rates = [t["dropout"] for t in drawn]
    model = build_model(config, dev)
    on = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    seconds = {"setup": time.perf_counter() - t_phase}

    # (c) the command line, batched and sequential, in child processes,
    # started first: they run beside (a) and (b), and end before (d) is timed
    cwd = os.path.join(root, "sweep")
    os.makedirs(cwd, exist_ok=True)
    paths = os.path.join(root, "paths_eval.yaml")  # phase 22's: datasets and evaluators
    files = {"pinned": os.path.join(cwd, "pinned_sweep.yaml"),
             "unpinned": SWEEP_CONFIG,
             "sequential": os.path.join(cwd, "sequential_sweep.yaml")}
    sweep_file(files["pinned"], "loss", epochs=1, **SWEEP_PINNED)
    sweep_file(files["sequential"], "validation_loss", epochs=1, **SWEEP_PINNED)
    started = {mode: start_cli(CLI_SWEEP, ["--sweep", files[mode], "--count", str(count),
                                           "--batched", "--epochs", "1", "--paths", paths],
                               os.path.join(cwd, mode))
               for mode, count in SWEEP_CLI_TRIALS.items()}
    started["sequential"] = start_cli(CLI_SWEEP, ["--sweep", files["sequential"], "--count",
                                                  "1", "--paths", paths],
                                      os.path.join(cwd, "sequential"))

    # (a) the group
    init = vmap_sweep.init_stacked_params(model, config, SWEEP_TRIALS,
                                          torch.Generator().manual_seed(0), dev)
    fn = vmap_sweep.make_batched_sweep_fn(model, hp.batch_size, n, SWEEP_EPOCHS,
                                          config=config)
    MHA.launches = 0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, last = fn(init, (), on(lrs), on(pens), on(rates), x, y,
                      torch.Generator(dev).manual_seed(1))
    last = last.tolist()
    group_s = time.perf_counter() - t0  # the card shared with the children
    train_launches = {"fused_mha": MHA.launches, **{
        k: v for k, v in launches({**LAYER_KERNELS, **ffn.KERNELS, **ln.KERNELS}).items() if v}}
    check(all(np.isfinite(last)) and len(set(last)) == SWEEP_TRIALS,
          f"the group's last-batch losses: {last}")
    check(all(torch.equal(params[k][0], init[k][0]) for k in init),
          "the lr-0 trial's weights moved")
    seconds["group"] = time.perf_counter() - t0

    # (b) the ranking forward through #1's vmap rule, against eager forwards
    MHA.launches = 0
    t0 = time.perf_counter()
    stacked = vmap_sweep.stacked_eval_loss(model, params, x, y, pens, device=dev).tolist()
    eval_launches = MHA.launches
    check(eval_launches == FLAGSHIP.num_encoder_layers,
          f"a stacked eval forward of {SWEEP_TRIALS} trials launched #1 {eval_launches} times")
    eager = []
    for k in range(SWEEP_TRIALS):
        model.load_state_dict({name: v[k] for name, v in params.items()})
        eager.append(float(make_eval_loss_fn(pens[k])(model, x, y)["loss"]))
    bar = MHA_BARS[dtype][0]
    eval_err = max(abs(a - b) / abs(b) for a, b in zip(stacked, eager))
    check(eval_err <= max(bar, 1e-5), f"stacked eval losses {stacked} against eager {eager}")

    def folded(b, dt):
        """q, k, v of K trials as the slices of a vmapped packed projection
        (drawn on the card: at B 3,300 they are 650 M values)."""
        packed = torch.randn((SWEEP_TRIALS, b, 32, 3 * 256), device=dev,
                             generator=torch.Generator(dev).manual_seed(b)).to(dt)
        split = lambda p: p.view(b, 32, 3, 2, 128).permute(2, 0, 3, 1, 4)  # noqa: E731
        call = lambda: vmap(lambda p: attention.fused_mha_op(*split(p), False))(packed)  # noqa: E731
        views = packed.view(SWEEP_TRIALS * b, 32, 3, 2, 128).permute(2, 0, 3, 1, 4)
        return call, views

    folded_checks, folded_err = [], 0.0
    for b in (hp.batch_size, n):
        for dt, (atol, rtol) in MHA_BARS.items():
            call, views = folded(b, dt)
            before = MHA.launches
            got = call()
            torch.cuda.synchronize()
            check(MHA.launches == before + 1, "the folded call launched #1 more than once")
            want = mha_reference(*(v.contiguous() for v in views)).view(got.shape)
            err = max_err(got, want)
            if dt == torch.float32:
                folded_err = max(folded_err, err)
            check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
                  f"#1 folded at {(SWEEP_TRIALS * b, 2, 32, 128)} {dt}: max abs err {err}")
            folded_checks.append({"shape": [SWEEP_TRIALS * b, 2, 32, 128],
                                  "dtype": str(dt)[6:], "max_abs_err": err})
    seconds["ranking_and_folded_checks"] = time.perf_counter() - t0

    # the group sizes the repository's sweep files draw (root's order, seed 0)
    yaml_groups = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "*_sweep*.yaml"))):
        draw, drawn_spec = random.Random(0), yaml_subset.load_file(path)
        sizes = [len(g) for g in sweep.group_trials(
            [sweep.sample_config(drawn_spec, draw) for _ in range(32)]).values()]
        yaml_groups[os.path.basename(path)] = {"groups": len(sizes), "largest": max(sizes)}
    # the unpinned command line's trials (its draws, seed 0): where #2's auto is on
    draw = random.Random(0)
    chained = [derive_model_config(HyperParams.from_dict(sweep.sample_config(spec, draw)),
                                   device=dev).fused_layer
               for _ in range(SWEEP_CLI_TRIALS["unpinned"])]

    t1 = time.perf_counter()
    cli = {}
    for mode, proc in started.items():
        run = finish_cli(proc, f"sweep {mode}")
        out = run["stdout"]
        check("trial failed" not in out, f"sweep {mode}: a trial failed:\n{out[-3000:]}")
        cli[mode] = {"wall_seconds": run["wall_seconds"], "module_seconds": run["seconds"],
                     "launches": run["launches"],
                     "printed": [line for line in out.splitlines()
                                 if line.startswith(("batched sweep", "--- group", "  loss ",
                                                     "    ", "best "))]}
    ranked = {mode: sum(line.startswith("  loss ") for line in cli[mode]["printed"])
              for mode in SWEEP_CLI_TRIALS}
    regular = {mode: sum("through the regular step" in line for line in cli[mode]["printed"])
               for mode in SWEEP_CLI_TRIALS}
    pinned = SWEEP_CLI_TRIALS["pinned"]
    check(pinned >= sweep.VMAP_MIN_TRIALS and any(
        f"{pinned} trials in 1 architecture group(s)" in line for line in cli["pinned"]["printed"])
          and ranked["pinned"] == pinned and regular["pinned"] == 0,
          f"the pinned batched sweep printed {cli['pinned']['printed']}")
    check(cli["pinned"]["launches"]["fused_mha"] == FLAGSHIP.num_encoder_layers,
          f"the pinned batched sweep's ranking launched #1 "
          f"{cli['pinned']['launches']['fused_mha']} times for one group")
    check(any("3 trials in 3 architecture group(s)" in line
              for line in cli["unpinned"]["printed"])
          and ranked["unpinned"] == 3 and regular["unpinned"] == 3,
          f"the unpinned batched sweep printed {cli['unpinned']['printed']}")
    chain_launches = cli["unpinned"]["launches"]
    check(all((chain_launches[k] > 0) == any(chained) for k in fl.SM90_KERNELS)
          and chain_launches["fused_mha"] > 0,
          f"the unpinned batched sweep launched {chain_launches} (chain on: {chained})")
    check(any(line.startswith("best validation_loss = ") for line in cli["sequential"]["printed"]),
          f"the sequential sweep printed {cli['sequential']['printed']}")
    seq = cli["sequential"]["launches"]
    check(seq["fused_mha"] > 0 and all(seq[k] > 0 for k in fl.SM90_KERNELS),
          f"the sequential trial launched {seq}")
    seconds["waiting_for_the_command_lines"] = time.perf_counter() - t1

    # (d) timed with the card to itself: the ranking forward, the folded
    # call beside SDPA and the plain version, K trials a step against one
    # trial through make_epoch_fn
    t1 = time.perf_counter()
    eval_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vmap_sweep.stacked_eval_loss(model, params, x, y, pens, device=dev).tolist()
        eval_s.append(time.perf_counter() - t0)
    call, views = folded(n, torch.bfloat16)
    sdpa = lambda: F.scaled_dot_product_attention(*views)  # noqa: E731
    plain = lambda: mha_reference(*views)  # noqa: E731
    k1, p1, l1, l2, p2, k2 = (time_us(f, 50) for f in (call, plain, sdpa, sdpa, plain, call))
    folded_timing = {"shape": [SWEEP_TRIALS * n, 2, 32, 128], "dtype": "bfloat16",
                     "kernel_us": [k1, k2], "plain_us": [p1, p2], "sdpa_us": [l1, l2],
                     **mha_bound(SWEEP_TRIALS * n, 2, 32, 128, "bfloat16")}
    del call, views
    steps = SWEEP_THROUGHPUT_STEPS
    part = (x[:steps * hp.batch_size], y[:steps * hp.batch_size])
    throughput = {}
    for k in SWEEP_KS:
        step_fn = vmap_sweep.make_batched_sweep_fn(model, hp.batch_size, len(part[0]), 1,
                                                   config=config)
        args = ({name: v[:k].clone() for name, v in init.items()}, (), on(lrs[:k]),
                on(pens[:k]), on(rates[:k]), *part)
        step_fn(*args, torch.Generator(dev).manual_seed(2))  # warm-up
        MHA.launches = 0
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(*args, torch.Generator(dev).manual_seed(3))[1].tolist()
        s = time.perf_counter() - t0
        counts = {"fused_mha": MHA.launches, **launches({**LAYER_KERNELS, **ffn.KERNELS,
                                                          **ln.KERNELS})}
        throughput[f"K{k}"] = {"seconds": s, "trial_seqs_per_s": k * len(part[0]) / s,
                               "launches_per_step": {a: c / steps for a, c in counts.items() if c}}
    regular = create_train_state(derive_model_config(hp, device=dev), "sgd",
                                 hp.learning_rate, device=dev)
    epoch = make_epoch_fn(hp.hit_loss_penalty, hp.batch_size, len(part[0]))
    fetch(epoch(regular, *part, torch.Generator(dev).manual_seed(2)))  # warm-up
    reset_launches()
    t0 = time.perf_counter()
    fetch(epoch(regular, *part, torch.Generator(dev).manual_seed(3)))
    s = time.perf_counter() - t0
    chain = {k: v / steps for k, v in launches(fl.SM90_KERNELS).items()}
    check(all(v == FLAGSHIP.num_encoder_layers for v in chain.values()),
          f"make_epoch_fn launched #2's chain {chain} a step")
    throughput["make_epoch_fn_one_trial"] = {
        "seconds": s, "trial_seqs_per_s": len(part[0]) / s, "launches_per_step": chain}
    seconds["throughput"] = time.perf_counter() - t1

    out = {"card": smi, "trials": SWEEP_TRIALS, "epochs": SWEEP_EPOCHS, "items": n,
           "dtype": str(dtype)[6:], "lrs": lrs, "penalties": pens, "rates": rates,
           "group_seconds_card_shared": group_s, "yaml_group_sizes_count32": yaml_groups,
           "unpinned_trials_chain_on": chained,
           "last_batch_losses": last, "train_launches": train_launches,
           "stacked_eval_losses": stacked, "eager_eval_losses": eager,
           "eval_max_rel_err": eval_err, "eval_seconds": eval_s,
           "eval_launches_per_stacked_forward": eval_launches,
           "folded_checks": folded_checks, "folded_max_abs_err_f32": folded_err,
           "folded_timing": folded_timing, "throughput": throughput, "cli": cli,
           "seconds": {**seconds, "phase": time.perf_counter() - t_phase}}
    emit({"phase": "sweep", **out})
    return out


# phase 26: multi-GPU training (parallel/); each group's ranks are processes
# of this script on the one card (``--parallel-rank``)
PARALLEL_N = 256  # seeded loops a leg trains on
PARALLEL_GROUPS = {  # group → (ranks, the environment names it starts with, its legs)
    "a": (1, "torchrun", ("a",)), "bc": (2, "jax", ("b", "c")),
    "de": (4, "torchrun", ("d", "e"))}
DP_BAR = SM90_BAR[torch.bfloat16]  # bf16: 2e-2 · max (the chain's bar, phases 8 and 9)
TP_FWD_BAR, TP_SGD_BAR, PPTP_FWD_BAR = 1e-5, 5e-5, 2e-5
# phase 19's width, fused_ffn given (auto leaves it off); 4 of its 12 layers,
# 2 a pipeline stage (each rank initialises its model on the host)
GROOVEXL = GrooveTransformerConfig(
    d_model=1024, n_heads=8, dim_feedforward=4096, dropout=0.1, num_encoder_layers=4,
    embedding_size_src=16, compute_dtype=torch.bfloat16, use_fused_attention=True,
    fused_ffn=True)
PARALLEL_KERNELS = {"fused_mha": attention.KERNEL, **fl.SM90_KERNELS, **ffn.KERNELS}
PARALLEL_CLI_WALL_S = 2.0  # --max_wall_s of each command line of leg (f)
PARALLEL_EPOCHS = 2  # epochs of leg (a)


def rank_launches() -> dict:
    return {k: v for k, v in launches(PARALLEL_KERNELS).items() if v}


def reset_rank_launches() -> None:
    for f in PARALLEL_KERNELS.values():
        f.launches = 0


def flat_tree(tree) -> np.ndarray:
    """A flax tree's leaves, flattened and joined in key order."""
    if isinstance(tree, dict):
        return np.concatenate([flat_tree(tree[k]) for k in sorted(tree)])
    return np.asarray(tree, np.float64).reshape(-1)


def tree_err(a, b, relative: bool) -> float:
    """Largest |a - b| over two flax trees (relative: over b's largest
    value, the parameters taken as one output, as phase 8 takes each)."""
    fa, fb = flat_tree(a), flat_tree(b)
    err = float(np.abs(fa - fb).max())
    return err / float(np.abs(fb).max()) if relative else err


def gathered(model, optimizer) -> dict:
    """The whole model's flax parameters (a split model's parts gathered)."""
    return ckpt.fetch_state_to_host(TrainState(0, model, optimizer))["params"]


def heads_err(got, want) -> float:
    """Largest |got - want| over the three heads, over want's largest."""
    return max(max_err(g, w) / float(w.abs().max()) for g, w in zip(got, want))


def timed_on(dev, fn):
    """``fn()`` and its seconds, the device synchronised at both ends."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda _d: None)
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def leg_a(dev, plan_of) -> dict:
    """(a) one rank over NCCL: ``run_training(plan=make_mesh())`` bit for bit
    as ``plan=None`` (flagship, bf16, batch 32, 2 epochs, #2's chain)."""
    plan = plan_of("mesh")
    check(plan.backend == "nccl" and plan.transport == "device",
          f"one rank ran {plan.backend}/{plan.transport}")
    hp = HyperParams.from_dict(dict(FLAGSHIP_HP, epochs=PARALLEL_EPOCHS))
    data, out, states = Loops(PARALLEL_N, 26), {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_leg_a_") as tmp:
        for which, kw in (("plain", {}), ("plan", {"plan": plan})):
            reset_rank_launches()
            bundle, secs = timed_on(dev, lambda: run_training(
                hp, data, device=dev, ckpt_dir=os.path.join(tmp, which), watch_log_freq=None,
                log_media=False, **kw))
            states[which] = bundle.model.state_dict()
            out[which] = {"seconds": secs, "launches": rank_launches(),
                          "seqs_per_s_per_rank": PARALLEL_N * PARALLEL_EPOCHS / secs}
    a, b = states["plain"], states["plan"]
    check(all(torch.equal(a[k], b[k]) for k in a), "plan=make_mesh() differs from plan=None")
    check(all(out["plan"]["launches"].get(k, 0) > 0 for k in fl.SM90_KERNELS),
          f"the one-rank plan did not run #2's chain: {out['plan']['launches']}")
    return out


def leg_b(dev, plan_of) -> dict:
    """(b) dp 2, flagship, bf16, global batch 64, #2's chain on every rank:
    at rate 0 one epoch of 128 loops (two global batches) held to one
    process's chain on the same batches; at rate 0.30 four epochs of 256,
    the loss falls."""
    plan = plan_of("mesh")
    rank = torch.distributed.get_rank()
    data = Loops(PARALLEL_N, 27)
    x = torch.as_tensor(data.processed_inputs, device=dev)
    y = torch.as_tensor(data.processed_outputs, device=dev)
    penalty, lr = FLAGSHIP_HP["hit_loss_penalty"], FLAGSHIP_HP["learning_rate"]
    out = {}
    for rate, epochs, n in ((0.0, 1, 128), (0.30, 4, PARALLEL_N)):
        cfg = dataclasses.replace(FLAGSHIP, dropout=rate, compute_dtype=torch.bfloat16,
                                  fused_layer=True, use_fused_attention=True)
        state = create_train_state(cfg, "sgd", lr, 0, dev)
        epoch = make_epoch_fn(penalty, 64, n, plan=plan)
        reset_rank_launches()
        losses, secs = timed_on(dev, lambda: [
            fetch(epoch(state, x[:n], y[:n], torch.Generator(dev).manual_seed(e)))["loss"]
            for e in range(epochs)])
        row = {"seconds": secs, "losses": losses, "launches": rank_launches(),
               "seqs_per_s_per_rank": n * epochs / plan.n_data / secs}
        check(all(row["launches"].get(k, 0) > 0 for k in fl.SM90_KERNELS),
              f"rank {rank} did not run #2's chain: {row['launches']}")
        if rate == 0.0 and rank == 0:
            ref = create_train_state(cfg, "sgd", lr, 0, dev)
            start = gathered(ref.model, ref.optimizer)
            one = make_epoch_fn(penalty, 64, n)
            ref_loss = fetch(one(ref, x[:n], y[:n], torch.Generator(dev).manual_seed(0)))["loss"]
            got, want = gathered(state.model, state.optimizer), gathered(ref.model, ref.optimizer)
            row["param_err_of_max_vs_one_process"] = tree_err(got, want, True)
            # the same difference over the largest change one process made
            row["param_err_of_max_update"] = (tree_err(got, want, False) / float(
                np.abs(flat_tree(want) - flat_tree(start)).max()))
            row["loss_one_process"] = ref_loss
            check(row["param_err_of_max_vs_one_process"] <= DP_BAR
                  and abs(losses[0] - ref_loss) <= DP_BAR * abs(ref_loss),
                  f"dp 2 against one process: {row}")
        if rate > 0:
            check(np.isfinite(losses).all() and losses[-1] < losses[0],
                  f"dp 2 at rate 0.30: losses {losses}")
        out[f"rate_{rate}"] = row
    return out


def leg_c(dev, plan_of) -> dict:
    """(c) tp 2, flagship, f32: the eval forward (#1 on one head of width 128
    a rank) within 1e-5 · max of one process's; 3 SGD steps within 5e-5."""
    from transformergrooveinfilling_tpu_torch.parallel import shard_params
    from transformergrooveinfilling_tpu_torch.train.loop import make_optimizer

    plan = plan_of("mesh", n_model=2)
    cfg = dataclasses.replace(FLAGSHIP, dropout=0.0, use_fused_attention=True)
    lr, penalty = FLAGSHIP_HP["learning_rate"], FLAGSHIP_HP["hit_loss_penalty"]
    ref = build_model(cfg, dev, torch.Generator().manual_seed(3))
    model = build_model(cfg, dev, torch.Generator().manual_seed(3))
    opt = make_optimizer("sgd", lr, model.parameters())
    shard_params(model, plan, optimizer=opt)
    check(model.Encoder["Encoder"]["layers"][0].self_attn.n_heads == 1, "not one head a rank")
    data = Loops(64, 28)
    x = torch.as_tensor(data.processed_inputs, device=dev)
    y = torch.as_tensor(data.processed_outputs, device=dev)
    reset_rank_launches()
    with torch.no_grad():
        got, fwd_s = timed_on(dev, lambda: model(x))
        fwd_launches = rank_launches()
        err = heads_err(got, ref(x))
    check(fwd_launches.get("fused_mha", 0) == cfg.num_encoder_layers,
          f"tp eval forward launched {fwd_launches}")
    check(err <= TP_FWD_BAR, f"tp 2 eval forward: {err} of max")
    state = TrainState(0, model, opt)
    ref_state = TrainState(0, ref, make_optimizer("sgd", lr, ref.parameters()))
    step = make_train_step(penalty, plan=plan)
    _, steps_s = timed_on(dev, lambda: [step(state, x, y, None, torch.Generator(dev).manual_seed(i))
                                        for i in range(3)])
    ref_step = make_train_step(penalty)
    for i in range(3):
        ref_step(ref_state, x, y, None, torch.Generator(dev).manual_seed(i))
    sgd_err = tree_err(gathered(model, opt), gathered(ref, ref_state.optimizer), False)
    check(sgd_err <= TP_SGD_BAR, f"tp 2, 3 SGD steps: {sgd_err}")
    return {"eval_forward_err_of_max": err, "eval_forward_seconds": fwd_s,
            "eval_forward_launches": fwd_launches, "sgd3_max_abs_err": sgd_err,
            "steps_seconds": steps_s, "seqs_per_s_per_rank": 3 * 64 / steps_s}


def leg_d(dev, plan_of) -> dict:
    """(d) dp 2 × pp 2, GrooveXL, bf16, 4 microbatches, fused_ffn given: the
    deterministic pipelined forward (#1 in the stages) within the bf16 bar of
    the plain model, then 3 training steps (#4 in the stages)."""
    from transformergrooveinfilling_tpu_torch.parallel import pipeline_forward
    from transformergrooveinfilling_tpu_torch.parallel.pipeline import make_pipeline_step
    from transformergrooveinfilling_tpu_torch.train.loop import make_optimizer

    plan = plan_of("pipe", n_stages=2, n_micro=4)
    model = build_model(GROOVEXL, dev, torch.Generator().manual_seed(4))
    data = Loops(32, 29)
    x = torch.as_tensor(data.processed_inputs, device=dev)
    y = torch.as_tensor(data.processed_outputs, device=dev)
    reset_rank_launches()
    got, fwd_s = timed_on(dev, lambda: pipeline_forward(model, x, plan))
    fwd_launches = rank_launches()
    with torch.no_grad():
        err = heads_err(got, model(x))
    check(err <= DP_BAR, f"dp 2 x pp 2 GrooveXL forward: {err} of max")
    check(fwd_launches.get("fused_mha", 0) == GROOVEXL.num_encoder_layers // 2 * 4,
          f"a stage's eval forward launched {fwd_launches}")
    state = TrainState(0, model, make_optimizer("sgd", XL_HP["learning_rate"],
                                                model.parameters()))
    step = make_pipeline_step(plan, XL_HP["hit_loss_penalty"])
    reset_rank_launches()
    metrics, steps_s = timed_on(dev, lambda: [
        fetch(step(state, x, y, None, torch.Generator(dev).manual_seed(i))) for i in range(3)])
    train_launches = rank_launches()
    check(all(np.isfinite(m["loss"]) for m in metrics), f"GrooveXL pp losses {metrics}")
    check(all(train_launches.get(k, 0) > 0 for k in ffn.BF16_KERNELS
              if not k.endswith("reduce")), f"a stage's training launched {train_launches}")
    return {"forward_err_of_max": err, "forward_seconds": fwd_s,
            "forward_launches": fwd_launches, "losses": [m["loss"] for m in metrics],
            "steps_seconds": steps_s, "train_launches": train_launches,
            "seqs_per_s_per_rank": 3 * 32 / plan.n_data / steps_s}


def leg_e(dev, plan_of) -> dict:
    """(e) pp 2 × tp 2, flagship, f32: the pipelined forward within 2e-5 ·
    max of the plain model."""
    from transformergrooveinfilling_tpu_torch.parallel import pipeline_forward, shard_params

    plan = plan_of("pipe", n_stages=2, n_model=2, n_micro=4)
    cfg = dataclasses.replace(FLAGSHIP, use_fused_attention=True)
    ref = build_model(cfg, dev, torch.Generator().manual_seed(5))
    model = build_model(cfg, dev, torch.Generator().manual_seed(5))
    shard_params(model, plan)
    x = torch.as_tensor(Loops(32, 30).processed_inputs, device=dev)
    reset_rank_launches()
    got, secs = timed_on(dev, lambda: pipeline_forward(model, x, plan))
    fwd_launches = rank_launches()
    with torch.no_grad():
        err = heads_err(got, ref(x))
    check(err <= PPTP_FWD_BAR, f"pp 2 x tp 2 forward: {err} of max")
    check(fwd_launches.get("fused_mha", 0) == cfg.num_encoder_layers // 2 * 4,
          f"a stage's eval forward launched {fwd_launches}")
    return {"forward_err_of_max": err, "forward_seconds": secs, "forward_launches": fwd_launches,
            "seqs_per_s_per_rank": 32 / secs}


PARALLEL_LEGS = {"a": leg_a, "b": leg_b, "c": leg_c, "d": leg_d, "e": leg_e}


def parallel_rank(group: str, out: str) -> int:
    """One rank of a phase 26 group (started by :func:`phase_parallel` with
    the group in the environment): its legs, one after another; writes
    ``out_<rank>.json``."""
    from transformergrooveinfilling_tpu_torch.parallel import (
        initialize_from_env, make_mesh, make_pipeline_mesh,
    )
    from transformergrooveinfilling_tpu_torch.parallel.multihost import context

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(initialize_from_env("cuda"), "no group in the environment")
    dev = context().device
    _build.build_all(KERNEL_NAMES)  # built by the parent: loads its libraries
    legs, plans = {}, []

    def plan_of(kind, **kw):
        plan = (make_mesh(device="cuda", **kw) if kind == "mesh"
                else make_pipeline_mesh(device="cuda", **kw))
        plans.append({"kind": kind, "backend": plan.backend, "transport": plan.transport})
        return plan

    for leg in PARALLEL_GROUPS[group][2]:
        torch.distributed.barrier()
        t0 = time.perf_counter()
        legs[leg] = PARALLEL_LEGS[leg](dev, plan_of)
        legs[leg].update(plans[-1], wall_seconds=time.perf_counter() - t0)
    rank = torch.distributed.get_rank()
    with open(f"{out}_{rank}.json", "w") as f:
        json.dump({"rank": rank, "device": str(dev), "legs": legs,
                   "jax_loaded": "jax" in sys.modules}, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def group_env(n: int, rank: int, port: int, names: str) -> dict:
    """Rank ``rank`` of ``n``'s environment, under the JAX package's names or
    torchrun's."""
    if names == "jax":
        return {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": str(n),
                "JAX_PROCESS_ID": str(rank)}
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": str(n),
            "RANK": str(rank), "LOCAL_RANK": str(rank)}


def start_group(argv_of, n: int, names: str, cwd_of) -> list:
    """``n`` processes (``argv_of(rank)``, in ``cwd_of(rank)``) started
    together as one group."""
    port = free_port()
    procs = []
    for r in range(n):
        os.makedirs(cwd_of(r), exist_ok=True)
        procs.append(subprocess.Popen(
            argv_of(r), cwd=cwd_of(r), env={**os.environ, "PYTHONPATH": ROOT,
                                            **group_env(n, r, port, names)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def finish_group(procs: list, what: str, timeout: float = 300.0) -> list:
    """Wait for a group of :func:`start_group`; each rank must exit 0 →
    their (stdout, stderr)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_o, e)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{what}: rank {r} exited {p.returncode}:\n{e[-6000:]}")
    return outs


def phase_parallel(dev, smi: str, root: str) -> dict:
    """26. multi-GPU training on the one card: the groups of
    :data:`PARALLEL_GROUPS` (legs (a)-(e)), then (f) the command lines
    ``train --n_model_shards 2`` (the JAX names) and ``train --pp_stages 2``
    (torchrun's) on phase 21's datasets, and rank 0's checkpoint resumed in
    one process and served through ``InfillServer``. Ranks share the card,
    so no number here is a scaling figure."""
    t_phase = time.perf_counter()
    # #1 at the tensor-parallel eval forward's shape (one head of width 128 a
    # rank), held to its plain version; not counted in any leg
    q, k, v = (torch.randn(64, 1, 32, 128, device=dev) for _ in range(3))
    mha_err = max_err(fused_mha(q, k, v, False), mha_reference(q, k, v, False))
    check(mha_err <= 1e-5, f"fused_mha at H 1, hd 128: {mha_err}")
    out = {"card": smi, "note": "ranks share one card: no number of this phase is a "
           "scaling figure", "fused_mha_H1_max_abs_err": mha_err, "groups": {}}
    for group, (n, names, legs) in PARALLEL_GROUPS.items():
        prefix = os.path.join(root, f"group_{group}")
        t0 = time.perf_counter()
        finish_group(start_group(lambda r: [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                                            "--parallel-rank", group, prefix],
                                 n, names, lambda r: root), f"phase 26 group {group}")
        ranks = []
        for r in range(n):
            with open(f"{prefix}_{r}.json") as f:
                ranks.append(json.load(f))
        check(not any(rk["jax_loaded"] for rk in ranks), "a rank imported jax")
        out["groups"][group] = {"ranks": n, "names": names, "seconds": time.perf_counter() - t0,
                                "legs": {leg: [rk["legs"][leg] for rk in ranks]
                                         for leg in legs}}
        for leg in legs:
            emit({"phase": "parallel", "leg": leg, "card": smi, "ranks": n, "names": names,
                  "backend": ranks[0]["legs"][leg]["backend"],
                  "transport": ranks[0]["legs"][leg]["transport"],
                  "per_rank": [rk["legs"][leg] for rk in ranks],
                  "note": out["note"]})
    out["cli"] = parallel_cli(dev, smi, root)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "parallel", "card": smi, "seconds": out["seconds"], "note": out["note"],
          "fused_mha_H1_max_abs_err": mha_err})
    return out


def parallel_cli(dev, smi: str, root: str) -> dict:
    """(f) the training command line over two processes, once with
    ``--n_model_shards 2`` (the JAX names) and once with ``--pp_stages 2``
    (torchrun's), the two groups side by side, flagship YAML on phase 21's
    InfillingRandom datasets for a few blocks; the tensor-parallel run's
    newest ``.ckpt`` resumed in one process for an epoch and served."""
    paths = os.path.join(root, "paths.yaml")  # phase 21's
    out, started = {}, {}
    modes = (("tp", ["--n_model_shards", "2"], "jax"), ("pp", ["--pp_stages", "2"], "torchrun"))
    for mode, flags, names in modes:
        base = os.path.join(root, f"parallel_{mode}")
        args = ["--config", CLI_CONFIG, "--paths", paths, "--wandb", "False", "--eval_train",
                "False", "--eval_validation", "False", "--dump_eval", "False",
                "--max_wall_s", str(PARALLEL_CLI_WALL_S), "--ckpt_dir", os.path.join(base, "ck"),
                *flags]
        started[mode] = (time.perf_counter(), start_group(
            lambda r, base=base, args=args: [
                sys.executable, "-c", CLI_RUNNER,
                runner_steps([(CLI_TRAIN, args, os.path.join(base, f"rank{r}"), {})])[0]],
            2, names, lambda r, base=base: os.path.join(base, f"rank{r}")))
    for mode, flags, names in modes:
        base = os.path.join(root, f"parallel_{mode}")
        t0, procs = started[mode]
        finish_group(procs, f"train {flags}")
        rows = []
        for r in range(2):
            with open(os.path.join(base, f"rank{r}", "train.launches.json")) as f:
                counts = json.load(f)
            _d, records = run_records(os.path.join(base, f"rank{r}"))
            losses = [rec["loss"] for rec in records if "loss" in rec]
            check(len(losses) >= 1 and np.isfinite(losses).all(), f"{mode}: losses {losses}")
            rows.append({"losses": losses, "launches": {k: v for k, v in counts["launches"].items()
                                                         if v},
                         "seqs_per_s": [rec["seqs_per_sec"] for rec in records
                                        if "seqs_per_sec" in rec]})
        out[mode] = {"names": names, "wall_seconds": time.perf_counter() - t0, "ranks": rows,
                     "newest_epoch": newest_epoch(os.path.join(base, "ck"))}
        emit({"phase": "parallel", "leg": f"f_{mode}", "card": smi, **out[mode]})
    # rank 0's checkpoint (the one-device layout) resumed in one process
    ck = os.path.join(root, "parallel_tp", "ck")
    params = flagship_params()
    params["load_model"] = {"location": "local", "dir": ck}
    bundle, _opt, initial = initialize_model(params, dev)
    check(initial == out["tp"]["newest_epoch"] + 1, f"resumed at {initial}")
    hp = HyperParams.from_dict(dict(FLAGSHIP_HP, epochs=initial + 1))
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        run_training(hp, Loops(PARALLEL_N, 31), bundle=bundle, initial_epoch=initial,
                     device=dev, ckpt_dir=tmp, watch_log_freq=None, log_media=False)
    resume_launches = {k: v for k, v in launches(fl.SM90_KERNELS).items()}
    check(all(v > 0 for v in resume_launches.values()), f"resume: {resume_launches}")
    attention.KERNEL.launches = 0
    srv = serve.InfillServer(bundle.model.state_dict(), bundle.config, batch_sizes=BUCKETS,
                             device=dev)
    answer = srv.infill(Loops(4, 32).processed_inputs)
    check(answer.shape == (4, 32, 27) and np.isfinite(answer).all(), "served checkpoint")
    out["resume"] = {"from_epoch": initial, "launches": resume_launches,
                     "serve_fused_mha_launches": attention.KERNEL.launches}
    check(out["resume"]["serve_fused_mha_launches"] > 0, "the served checkpoint skipped #1")
    emit({"phase": "parallel", "leg": "f_resume", "card": smi, **out["resume"]})
    return out


# phase 27: the training kernels #2-#5 under torch.func.vmap, one launch per
# trial (ops/per_trial.py)
VMAP_K = 4  # trials of (a)
VMAP_RATE = 0.30
VMAP_GROUP_KS = (5, 8)  # K of (b)
VMAP_STEPS = 10  # steps of batch 32 a turn of (b)
VMAP_LRS = [0.089 * f for f in (0.5, 0.75, 1.0, 1.25, 1.5, 0.6, 0.9, 1.1)]
VMAP_PENS = [0.73, 0.6, 0.9, 0.65, 0.8, 0.7, 0.85, 0.75]
# (b)'s groups: their hyperparameters and the kernel counters they launch
VMAP_GROUPS = {
    "flagship_fused_layer": (dict(FLAGSHIP_HP, fused_layer=1), fl.SM90_KERNELS),
    "encdec_6_6_fused_layers": (dict(FLAGSHIP_HP, encoder_only=0, fused_layer=1,
                                     fused_decoder_layer=1),
                                {**fl.SM90_KERNELS, **fdl.SM90_KERNELS}),
    "lm_fused_ffn_ln": (dict(LM_HP, dropout=VMAP_RATE, fused_ffn=1, fused_dropout_ln=1),
                        {**ffn.BF16_KERNELS, **ln.KERNELS})}
# (c): the sweep file with the flagship's architecture, the rate and #2 pinned
VMAP_CLI_PINNED = dict(SWEEP_PINNED, epochs=1, dropout=VMAP_RATE, fused_layer=1)


def vmap_op_cases(dev, rng, dtype):
    """(a)'s four kernels in ``dtype``: name → (per-trial arguments without
    the seed, per-trial dy, the wrapper, the counters, the plain check)."""
    h_, t = LAYER_SHAPE["h"], LAYER_SHAPE["t"]

    def enc(*a):
        return fl.encoder_layer_train(*a, VMAP_RATE, h_, t)

    def dec(*a):
        return fdl.decoder_layer_train(*a, VMAP_RATE, h_, t)

    def ffn_call(*a):
        return ffn.ffn_train(*a, VMAP_RATE)

    def ln_call(*a):
        return ln.dropout_add_layernorm(*a, VMAP_RATE)

    def enc_plain(args, seed):
        own = fl.encoder_layer_reference(*args, seed, VMAP_RATE, h_, t, return_residuals=True)
        res = fl.layer_forward(*args, seed, VMAP_RATE, h_, t)
        flips = layer_flips(own[3], res[3])[0]
        return lambda *a: fl.encoder_layer_reference(*a, seed, VMAP_RATE, h_, t,
                                                      relu_flips=flips)

    def dec_plain(args, seed):
        own = fdl.decoder_layer_reference(*args, seed, VMAP_RATE, h_, t, return_residuals=True)
        res = fdl.layer_forward(*args, seed, VMAP_RATE, h_, t)
        flips = layer_flips(own[6], res[6])[0]
        return lambda *a: fdl.decoder_layer_reference(*a, seed, VMAP_RATE, h_, t,
                                                       relu_flips=flips)

    def ffn_plain(args, seed):
        own = ffn.ffn_reference(*args, seed, VMAP_RATE, return_hidden=True)[1]
        flips = fl.kink_flips(own, ffn.ffn_forward(*args, seed, VMAP_RATE)[1])[0]
        return lambda *a: ffn.ffn_reference(*a, seed, VMAP_RATE, relu_flips=flips)

    def ln_plain(args, seed):
        return lambda *a: ln.dropout_add_layernorm_reference(*a, seed, VMAP_RATE)

    cases = {}
    trials = [layer_case(dev, rng, 32, dtype) for _ in range(VMAP_K)]
    cases["fused_layer"] = ([a for a, _ in trials], [dy for _, dy in trials], enc,
                            fl.route_kernels(dtype), enc_plain)
    trials = [decoder_case(dev, rng, 32, dtype) for _ in range(VMAP_K)]
    cases["fused_decoder_layer"] = ([a for a, _ in trials], [dy for _, dy in trials], dec,
                                    fdl.route_kernels(dtype), dec_plain)
    trials = [ffn_case(dev, rng, 1024, 256, LM_HP["dim_feedforward"], dtype)
              for _ in range(VMAP_K)]
    cases["fused_ffn"] = ([a for a, *_ in trials], [dy for _, dy, *_ in trials], ffn_call,
                          ffn.BF16_KERNELS if dtype == torch.bfloat16 else ffn.F32_KERNELS,
                          ffn_plain)
    cases["fused_dropout_ln"] = ([[a[0], y, s, b] for a, _, y, s, b in trials],
                                 [dy for _, dy, *_ in trials], ln_call, ln.KERNELS, ln_plain)
    return cases


def vmap_op_check(dev, name, trials, dys, call, kernels, plain, dtype) -> dict:
    """(a) for one kernel: ``vmap(grad_and_value(...), randomness="different")``
    over K trials against K unbatched calls with each trial's seed, output and
    every gradient bit for bit, the same launches (K × a call's); each trial's
    output and gradients held to the plain version (phase 8's bars,
    ``held_to``, the plain version taking the kernel's side of a ReLU kink).
    Returns the result and a function that times the vmapped call and the K
    unbatched calls on the stream, for when nothing else runs on the card."""
    from torch.func import grad_and_value, vmap

    k = len(trials)
    # one seed a trial, each its own 16-byte aligned tensor, and their stack
    seed_list = [torch.tensor([4242 + 31 * i], dtype=torch.int32, device=dev) for i in range(k)]
    seeds = torch.stack(seed_list)
    stacked = [torch.stack(col) for col in zip(*trials)]
    dy = torch.stack(dys)
    diff = tuple(i for i, a in enumerate(trials[0]) if a.is_floating_point())

    def loss(*a):
        *ins, seed, g = a
        out = call(*ins, seed)
        return (out.float() * g.float()).sum(), out

    batched = vmap(grad_and_value(loss, argnums=diff, has_aux=True), randomness="different")

    def unbatched():
        outs = []
        for i in range(k):
            leaves = [a.clone().requires_grad_(True) if j in diff else a
                      for j, a in enumerate(trials[i])]
            value, out = loss(*leaves, seed_list[i], dys[i])
            value.backward()
            outs.append((out.detach(), [leaves[j].grad for j in diff]))
        return outs

    for f in kernels.values():
        f.launches = 0
    want = unbatched()
    torch.cuda.synchronize()
    per_call = {n: f.launches / k for n, f in kernels.items()}
    for f in kernels.values():
        f.launches = 0
    grads, (_value, out) = batched(*stacked, seeds, dy)
    torch.cuda.synchronize()
    got = {n: f.launches for n, f in kernels.items()}
    check(all(got[n] == k * per_call[n] for n in kernels) and all(per_call.values()),
          f"{name} {dtype} under vmap launched {got}, {k} x a call's {per_call}")
    bitwise = all(torch.equal(out[i], want[i][0])
                  and all(torch.equal(g[i], w) for g, w in zip(grads, want[i][1]))
                  for i in range(k))
    check(bitwise, f"{name} {dtype}: vmapped outputs or gradients differ from unbatched calls")
    errs = {}
    for i in range(k):
        ref = plain(trials[i], seed_list[i])
        leaves = [a.clone().requires_grad_(True) if j in diff else a
                  for j, a in enumerate(trials[i])]
        w_out = ref(*leaves)
        w_out.backward(dys[i])
        held_to(errs, "out", want[i][0], w_out, dtype, f"{name} trial {i}")
        for j, g in zip(diff, want[i][1]):
            e = {}
            held_to(e, f"d{j}", g, leaves[j].grad, dtype, f"{name} trial {i} input {j}")
            errs["grads"] = max(errs.get("grads", 0.0), e[f"d{j}"])
    del grads, out, want

    def timed() -> dict:
        return {"vmapped_ms": time_ms(lambda: batched(*stacked, seeds, dy), 5, warm=1),
                "unbatched_ms": time_ms(unbatched, 5, warm=1)}

    return {"dtype": str(dtype)[6:], "K": k, "bitwise": bitwise, "launches_per_call": per_call,
            "launches_vmapped": got, "max_abs_err_against_plain": errs}, timed


def vmap_group_configs(dev, name: str, hp_dict: dict):
    """(b)'s group ``name``: its hyperparameters, the config ``sweep.py``
    gives its batched group of 8 (the forced switches kept, auto remat off,
    checked) and the same config with every kernel switch off."""
    from transformergrooveinfilling_tpu_torch import sweep

    hp = HyperParams.from_dict(hp_dict)
    k_max = max(VMAP_GROUP_KS)
    config = sweep.batched_config(hp, hp_dict, dev, k_max)
    check(not config.remat, f"{name}: auto remat engages for {k_max} stacked trials")
    forced = {s: getattr(config, s) for s in transformer.KERNEL_SWITCHES}
    check(all(forced[s] == bool(hp_dict.get(s)) for s in forced) and config.dropout == VMAP_RATE,
          f"{name}: the group's config {config}")
    return hp, config, dataclasses.replace(config, **{s: False for s in forced})


def vmap_group(dev, name: str, hp_dict: dict, kernels: dict, x, y) -> dict:
    """(b) for one group: ``batched_sweep``'s step (``make_batched_sweep_fn``,
    rates uniform, so static) with the forced switches at K 5 and 8, 10
    steps of batch 32 a turn (each model warmed up by a turn at K 5 first): launches a step against K ×
    one trial's through ``make_epoch_fn`` at the same config, the loss of
    every trial at K 8 lower after its turn than at its start
    (``stacked_eval_loss``), trial·seqs/s beside the same step with every
    kernel switch off (phase 25's plain vmapped step) and one trial through
    ``make_epoch_fn`` with the switches on."""
    from transformergrooveinfilling_tpu_torch.train import vmap_sweep

    hp, config, plain_config = vmap_group_configs(dev, name, hp_dict)
    forced = {s: getattr(config, s) for s in transformer.KERNEL_SWITCHES}
    k_max = max(VMAP_GROUP_KS)
    enc = config.encoder_only
    steps = len(x) // hp.batch_size
    on = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    model, plain_model = build_model(config, dev), build_model(plain_config, dev)
    init = vmap_sweep.init_stacked_params(model, config, k_max, torch.Generator().manual_seed(5),
                                          dev)
    out = {"config": {s: v for s, v in forced.items() if v}, "dtype": str(config.compute_dtype)[6:],
           "layers": [config.num_encoder_layers, config.num_decoder_layers]}

    def turn(m, k):
        fn = vmap_sweep.make_batched_sweep_fn(m, hp.batch_size, len(x), 1, encoder_only=enc,
                                              config=m.config, rates_as_data=False)
        args = ({p: v[:k].clone() for p, v in init.items()}, (), on(VMAP_LRS[:k]),
                on(VMAP_PENS[:k]), on([VMAP_RATE] * k), x, y)
        if k == VMAP_GROUP_KS[0]:  # a model's first turn warms it up
            fn(*args, torch.Generator(dev).manual_seed(2))
        for f in kernels.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, last = fn(*args, torch.Generator(dev).manual_seed(3))
        last = last.tolist()
        s = time.perf_counter() - t0
        check(all(np.isfinite(last)), f"{name} K {k}: last-batch losses {last}")
        return params, {"seconds": s, "trial_seqs_per_s": k * len(x) / s,
                        "launches_per_step": {n: f.launches / steps
                                              for n, f in kernels.items() if f.launches}}

    regular = create_train_state(config, "sgd", VMAP_LRS[0], device=dev)
    epoch = make_epoch_fn(VMAP_PENS[0], hp.batch_size, len(x), encoder_only=enc)
    fetch(epoch(regular, x, y, torch.Generator(dev).manual_seed(2)))  # warm-up
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    fetch(epoch(regular, x, y, torch.Generator(dev).manual_seed(3)))
    s = time.perf_counter() - t0
    one = {n: f.launches / steps for n, f in kernels.items()}
    check(all(one.values()), f"{name}: one trial's step launched {one}")
    out["make_epoch_fn_one_trial"] = {"seconds": s, "trial_seqs_per_s": len(x) / s,
                                      "launches_per_step": one}
    for k in VMAP_GROUP_KS:
        params, out[f"K{k}"] = turn(model, k)
        per_step = out[f"K{k}"]["launches_per_step"]
        check(per_step == {n: k * c for n, c in one.items()},
              f"{name} K {k}: launches a step {per_step}, {k} x one trial's {one}")
        _, out[f"K{k}_switches_off"] = turn(plain_model, k)
        check(not out[f"K{k}_switches_off"]["launches_per_step"],
              f"{name} K {k} with the switches off launched the kernels")
    before = vmap_sweep.stacked_eval_loss(model, init, x, y, VMAP_PENS[:k_max], encoder_only=enc,
                                          device=dev).tolist()
    after = vmap_sweep.stacked_eval_loss(model, params, x, y, VMAP_PENS[:k_max],
                                         encoder_only=enc, device=dev).tolist()
    check(all(a < b for a, b in zip(after, before)),
          f"{name}: full-set losses {before} -> {after} after one turn at K {k_max}")
    out["eval_loss_before_after_K8"] = [before, after]
    return out


def vmap_group_at_zero(dev, name: str, hp_dict: dict, x, y) -> dict:
    """(b)'s group in f32 at rate 0, K 5, 3 steps on one batch (3 epochs of
    its first ``b`` items) from one init: the forced group
    (``make_batched_sweep_fn``) held to each trial alone through
    ``make_train_step`` with the same switches, which launches the same
    kernels (phase 8's twin bar, 1e-4). Beside it, per trial, both against
    the same group with the switches off: the kernels' own distance from the
    unfused path, which the batched step must not change. Per trial, the
    largest parameter error of each pair and the parameter it is in."""
    from transformergrooveinfilling_tpu_torch.train import vmap_sweep
    from transformergrooveinfilling_tpu_torch.train.loop import make_optimizer

    hp, config, plain_config = vmap_group_configs(dev, name, hp_dict)
    k, f32, b, enc = VMAP_GROUP_KS[0], torch.float32, hp.batch_size, config.encoder_only
    xb, yb = x[:b], y[:b]
    on = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    counted = {**fl.route_kernels(f32), **fdl.route_kernels(f32), **ffn.route_kernels(f32)}
    params, launched = {}, {}
    for which, cfg in (("forced", config), ("switches_off", plain_config)):
        cfg = dataclasses.replace(cfg, dropout=0.0, compute_dtype=f32)
        model = build_model(cfg, dev)
        init = vmap_sweep.init_stacked_params(model, cfg, k, torch.Generator().manual_seed(5), dev)
        fn = vmap_sweep.make_batched_sweep_fn(model, b, b, 3, encoder_only=enc, config=cfg,
                                              rates_as_data=False)
        for f in counted.values():
            f.launches = 0
        params[which], last = fn({p: v.clone() for p, v in init.items()}, (), on(VMAP_LRS[:k]),
                                 on(VMAP_PENS[:k]), on([0.0] * k), xb, yb,
                                 torch.Generator(dev).manual_seed(3))
        check(all(np.isfinite(last.tolist())), f"{name} f32 rate 0 {which}: losses {last}")
        launched[which] = {n: f.launches for n, f in counted.items() if f.launches}
        if which == "forced":
            alone = []
            for f in counted.values():
                f.launches = 0
            for t in range(k):
                trial = build_model(cfg, dev)
                trial.load_state_dict({p: v[t] for p, v in init.items()}, strict=False)
                state = TrainState(step=0, model=trial,
                                   optimizer=make_optimizer("sgd", VMAP_LRS[t], trial.parameters()))
                step = make_train_step(VMAP_PENS[t], encoder_only=enc)
                for _ in range(3):
                    step(state, xb, yb, None, torch.Generator(dev).manual_seed(3))
                alone.append({p: v.detach() for p, v in trial.named_parameters()})
            launched["alone"] = {n: f.launches for n, f in counted.items() if f.launches}
            params["alone"] = {p: torch.stack([a[p] for a in alone]) for p in alone[0]}

    def worst(a, c) -> list:
        return [max(((max_err(a[p][t], c[p][t]), p) for p in a), key=lambda e: e[0])
                for t in range(k)]

    out = {"K": k, "lrs": VMAP_LRS[:k], "launches": launched,
           "forced_against_alone": worst(params["forced"], params["alone"]),
           "forced_against_switches_off": worst(params["forced"], params["switches_off"]),
           "alone_against_switches_off": worst(params["alone"], params["switches_off"]),
           "bar": 1e-4}
    emit({"phase": "vmap_kernels", "part": "b at rate 0", "group": name, **out})
    check(launched["forced"] and launched["forced"] == launched["alone"]
          and not launched["switches_off"],
          f"{name} f32 rate 0: launched {launched}")
    check(max(e for e, _ in out["forced_against_alone"]) <= out["bar"],
          f"{name} f32 rate 0, 3 steps: the group against each trial alone {out}")
    return out


def phase_vmap_kernels(dev, rng, smi: str, root: str) -> dict:
    """27. The training kernels #2-#5 under ``torch.func.vmap``: (a) each of
    the four wrappers (``encoder_layer_train`` at the flagship width, d 256, 2
    heads, ff 512, T 32, B 32; ``decoder_layer_train`` at the 6 + 6 model's
    layer width; ``ffn_train`` and ``dropout_add_layernorm`` at the lm
    config's, rows 1,024, d 256, ff 2,048), bf16 and f32, rate 0.30, through
    ``vmap(grad_and_value(...), randomness="different")`` at K 4 against 4
    unbatched calls with each trial's seed, bit for bit, the launches 4 × a
    call's, and against the plain version (``vmap_op_check``); (b)
    ``make_batched_sweep_fn`` at K 5 and 8, batch 32, rate 0.30, on the first
    320 items of phase 21's train split: the flagship with ``fused_layer=1``, the 6 + 6 model with
    ``fused_layer=1, fused_decoder_layer=1`` and
    configs/InfillingRandomLow_lm_training.yaml with ``fused_ffn=1,
    fused_dropout_ln=1`` (``vmap_group``); (c) ``python -m
    transformergrooveinfilling_tpu_torch.sweep --batched --count 5 --epochs 1``
    on configs/InfillingRandom_sweep.yaml with the flagship's architecture,
    rate 0.30 and ``fused_layer: 1`` pinned, on phase 21's datasets under
    ``root`` (``paths.yaml``): one vmapped group of 5, every trial ranked,
    #2's bf16 chain launched 5 × 6 layers × the steps of an epoch. (c) runs in a child
    process beside (a)'s checks and (b)'s rate-0 checks (``vmap_group_at_zero``),
    which share the card with it; (a)'s calls and (b)'s turns are timed after
    it ends."""
    from transformergrooveinfilling_tpu_torch.data import load_processed_dataset

    t_phase = time.perf_counter()
    cwd = os.path.join(root, "vmap_kernels")
    os.makedirs(cwd, exist_ok=True)
    sweep_path = os.path.join(cwd, "pinned_fused_layer_sweep.yaml")
    sweep_file(sweep_path, "loss", **VMAP_CLI_PINNED)
    started = start_cli(CLI_SWEEP, ["--sweep", sweep_path, "--count", "5", "--batched",
                                    "--epochs", "1", "--paths",
                                    os.path.join(root, "paths.yaml")], cwd)
    seconds = {}
    ops, timers = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, case in vmap_op_cases(dev, rng, dtype).items():
            key = f"{name}_{str(dtype)[6:]}"
            ops[key], timers[key] = vmap_op_check(dev, name, *case, dtype)
    seconds["a"] = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    data = load_processed_dataset(os.path.join(root, "card", "datasets", "InfillingRandom",
                                               "0.0.0", "train"), "InfillingRandom")
    x = torch.as_tensor(data.processed_inputs[:VMAP_STEPS * 32], dtype=torch.float32, device=dev)
    y = torch.as_tensor(data.processed_outputs[:VMAP_STEPS * 32], dtype=torch.float32,
                        device=dev)
    at_zero = {name: vmap_group_at_zero(dev, name, hp_dict, x, y)
               for name, (hp_dict, _) in VMAP_GROUPS.items()}
    seconds["b_rate_0"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    run = finish_cli(started, "sweep --batched with fused_layer: 1")
    printed = [line for line in run["stdout"].splitlines()
               if line.startswith(("batched sweep", "--- group", "  loss ", "    "))]
    steps = -(-len(data) // FLAGSHIP_HP["batch_size"])
    chain = {n: run["launches"][n] for n in fl.SM90_KERNELS}
    check("trial failed" not in run["stdout"]
          and any("5 trials in 1 architecture group(s)" in line for line in printed)
          and sum(line.startswith("  loss ") for line in printed) == 5
          and not any("through the regular step" in line for line in printed),
          f"sweep --batched with fused_layer: 1 printed {printed}")
    check(all(c == 5 * FLAGSHIP.num_encoder_layers * steps for c in chain.values()),
          f"sweep --batched with fused_layer: 1 launched #2's chain {chain}, not 5 trials x "
          f"{FLAGSHIP.num_encoder_layers} layers x {steps} steps")
    cli = {"printed": printed, "launches": run["launches"], "steps": steps,
           "wall_seconds": run["wall_seconds"]}
    seconds["c_wait"] = time.perf_counter() - t0

    t0 = time.perf_counter()  # the card is (a)'s alone from here
    for key, timed in timers.items():
        ops[key].update(timed())
    del timers
    seconds["a_timed"] = time.perf_counter() - t0
    emit({"phase": "vmap_kernels", "part": "a and c", "card": smi, "ops": ops, "cli": cli})
    t0 = time.perf_counter()
    groups = {name: {**vmap_group(dev, name, hp_dict, kernels, x, y),
                     "f32_rate0_3_steps": at_zero[name]}
              for name, (hp_dict, kernels) in VMAP_GROUPS.items()}
    seconds["b"] = time.perf_counter() - t0
    out = {"card": smi, "rate": VMAP_RATE, "ops": ops, "groups": groups, "cli": cli,
           "seconds": {**seconds, "phase": time.perf_counter() - t_phase}}
    emit({"phase": "vmap_kernels", **out})
    return out


# phase 28: remat inside a batched sweep: each layer through the recompute
# that runs under torch.func (models/transformer.py::_LayerRemat)
REMAT_XL_HP = {  # scripts/bench_groovexl_ffn.py's model, as a sweep's trial
    "experiment": "InfillingRandom", "batch_size": 128, "d_model": 1024,
    "dim_feedforward": 4096, "dropout": 0.1, "optimizer_algorithm": "sgd",
    "learning_rate": 0.003, "n_heads": 8, "num_encoder_decoder_layers": 12,
    "epochs": 1, "encoder_only": 1, "hit_loss_penalty": 0.73,
}
REMAT_XL_K = 8  # trials of (a)
REMAT_KERNEL_K = 5  # trials of (b)
REMAT_STEPS = 3  # steps a group of (a) and (b) is timed or compared over
REMAT_WAYS = {"off": dict(remat=False), "remat": dict(remat=True, remat_policy=None),
              "dots": dict(remat=True, remat_policy="dots")}
# the forward launches of #2-#5, which the recompute runs again
FORWARD_LAUNCHES = (*list(fl.SM90_KERNELS)[:N_FWD[fl]], *list(fdl.SM90_KERNELS)[:N_FWD[fdl]],
                    "fused_ffn_fwd_h", "fused_ffn_fwd_out", "fused_ln_fwd")
REMAT_CLI_PINNED = dict(SWEEP_PINNED, epochs=1)


def remat_groovexl(dev, x, y) -> dict:
    """(a): a K 8 GrooveXL group (``batched_config`` of :data:`REMAT_XL_HP`,
    bf16, rate 0.1, SGD) three ways, remat off, ``remat=1`` (policy None)
    and ``"dots"``, from one init: each way's peak allocated bytes over one
    step (reset before it), trial·seqs/s over 3 steps after it, and its
    final stacked parameters and losses against remat off, bit for bit."""
    from transformergrooveinfilling_tpu_torch import sweep
    from transformergrooveinfilling_tpu_torch.train import vmap_sweep

    hp = HyperParams.from_dict(REMAT_XL_HP)
    config = sweep.batched_config(hp, REMAT_XL_HP, dev, REMAT_XL_K)
    auto = {f"K{k}": sweep.batched_config(hp, REMAT_XL_HP, dev, k).remat for k in (8, 16)}
    b, k = hp.batch_size, REMAT_XL_K
    check(config.compute_dtype == torch.bfloat16 and not config.fused_ffn
          and not config.fused_layer and config.dropout == 0.1,
          f"GrooveXL's batched config {config}")
    on = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    lrs = on([hp.learning_rate * f for f in (0.5, 0.75, 1.0, 1.25, 1.5, 0.6, 0.9, 1.1)])
    pens, rates = on(VMAP_PENS[:k]), on([hp.dropout] * k)
    bundle = types.SimpleNamespace(model=build_model(config, dev), config=config)
    # one initialisation for every trial (a GrooveXL init is 151 M draws on
    # the host); the trials differ in lr, penalty and dropout masks
    init = {name: p.detach().expand(k, *p.shape).clone()
            for name, p in bundle.model.named_parameters()}
    out, final = {"K": k, "batch": b, "auto_remat": auto}, {}
    for way, switches in REMAT_WAYS.items():
        reconfigure(bundle, **switches)
        model = bundle.model

        def sweep_fn(n_samples):
            return vmap_sweep.make_batched_sweep_fn(model, b, n_samples, 1, config=bundle.config,
                                                    rates_as_data=False)

        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        params, _ = sweep_fn(b)(init, (), lrs, pens, rates, x[:b], y[:b],
                                torch.Generator(dev).manual_seed(2))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        del params
        n = b * REMAT_STEPS
        t0 = time.perf_counter()
        params, last = sweep_fn(n)(init, (), lrs, pens, rates, x[:n], y[:n],
                                   torch.Generator(dev).manual_seed(3))
        last = last.tolist()
        s = time.perf_counter() - t0
        check(all(np.isfinite(last)) and len(set(last)) == k, f"GrooveXL {way}: losses {last}")
        # remat off's result waits on the host, so every way starts from the
        # same resident bytes
        host = {p: v.cpu() for p, v in params.items()}
        del params
        if way == "off":
            final = {"params": host, "last": last}
            bitwise = None
        else:
            bitwise = last == final["last"] and all(
                torch.equal(host[p], final["params"][p]) for p in host)
            check(bitwise, f"GrooveXL K {k} {way}: parameters or losses differ from remat off")
        del host
        out[way] = {"peak_bytes": peak, "resident_bytes": resident,
                    "step_bytes": peak - resident, "seconds": s,
                    "trial_seqs_per_s": k * n / s, "last_batch_losses": last,
                    "bitwise_against_off": bitwise}
    del final, init, bundle
    torch.cuda.empty_cache()
    check(out["remat"]["peak_bytes"] < out["off"]["peak_bytes"]
          and out["dots"]["peak_bytes"] < out["off"]["peak_bytes"],
          f"GrooveXL K {k}: peak bytes {[out[w]['peak_bytes'] for w in REMAT_WAYS]}")
    return out


def remat_kernel_group(dev, name: str, hp_dict: dict, kernels: dict, x, y) -> dict:
    """(b) for one of phase 27's groups: K 5 with its switches forced, 3
    steps of batch 32 with remat off and with ``remat=1`` from one init: the
    stacked parameters and losses bit for bit, and under remat each forward
    launch twice a layer and trial (the recompute), each backward launch
    once, counted by the wrappers."""
    from transformergrooveinfilling_tpu_torch.train import vmap_sweep

    hp, config, _plain = vmap_group_configs(dev, name, hp_dict)
    k, b = REMAT_KERNEL_K, hp.batch_size
    n = b * REMAT_STEPS
    on = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    bundle = types.SimpleNamespace(model=build_model(config, dev), config=config)
    init = vmap_sweep.init_stacked_params(bundle.model, config, k,
                                          torch.Generator().manual_seed(5), dev)
    runs = {}
    for way in ("off", "remat"):
        reconfigure(bundle, remat=way == "remat")
        fn = vmap_sweep.make_batched_sweep_fn(bundle.model, b, n, 1,
                                              encoder_only=config.encoder_only,
                                              config=bundle.config, rates_as_data=False)
        for f in kernels.values():
            f.launches = 0
        params, last = fn(init, (), on(VMAP_LRS[:k]), on(VMAP_PENS[:k]), on([VMAP_RATE] * k),
                          x[:n], y[:n], torch.Generator(dev).manual_seed(3))
        last = last.tolist()
        check(all(np.isfinite(last)), f"{name} {way}: losses {last}")
        runs[way] = (params, last, launches(kernels))
    (p_off, l_off, n_off), (p_on, l_on, n_on) = runs["off"], runs["remat"]
    bitwise = l_off == l_on and all(torch.equal(p_off[p], p_on[p]) for p in p_off)
    check(bitwise, f"{name} K {k}: remat's parameters or losses differ from remat off")
    want = {kn: c * (2 if kn in FORWARD_LAUNCHES else 1) for kn, c in n_off.items()}
    check(all(n_off.values()) and n_on == want,
          f"{name} K {k}: launches under remat {n_on}, without {n_off}")
    return {"K": k, "steps": REMAT_STEPS, "bitwise": bitwise, "last_batch_losses": l_on,
            "off": {"launches_per_step": {kn: c / REMAT_STEPS for kn, c in n_off.items()}},
            "remat": {"launches_per_step": {kn: c / REMAT_STEPS for kn, c in n_on.items()}}}


def phase_vmap_remat(dev, smi: str, root: str) -> dict:
    """28. Remat inside a batched sweep, each layer recomputed in the
    backward under ``torch.func`` (``models/transformer.py::_LayerRemat``):
    (c) first, in child processes beside (b), ``python -m
    transformergrooveinfilling_tpu_torch.sweep --batched --count 5 --epochs
    1`` at the flagship's architecture on phase 21's datasets, once with
    ``remat: 1`` pinned and once with remat unset and ``TGI_HBM_BYTES`` set
    so that the auto-remat estimate engages for 5 stacked trials and not for
    one: each one vmapped group of 5 under remat, every trial ranked, #1
    launched 6 times (the one ranking forward); (b) phase 27's three groups
    (#2 flagship, #2 + #3 6 + 6, #4 + #5 lm config) at K 5, rate 0.30, 3
    steps with and without ``remat=1`` (``remat_kernel_group``); (a), the
    card to itself once the children end, GrooveXL at K 8 without remat,
    with ``remat=1`` and with ``"dots"`` (``remat_groovexl``)."""
    from transformergrooveinfilling_tpu_torch import sweep
    from transformergrooveinfilling_tpu_torch.data import load_processed_dataset
    from transformergrooveinfilling_tpu_torch.train.config import resolve_remat

    t_phase = time.perf_counter()
    seconds = {}
    cwd = os.path.join(root, "vmap_remat")
    os.makedirs(cwd, exist_ok=True)
    hp = HyperParams.from_dict(FLAGSHIP_HP)
    dtype = sweep.batched_config(hp, FLAGSHIP_HP, dev).compute_dtype

    def needs(n: int, hbm: int) -> bool:
        return resolve_remat(None, d_model=hp.d_model, n_heads=hp.n_heads,
                             dim_feedforward=hp.dim_feedforward,
                             n_layers=hp.num_encoder_decoder_layers, optimizer="sgd",
                             batch_size=hp.batch_size, n_replicas=n, compute_dtype=dtype,
                             hbm_bytes=hbm)

    lo, hi = 1, 1 << 40  # the least memory that holds one trial without remat
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid + 1, hi) if needs(1, mid) else (lo, mid)
    hbm = 3 * lo
    check(needs(5, hbm) and not needs(1, hbm), f"TGI_HBM_BYTES={hbm} for 5 trials and 1")
    paths = os.path.join(root, "paths.yaml")
    started = {}
    for mode, pinned, env in (("given", dict(REMAT_CLI_PINNED, remat=1), {}),
                              ("auto", REMAT_CLI_PINNED, {"TGI_HBM_BYTES": str(hbm)})):
        path = os.path.join(cwd, f"{mode}_sweep.yaml")
        sweep_file(path, "loss", **pinned)
        started[mode] = start_cli(CLI_SWEEP, ["--sweep", path, "--count", "5", "--batched",
                                              "--epochs", "1", "--paths", paths],
                                  os.path.join(cwd, mode), **env)

    data = load_processed_dataset(os.path.join(root, "card", "datasets", "InfillingRandom",
                                               "0.0.0", "train"), "InfillingRandom")
    x = torch.as_tensor(data.processed_inputs[:REMAT_XL_HP["batch_size"] * REMAT_STEPS],
                        dtype=torch.float32, device=dev)
    y = torch.as_tensor(data.processed_outputs[:REMAT_XL_HP["batch_size"] * REMAT_STEPS],
                        dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    groups = {name: remat_kernel_group(dev, name, hp_dict, kernels, x, y)
              for name, (hp_dict, kernels) in VMAP_GROUPS.items()}
    seconds["b"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cli = {}
    for mode, proc in started.items():
        run = finish_cli(proc, f"sweep --batched, remat {mode}")
        printed = [line for line in run["stdout"].splitlines()
                   if line.startswith(("batched sweep", "--- group", "  loss ", "    "))]
        said = ("(policy None; given)" if mode == "given"
                else "(policy None; auto, 5 stacked trials)")
        check("trial failed" not in run["stdout"]
              and any("5 trials in 1 architecture group(s)" in line for line in printed)
              and any(f"one vmapped program under remat {said}" in line for line in printed)
              and sum(line.startswith("  loss ") for line in printed) == 5
              and not any("through the regular step" in line for line in printed),
              f"sweep --batched, remat {mode}, printed {printed}")
        check(run["launches"]["fused_mha"] == FLAGSHIP.num_encoder_layers,
              f"sweep --batched, remat {mode}: #1 launched {run['launches']['fused_mha']} "
              "times, not once a layer for the group's one ranking forward")
        cli[mode] = {"printed": printed, "launches": run["launches"],
                     "wall_seconds": run["wall_seconds"], "module_seconds": run["seconds"]}
    cli["auto"]["TGI_HBM_BYTES"] = hbm
    seconds["c_wait"] = time.perf_counter() - t0

    t0 = time.perf_counter()  # the card is (a)'s alone from here
    xl = remat_groovexl(dev, x, y)
    seconds["a"] = time.perf_counter() - t0
    out = {"card": smi, "groovexl": xl, "groups": groups, "cli": cli,
           "seconds": {**seconds, "phase": time.perf_counter() - t_phase}}
    emit({"phase": "vmap_remat", **out})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    took = {}

    def timed_phase(fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        torch.cuda.synchronize()
        took[fn.__name__.removeprefix("phase_")] = time.perf_counter() - t0
        print(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        return result

    name, smi = timed_phase(phase_device)
    timed_phase(phase_build)
    kernel = timed_phase(phase_kernel, dev, rng)
    torch.manual_seed(0)  # seeded random flagship weights
    sd = build_model(FLAGSHIP, "cpu").state_dict()
    srv, plain, raw, launches_mha = timed_phase(phase_serve, dev, rng, sd)
    timed_phase(phase_http, dev, rng, sd, srv, raw)
    timed_phase(phase_demo, rng)
    timed_phase(phase_latency, dev, srv, plain)
    layer = timed_phase(phase_layer, dev, rng)
    train = timed_phase(phase_train, dev, rng)
    front = timed_phase(phase_front_end_kernels, dev, rng)
    timed_phase(phase_front_end, dev, rng)
    hvo = timed_phase(phase_serve_hvo, dev, rng, sd, srv)
    augmented = timed_phase(phase_train_augment, dev, rng)
    dec_layer = timed_phase(phase_decoder_layer, dev, rng)
    encdec = timed_phase(phase_train_encdec, dev, rng)
    served_encdec = timed_phase(phase_serve_encdec, dev, rng, srv)
    ffn_ln = timed_phase(phase_ffn_ln, dev, rng)
    wide = timed_phase(phase_train_wide, dev, rng)
    xl = timed_phase(phase_train_groovexl, dev, rng)
    saved = timed_phase(phase_checkpoint, dev, rng, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as cli_root:
        cli = timed_phase(phase_cli, dev, smi, cli_root)
        evaluation = timed_phase(phase_eval, dev, smi, cli_root)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_midi_") as midi_root:
            midi = timed_phase(phase_midi_sf2, dev, smi, midi_root, srv, sd)
        artifact = timed_phase(phase_artifact, dev, smi, cli_root, srv, sd, evaluation)
        swept = timed_phase(phase_sweep, dev, smi, cli_root)
        par = timed_phase(phase_parallel, dev, smi, cli_root)
        vk = timed_phase(phase_vmap_kernels, dev, rng, smi, cli_root)
        vr = timed_phase(phase_vmap_remat, dev, smi, cli_root)
    emit({"phase_seconds": took})

    def per_rank(group: str, leg: str, *keys) -> list:
        rows = par["groups"][group]["legs"][leg]
        for key in keys:
            rows = [row[key] for row in rows]
        return rows

    def mha_row(b, dtype, form="contiguous", h=2, hd=128):
        return next(t for t in kernel["timings"]
                    if t["shape"] == [b, h, 32, hd] and t["dtype"] == dtype and t["form"] == form)

    def mha_at(row):
        return {"kernel_form": row["route"], "ms": float(np.mean(row["kernel_us"])) / 1000.0,
                "device_ms": row["kernel_device_us"] / 1000.0,  # long rows: a graph's
                "device_time_from": row["device_time_from"],
                "plain_ms": float(np.mean(row["plain_us"])) / 1000.0,
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": float(np.mean(row["sdpa_us"])) / 1000.0,
                "library_device_ms": (row["sdpa_device_us"] / 1000.0
                                      if row["sdpa_device_us"] is not None else None)}

    b1 = mha_row(1, "float32")
    kernels = [{
        "name": "fused_mha", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches_mha,
        "launches_hvo_input_path": hvo["launches"]["fused_mha"],
        "launches_checkpoint_serving_path": saved["serving_launches"]["fused_mha"],
        "launches_encdec_serving_path": served_encdec["launches"],
        "launches_eval_training_path": evaluation["train"]["launches"]["fused_mha"],
        "launches_evaluate_path": evaluation["rescore"]["launches"],
        "launches_scalar_eval_pass": evaluation["scalar_eval_pass"][0]["launches"],
        "launches_media_pass": evaluation["media_pass"][0]["launches"],
        "launches_kit_serving_path": midi["serve"]["launches"]["fused_mha"],
        "launches_artifact_path": {name: m["launches"]
                                   for name, m in artifact["models"].items()},
        "launches_from_exported_hvo_input": artifact["from_exported_hvo_input"]["launches"][
            "fused_mha"],
        "launches_stacked_eval_forward": swept["eval_launches_per_stacked_forward"],
        "launches_sweep_cli": {mode: run["launches"]["fused_mha"]
                               for mode, run in swept["cli"].items()},
        "launches_tp_eval_forward_per_rank": [
            c["fused_mha"] for c in per_rank("bc", "c", "eval_forward_launches")],
        "launches_pp_stage_eval_forward_per_rank": {
            "groovexl_dp2_pp2": [c["fused_mha"] for c in per_rank("de", "d", "forward_launches")],
            "flagship_pp2_tp2": [c["fused_mha"] for c in per_rank("de", "e", "forward_launches")]},
        "launches_served_parallel_checkpoint": par["cli"]["resume"]["serve_fused_mha_launches"],
        f"vmap_folded_K{SWEEP_TRIALS}xB{swept['items']}_bfloat16": {
            "ms": float(np.mean(swept["folded_timing"]["kernel_us"])) / 1000.0,
            "plain_ms": float(np.mean(swept["folded_timing"]["plain_us"])) / 1000.0,
            "bound_ms": swept["folded_timing"]["bound_ms"],
            "bound_by": swept["folded_timing"]["bound_by"],
            "library_ms": float(np.mean(swept["folded_timing"]["sdpa_us"])) / 1000.0},
        "max_abs_err": kernel["max_abs_err"], **mha_at(b1),
        **{f"B{b}_{dtype}_{form}": mha_at(mha_row(b, dtype, form))
           for b, dtype in ((1, "float32"), (512, "float32"), (512, "bfloat16"), (1, "bfloat16"))
           for form in MHA_FORMS if (b, dtype, form) != (1, "float32", "contiguous")},
        "eval_forward_B3300_bfloat16_packed_qkv": mha_at(
            mha_row(EVAL_ROWS["train"], "bfloat16", "packed_qkv")),
        **{f"hd{hd}_B{b}_{dtype}_packed_qkv": mha_at(mha_row(b, dtype, "packed_qkv", 1, hd))
           for hd in MHA_TIMED_HDS for dtype in ("float32", "bfloat16") for b in (1, 512)},
        "launches_wide_head_held_out_forward": {
            f"{which}_{dname}": run["fused_mha_launches"]
            for which, out in (("encoder", train), ("encoder_decoder", encdec))
            for dname, run in out["wide"]["path"].items()},
        "launches_hd1024_served": {n: r["fused_mha_launches"]
                                   for n, r in train["wide"]["served"].items()},
        "launches_hd512_sweep_draw": {
            "ranking_forward": train["wide"]["sweep_draw"]["fused_mha_launches_ranking_forward"],
            "eval_forward": train["wide"]["sweep_draw"]["fused_mha_launches_eval_forward"][0]},
        "long_max_abs_err": kernel["long_max_abs_err"],
        **{f"T{row['shape'][2]}_B{row['shape'][0]}_{row['dtype']}_packed_qkv": mha_at(row)
           for row in kernel["long_timings"]},
        f"scores_form_T{LONG_T}": {
            f"hd{row['shape'][3]}_B{row['shape'][0]}_{row['dtype']}_packed_qkv": mha_at(row)
            for row in kernel["scores_timings"]},
        f"launches_T{LONG_T}_held_out_forward": {
            f"{which}_{dname}": run["fused_mha_launches"]
            for which, out in (("encoder", train), ("encoder_decoder", encdec))
            for dname, run in out["long"]["path"].items()},
        f"launches_T{LONG_T}_served": {
            f"{which}_{request}": r["launches"]["fused_mha"]
            for which, out in (("encoder", train), ("encoder_decoder", encdec))
            for request, r in out["long"]["served"].items()},
        "at": "B 1, H 2, T 32, hd 128, float32, contiguous; ms: stream time; device_ms: the "
              "profiler's per launch; err over all f32 checks; library: "
              "scaled_dot_product_attention on the same views; vmap_folded: one call of "
              "tgi::fused_mha under torch.func.vmap over 8 trials (phase 25's ranking "
              "forward), stream time, SDPA on the folded views; hd512 / hd1024: one head of "
              "512 / 1,024 (d 512 / 1,024 models with one head); "
              "launches_wide_head_held_out_forward: the held-out forward of phases 9 and 15's "
              "d 1,024 / 1 head runs (6 layers; 2 + 2); launches_hd1024_served: phase 9's "
              "trained d 1,024 / 1 head weights served, a B 1 and a bucket-32 request; "
              "launches_hd512_sweep_draw: the d 512 / 1 head sweep draw's ranking forward "
              "of 4 stacked trials and an eval forward (phase 9); T128 / T256 / T1024: "
              "8-, 16- and 64-bar loops, H 2, hd 128, packed qkv, the long route's flash "
              "form (TMA and wgmma; kernel_form: attention.route), device_ms and "
              "library_device_ms each from a CUDA graph of their calls "
              "(T128_B3300: the eval forward of 8-bar loops); scores_form_T128: one head "
              "of 256, 512 and 1,024 at 8 bars, the long route's scores form, timed "
              "likewise; long_max_abs_err over "
              "the long route's checks (phase 3); launches_T128_*: the held-out forward "
              "of phases 9 and 15's max_len 128 runs and their f32 weights served, B 1 "
              "and a bucket of 32, MSO input and hvo_input"}]

    def timing(phase_out, b, dtype):
        return next(t for t in phase_out["timings"] if t["B"] == b and t["dtype"] == dtype)

    def vmap_route(switch, dname, kname):
        """Phase 27's numbers of one kernel: its operators' vmap rule."""
        op = vk["ops"][f"{switch}_{dname}"]
        out = {"route": "the tgi:: operators' vmap rule, one launch a trial",
               "K4_bitwise_against_unbatched": op["bitwise"],
               "K4_launches_vmapped_grad_call": op["launches_vmapped"][kname],
               "K4_vmapped_grad_call_ms": op["vmapped_ms"],
               "K4_unbatched_grad_calls_ms": op["unbatched_ms"],
               "K4_max_abs_err_against_plain": op["max_abs_err_against_plain"]}
        if dname == "bfloat16":
            out["launches_per_batched_sweep_step"] = {
                f"{g}_K{k}": vk["groups"][g][f"K{k}"]["launches_per_step"][kname]
                for g, (_, counters) in VMAP_GROUPS.items() if kname in counters
                for k in VMAP_GROUP_KS}
            out["launches_per_batched_remat_step"] = {
                f"{g}_K{REMAT_KERNEL_K}": vr["groups"][g]["remat"]["launches_per_step"][kname]
                for g, (_, counters) in VMAP_GROUPS.items() if kname in counters}
        if kname in vk["cli"]["launches"] and switch == "fused_layer" and dname == "bfloat16":
            out["launches_sweep_cli_fused_layer"] = vk["cli"]["launches"][kname]
        return out

    # per layer: the phase, its module, the TPU kernel bodies, the training
    # phase (its main path's bf16 launches and 3 f32 steps), the forward's
    # launch count, and the bf16 launches of further paths
    layers = (("encoder", layer, fl, LAYER_TPU_KERNELS, train,
               {"launches_audio_augment_path": augmented["launches"],
                "launches_encdec_training_path": encdec["launches"],
                "launches_checkpoint_path": saved["launches"],
                **{f"launches_cli_train_{mode}": run["launches"]
                   for mode, run in cli["train"].items()},
                "launches_eval_training_path": evaluation["train"]["launches"],
                "launches_kit_training_path": midi["train"]["launches"],
                "launches_sweep_sequential_path": swept["cli"]["sequential"]["launches"],
                "launches_sweep_regular_step_path": swept["cli"]["unpinned"]["launches"],
                "launches_dp2_per_rank_path": {
                    k: [c[k] for c in per_rank("bc", "b", "rate_0.3", "launches")]
                    for k in fl.SM90_KERNELS},
                "launches_one_rank_plan_path": per_rank("a", "a", "plan", "launches")[0],
                "launches_resumed_parallel_checkpoint": par["cli"]["resume"]["launches"]}),
              ("decoder", dec_layer, fdl, DEC_TPU_KERNELS, encdec, {}))
    def wide_at(out, path, dname, kname):
        """A launch of the wide route: its launches on the d 1,024 / 1 head
        main path, its worst error over every shape of ``WIDE_SHAPES``, at
        ``WIDE_TIMED`` (d 1,024, one head, ff 1,024, B 32) its device time,
        bound, plain and library times, and at ``WIDE_STREAMED`` (d 2,048,
        two heads) the device time of a launch of ``STREAMED_KINDS``."""
        rows = {r["shape"]["d"]: r["launches"][kname] for r in out["wide"]["timings"]
                if r["dtype"] == dname}
        streamed = next(r for r in out["wide"]["timings"]
                        if r["dtype"] == dname and r["shape"] is WIDE_STREAMED)
        errs = [r["launches"][kname]["max_abs_err"]
                for r in out["wide"]["timings"] + out["wide"]["checked"] if r["dtype"] == dname]
        at, wider = rows[WIDE_TIMED["d"]], rows[WIDE_STREAMED["d"]]
        return {"launches": path["wide"]["path"][dname]["launches"][kname],
                "max_abs_err": max(errs), "ms": at["device_ms"],
                "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
                "bound_by": at["bound_by"], "library_ms": at["library_ms"],
                **({"d2048_h2": {"ms": wider["device_ms"], "bound_ms": wider["bound_ms"],
                                 "bound_by": wider["bound_by"], "plain_ms": wider["plain_ms"],
                                 "library_ms": wider["library_ms"]}}
                   if "device_ms" in wider else {}),
                "d2048_h2_layer": {
                    "fwd_ms": streamed["kernel_fwd_ms"], "bwd_ms": streamed["kernel_bwd_ms"],
                    "library_fwd_ms": float(np.mean(streamed["library"]["fwd_ms"])),
                    "library_bwd_ms": float(np.mean(streamed["library"]["bwd_ms"]))}}

    def long_at(out, path, dname, kname):
        """A launch in 8- and 16-bar loops (``LONG_SHAPES``, B 32): its
        launches on phase 9 / 15's max_len 128 path, and at each T its device
        time, plain and library times, bound and error, and the whole layer's
        device times beside its bound and nn.Transformer*Layer's."""
        res = {f"launches_T{LONG_T}_path": path["long"]["path"][dname]["launches"][kname]}
        for r in out["long"]["timings"]:
            if r["dtype"] != dname:
                continue
            at = r["launches"][kname]
            res[f"T{r['shape']['t']}"] = {
                key: at.get(key) for key in ("max_abs_err", "bound_ms", "bound_by",
                                             "plain_ms", "library_ms")}
            res[f"T{r['shape']['t']}"]["ms"] = at.get("device_ms")
            if "kernel_fwd_ms" not in r:
                continue
            res[f"T{r['shape']['t']}_layer"] = {
                "fwd_device_ms": r.get("kernel_fwd_device_ms"),
                "bwd_device_ms": r.get("kernel_bwd_device_ms"),
                "fwd_ms": r["kernel_fwd_ms"], "bwd_ms": r["kernel_bwd_ms"],
                "io_bounds_ms": {k: v["bound_ms"] for k, v in r["io_bounds"].items()},
                "library_fwd_device_ms": r["library"]["fwd_device_ms"],
                "library_bwd_device_ms": r["library"]["bwd_device_ms"],
                "library_fwd_ms": float(np.mean(r["library"]["fwd_ms"])),
                "library_bwd_ms": float(np.mean(r["library"]["bwd_ms"]))}
        return res

    for which, out, mod, tpu, path, more in layers:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            at32, at512 = timing(out, 32, dname), timing(out, 512, dname)
            f32 = dtype == torch.float32
            main_path = path["f32_launches"] if f32 else path["launches"]
            narrow_route = mod.route_kernels(dtype)
            wide_route = mod.route_kernels(dtype, WIDE_TIMED["d"])
            for i, kname in enumerate(wide_route):
                if kname in narrow_route:
                    continue
                kernels.append({
                    "name": kname, "route": "cuda", "source": LAYER_WIDE_SOURCE,
                    "replaces": tpu["fwd" if i < N_WIDE_FWD[mod] else "bwd"],
                    **wide_at(out, path, dname, kname),
                    "at": f"the {which} layer's {dname} chain in its wide route (d past 256): "
                          "B 32, T 32, d 1,024, one head, ff 1,024, rate 0.30 (d2048_h2: d "
                          "2,048, 2 heads, the row passes a block a row); "
                          "ms: device time per launch (profiler); plain_ms: its plain version "
                          "on the stream; bound: this launch's own bytes and operations"
                          + (" (f32 products at 495/3 TFLOP/s)" if f32 else "")
                          + "; library: addmm for the f32 gradient sum, F.layer_norm for the f32 "
                          "forward row pass (ln_y), else none; err: the largest over every "
                          "output at d 512 / 4 heads, 1,024 / 1, 2,048 / 2, 512 / 1 and 1,280 "
                          f"/ 5 (B 32), each held to {SM90_BAR[dtype]} of its largest value; "
                          "launches: the d 1,024 / 1 head main path of phase "
                          f"{9 if which == 'encoder' else 15} ("
                          + ("2 f32 steps" if f32 else "4 bf16 steps")
                          + (", 6 layers)" if which == "encoder" else ", 2 + 2 layers)")})
            for i, kname in enumerate(narrow_route):
                l32, l512 = at32["launches"][kname], at512["launches"][kname]
                kernels.append({
                    "name": kname, "route": "cuda",
                    "source": (LAYER_ATTN_SOURCE if narrow_route[kname].entry
                               in layer_sm90.ATTN_ENTRIES else LAYER_SM90_SOURCE),
                    "replaces": tpu["fwd" if i < N_FWD[mod] else "bwd"],
                    "launches": main_path[kname],
                    **({} if f32 else {key: counts[kname] for key, counts in more.items()}),
                    "vmap": vmap_route("fused_layer" if which == "encoder"
                                       else "fused_decoder_layer", dname, kname),
                    "max_abs_err": max(l32["max_abs_err"], l512["max_abs_err"]),
                    **({"wide_route": wide_at(out, path, dname, kname)}
                       if kname in wide_route else {}),
                    "long_t": long_at(out, path, dname, kname),
                    "ms": l32["device_ms"], "plain_ms": l32["plain_ms"],
                    "bound_ms": l32["bound_ms"], "bound_by": l32["bound_by"],
                    **({"bound_ms_at_67_tflops": l32["at_67"]} if f32 else {}),
                    "library_ms": l32["library_ms"],
                    "B512": {"ms": l512["device_ms"], "bound_ms": l512["bound_ms"],
                             "bound_by": l512["bound_by"]},
                    **{f"layer_B{b}": {
                        "fwd_device_ms": row["kernel_fwd_device_ms"],
                        "bwd_device_ms": row["kernel_bwd_device_ms"],
                        "io_bounds_ms": {k: v["bound_ms"] for k, v in row["io_bounds"].items()},
                        "library_fwd_device_ms": row["library"]["fwd_device_ms"],
                        "library_bwd_device_ms": row["library"]["bwd_device_ms"]}
                       for b, row in ((32, at32), (512, at512))},
                    "at": f"the {which} layer's {dname} chain: B 32 (B512: batch 512), T 32, "
                          "d 256, 2 heads, ff 512, rate 0.30; ms: device time per launch "
                          "(profiler); plain_ms: its plain version on the stream; bound: this "
                          "launch's own bytes and operations"
                          + (" (f32 products at 495/3 TFLOP/s, three TF32 products each; "
                             "bound_ms_at_67_tflops: at the CUDA cores' f32 rate)" if f32 else "")
                          + "; library: F.linear (bias products) or one matmul (products "
                          "without residual), else none; err: the largest over every output "
                          f"at B 32 and 512, each held to {SM90_BAR[dtype]} of its largest "
                          "value; layer_B32/B512: the whole layer, the bound from its own "
                          "inputs, weights and outputs, the library call "
                          f"nn.Transformer{which.title()}Layer in {dname}"
                          + (" (TF32 off); launches: the 3 f32 training steps (each forward "
                             "launch twice a layer call there)" if f32 else "")
                          + "; long_t: B 32 in 8- and 16-bar loops (T 128, 256: the "
                          "attention launches' long route), each launch's device time, plain "
                          "and library times, bound and error, and the whole layer's; "
                          f"launches_T{LONG_T}_path: phase {9 if which == 'encoder' else 15}'s "
                          f"max_len {LONG_T} run, the chain given ("
                          + ("2 f32 steps" if f32 else "4 bf16 steps") + ", 6 layers)"})
    def registers_form(kind):
        """The chains' attention launches of ``kind`` in the registers form
        (bf16 past T 32): their launches on phases 9 and 15's max_len 128
        paths, and per counted launch and T (8 and 16 bars, phases 8 and 14)
        device time, plain and library times, bound and error."""
        per, errs = {}, []
        for out in (layer, dec_layer):
            for r in out["long"]["timings"]:
                if r["dtype"] != "bfloat16":
                    continue
                for kname, at in r["launches"].items():
                    if kname.endswith(kind):
                        errs.append(at["max_abs_err"])
                        per[f"{kname}_T{r['shape']['t']}"] = {
                            "ms": at.get("device_ms"),
                            **{key: at.get(key) for key in ("plain_ms", "bound_ms", "bound_by",
                                                            "library_ms")}}
        main = per[f"fused_layer_sm90_{kind}_T{LONG_T}"]
        counts = [out["long"]["path"]["bfloat16"]["attention_forms"][kind].get("registers", 0)
                  for out in (train, encdec)]
        check(all(c > 0 for c in counts), f"the registers form's {kind} launched {counts}")
        return {"name": f"chain_attention_registers_{kind.split('_')[1]}", "route": "cuda",
                "source": LAYER_REGS_SOURCE, "replaces": REGS_TPU_KERNELS[kind.split("_")[1]],
                "launches": sum(counts), "launches_by_path": dict(zip(("phase9", "phase15"),
                                                                      counts)),
                "max_abs_err": max(errs), **main, "by_launch": per,
                "at": "the chains' attention past T 32 in bf16 (heads up to 128, views TMA "
                      "reads), launched from " + LAYER_ATTN_SOURCE + "'s entry points; ms, "
                      "plain_ms, bound, library: the encoder's launch at B 32, T 128, d 256, 2 "
                      "heads, rate 0.30 (by_launch: every counted launch, encoder, decoder self "
                      "and cross, at T 128 and 256); ms and library_ms: device time from a CUDA "
                      "graph of its calls; library: F.scaled_dot_product_attention with "
                      "dropout_p 0.30 on the same views (forward; forward and backward for "
                      "attn_bwd); err: the largest over every output held to 2e-2 of its "
                      "largest value; launches: phases 9 and 15's max_len 128 bf16 runs "
                      "(4 steps, 6 layers; the 6 + 6 model)"}

    kernels += [registers_form("attn_fwd"), registers_form("attn_bwd")]

    def midi_launches(kernel):
        return {"mso": midi["mso"]["launches"][kernel],
                "process_dataset": midi["process_dataset"]["launches"][kernel],
                "train_fused": midi["train"]["launches"][kernel],
                "serve": midi["serve"]["launches"][kernel]}

    band1, band64 = front["band_timings"]
    frames418, frames26752 = front["band_frame_timings"]
    synth1, synth64, synth256 = front["synth_timings"]

    def synth_at(row):
        """A synthesizer row; a device time the profiler did not capture
        (no launch seen) is None, not 0."""
        out = {"ms": float(np.mean(row["kernel_ms"])),
               "device_ms": row["kernel_device_ms"] if row["kernel_device_launches"] else None,
               "plain_ms": float(np.mean(row["plain_ms"])), "bound_ms": row["bound_ms"],
               "bound_by": row["bound_by"], "library_ms": float(np.mean(row["index_add_ms"])),
               "library_device_ms": row["index_add_device_ms"] or None}
        if "kernel_graph_ms" in row:
            out.update(graph_ms=row["kernel_graph_ms"],
                       library_graph_ms=row["index_add_graph_ms"])
        return out

    def band_at(row, library_key):
        return {"N": row["N"], "ms": float(np.mean(row["kernel_ms"])),
                "device_ms": row["kernel_device_ms"],
                "plain_ms": float(np.mean(row["plain_ms"])), "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": float(np.mean(row[library_key]))}

    kernels.append({
        "name": "band_energies", "route": "cuda", "source": BAND_SOURCE,
        "replaces": BAND_TPU_KERNEL, "launches": hvo["launches"]["band_energies"],
        "launches_audio_augment_path": augmented["launches"]["band_energies"],
        "launches_checkpoint_path": saved["launches"]["band_energies"],
        "launches_cli_path": cli_launches(cli, "band_energies"),
        "launches_process_evaluator_path":
            evaluation["process_evaluator"]["launches"]["band_energies"],
        "launches_midi_sf2_path": midi_launches("band_energies"),
        "max_abs_err": front["band_err"], **band_at(band1, "library_ms"),
        "library_device_ms": band1["library_device_ms"],
        "chunk_of_64": {**band_at(band64, "library_ms"),
                        "library_device_ms": band64["library_device_ms"]},
        "frames_entry": {"N 418": band_at(frames418, "rfft_matmul_ms"),
                         "N 26752": band_at(frames26752, "rfft_matmul_ms")},
        "at": f"one request at 120 bpm: M 1, {band1['length']} samples, N {band1['N']} "
              "frames x 1024, float32, through band_energies_from_audio; ms: stream time; "
              "device_ms: the profiler's per launch; library: _windowed_frames, "
              "torch.fft.rfft, abs, one matmul from the same waveform; bound: the waveform "
              "read once and an FFT's operations; err: the largest over every check, each "
              "held to 1e-4 of its largest band energy; frames_entry: "
              "band_energies(frames), library rfft of the "
              "same frames, bound: frames read once"})
    kernels.append({
        "name": "device_synth", "route": "cuda", "source": SYNTH_SOURCE,
        "replaces": SYNTH_TPU_KERNEL, "launches": hvo["launches"]["device_synth"],
        "launches_audio_augment_path": augmented["launches"]["device_synth"],
        "launches_checkpoint_path": saved["launches"]["device_synth"],
        "launches_cli_path": cli_launches(cli, "device_synth"),
        "launches_process_evaluator_path":
            evaluation["process_evaluator"]["launches"]["device_synth"],
        "launches_midi_sf2_path": midi_launches("device_synth"),
        "max_abs_err": max(front["synth_err"], midi["synth"]["max_abs_err"]),
        **synth_at(synth1),
        "chunk_of_64": synth_at(synth64), "chunk_of_256": synth_at(synth256),
        "three_kit_table": {**midi["table"], **{
            f"M {row['M']}": synth_at(row) for row in midi["synth"]["timings"]}},
        "at": f"M 1 loop, 288 cells, length {synth1['length']} (120 bpm), float32; ms: stream "
              "time; device_ms: the profiler's per launch; library: one index_add_ over "
              "indices and sources prepared outside the timed call; chunk_of_256: the audio "
              "augment's chunk; three_kit_table: phase 23's three SoundFont kits packed "
              "(velocity-layer LUTs, rows padded to the longest), a kit an item in turn, "
              "120 bpm, graph_ms: per call replayed from a CUDA graph of 20 calls (device "
              "time without host launches), library_graph_ms likewise for index_add_; "
              "err: the largest over phases 10 and 23, both bit for bit; a device time the "
              "profiler did not capture is null"})
    def ffn_row(rows, d, dtype):
        return next(t for t in ffn_ln["timings"]
                    if t["rows"] == rows and t["d"] == d and t["dtype"] == dtype)

    def device_ms(row, *entries):
        """Device ms per launch of the kernels whose names hold ``entries``."""
        return sum(us for k, us in row["kernel_device_us"].items()
                   if any(e in k for e in entries)) / 1000.0

    def at_shape(row, kname, entries, key):
        out = {"ms": device_ms(row, *entries),
               "stream_ms_of_the_call": float(np.mean(row[f"{key}_kernel_ms"])),
               "plain_ms": float(np.mean(row[f"{key}_plain_ms"])),
               "bound_ms": row["bounds"][kname]["bound_ms"],
               "bound_by": row["bounds"][kname]["bound_by"],
               "library_ms": float(np.mean(row[f"{key}_library_ms"])),
               "library_device_ms": row[f"{key}_library_device_ms"]}
        if key.startswith("ffn_"):  # the whole call: its launches' device time, its own bound
            suffix = "_f32" if row["dtype"] == "float32" else ""
            direction = key.removeprefix("ffn_")
            out["call_device_ms"] = sum(
                device_ms(row, *FFN_DEVICE_NAMES[f"fused_ffn_{name}{suffix}"])
                for name, _ in ffn.LAUNCHES if name.startswith(direction)
                or (direction == "bwd" and name == "reduce"))
            out["call_bound_ms"] = row["bounds"][f"fused_ffn_{direction}{suffix}"]["bound_ms"]
        return out

    names = {**{k: (FFN_DEVICE_NAMES[k], "ffn_") for k in ffn.KERNELS},
             "fused_ln_fwd": (("ln_fwd",), "ln_"), "fused_ln_bwd": (("ln_bwd",), "ln_")}
    for kname, (entries, prefix) in names.items():
        is_ffn, is_f32 = kname.startswith("fused_ffn"), kname.endswith("_f32")
        dtype = "float32" if is_f32 else "bfloat16"
        key = prefix + ("fwd" if "_fwd" in kname else "bwd")
        small = ffn_row(1024, 256, dtype)
        if not is_ffn:
            launches_main = wide["ln_launches"][kname]
        else:
            launches_main = (wide["f32_launches"] if is_f32 else wide["launches"])[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": FFN_SOURCE if is_ffn else LN_SOURCE,
            "replaces": (FFN_TPU_KERNELS if is_ffn else LN_TPU_KERNELS)[kname],
            "launches": launches_main,
            "launches_encdec_1_plus_1_path": wide["encdec_launches"][kname],
            "launches_groovexl_path": xl["f32_launches" if is_f32 else "launches"][kname],
            **({} if is_f32 or not is_ffn else {"launches_groovexl_dp2_pp2_per_rank": [
                c.get(kname, 0) for c in per_rank("de", "d", "train_launches")]}),
            "max_abs_err": ffn_ln["max_abs_err"]["ffn" if is_ffn else "ln"],
            "vmap": vmap_route("fused_ffn" if is_ffn else "fused_dropout_ln", dtype, kname),
            **at_shape(small, kname, entries, key),
            "rows_16384": at_shape(ffn_row(16384, 256, dtype), kname, entries, key),
            "groovexl": at_shape(ffn_row(4096, 1024, dtype), kname, entries, key),
            "at": f"rows 1,024 (batch 32), d 256, ff 2048, {dtype}, rate 0.16; rows_16384: "
                  "batch 512; groovexl: rows 4,096, d 1024, ff 4096, rate 0.1; ms: device "
                  "time per launch; stream_ms_of_the_call, plain_ms and library_ms are on the "
                  "stream and cover the whole forward or backward call the kernel is part of "
                  "(the FFN's plain version, ffn_reference or backward_formulas; the LN's the "
                  "reference and autograd); library: F.linear, relu, F.dropout, F.linear (FFN; "
                  "f32 with TF32 off) or F.layer_norm(x + F.dropout(y)) (LN), and autograd's "
                  "backward, library_device_ms its device time; call_device_ms and "
                  "call_bound_ms: the FFN call's launches and its own bound (f32 products at "
                  "495/3 TFLOP/s); bound: this launch's own bytes and operations; err: the "
                  "largest of out, h, dx (FFN) or out, dx, dy (LN) over the f32 checks; "
                  "launches: phase 18's main run (bf16 FFN kernels), its run with "
                  "fused_dropout_ln (LN), its 3 f32 steps (f32 FFN launches, the forward twice "
                  "a call there); groovexl path: phase 19's 2 epochs in the launch's dtype"})
    emit({"kernels": kernels, "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # a rank of phase 26
        sys.exit(parallel_rank(sys.argv[2], sys.argv[3]))
    sys.exit(main())
