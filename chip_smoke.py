#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wespeaker_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still builds, runs and agrees with
itself on the card.

    python3 chip_smoke.py

Phases, each printing one line:
  1. device   the card's name and power limit (nvidia-smi) and the time to
              build the CUDA kernels from csrc/ into build/;
  2. kernels  each inference kernel against its plain PyTorch version on
              the card at the flagship width (C=512): bf16 unmasked at
              T=200 (cosine >= 0.9999), f32 masked at T=198 (TF32 off,
              rtol/atol 1e-4) and bf16 masked at the edge B=3, T=37 (B*T
              = 111, no multiple of the GEMM's 128-row tile); the tail
              also bf16 masked at C=1024 (ECAPA_TDNN_GLOB_c1024's MFA
              conv, 3072 -> 1536, random weights), B=3, T=37, and at
              C=256 (the quality smoke's ECAPA_TDNN, MFA conv 768 ->
              1536, random weights) without the global context, as that
              model has none: bf16 at T=200, f32 masked at T=198 and
              bf16 masked at B=3, T=37; and with it in bf16 at T=200;
  3. train kernels  the training tail's forward kernel against its plain
              version on all four outputs (pooled, h, att, cstats), and
              its backward kernel against the plain backward and against
              autograd through the plain forward, at B=64, C=512: bf16 at
              T=200 (cosine >= 0.9999 per output) and f32 at T=198
              (rtol/atol 1e-4, each gradient scaled by its largest
              magnitude), except db1 against bf16 autograd (cosine >=
              0.99, see phase_train_kernels); db2 must be exactly zero;
              then bf16 at the WavLM + ECAPA recipes' shapes (T=149 at
              B=256, T=299 at B=64), at C=1024 (random MFA weights),
              B=3, T=37, and
              at C=256 (random MFA weights), B=64, T=200, bf16 and f32,
              each without the global context (the smoke's model) and
              with it;
  4. slice    ECAPA_TDNN_GLOB_c512 at full width with random weights and
              randomised BN statistics from a seed: make_eval_embed_fn in
              bf16 over 2 s chunks (32,240 samples), the kernel path
              against the layer-by-layer plain path (cosine >= 0.9999);
              the SE kernel must launch 3 times and the tail kernel once;
  5. serving  an EmbeddingServer on port 0 answers concurrent /embed
              requests of 1 to 3 s and one /similarity; each reply against
              the port's own batch=1 forward (cosine >= 0.9999); both
              inference kernels must have launched;
  6. train step  ECAPA_TDNN_GLOB_c512 + ArcMargin over 17,982 classes,
              B=64, bf16 AMP, dither and spec-aug: 3 steps must be finite
              and launch each train kernel once per step and no inference
              kernel; then one step of the kernel path and one of the
              plain path from the same initial weights without
              randomness, in bf16 and in f32 (TF32 off): the loss within
              1e-3 relative and each layer's update (its parameters as one
              vector) at cosine >= 0.999;
  7. trainer  bin/train.py at full width on a synthetic corpus written
              from the seed (12 speakers x 4 utterances of 2.5-4 s): bf16,
              batch 32 x 200 frames, speed perturb, one epoch of 3 steps;
              it must log, write model_0.pt and final_model.pt and launch
              both train kernels 3 times; the extractor loads the
              checkpoint and embeds one utterance;
  8. timing   CUDA events after warm-up at B=512, T=200, C=512, bf16: each
              inference kernel and its plain version, with the bound from
              the shapes (bin/kernel_bounds.py: 989 TFLOP/s bf16, 3.35
              TB/s) and for the tail the floor of its chain of launches,
              the SE block's and the tail's kernel launches a call
              (torch.profiler; the tail's four products must run on
              gemm_sm90, none on the WMMA GEMM);
              extraction audio-s/s at B=512;
  9. train timing  the train kernels and their plain versions at B=256,
              T=200, C=512, bf16, with bounds and the backward's design
              floor; a bf16 backward call's launches (torch.profiler: five
              on gemm_sm90, one gemm_tn_sm90, none on the WMMA or FMA
              GEMMs); train-step audio-s/s at
              bench.py's train config (B=256, 2 s chunks, bf16, dither,
              spec-aug, ArcMargin 17,982, SGD) on the kernel path and the
              plain path (fused=False);
 10. cam kernels  the CAM++ dense-block kernel against its plain version
              at each of CAMPPlus's three full-width block shapes (C0 128,
              256, 512; 12, 24, 16 layers; dilation 1, 2, 2): bf16
              unmasked at T'=100, B=64 (cosine >= 0.9999 on the new
              channels), f32 with a ragged mask at T'=249 (TF32 off,
              rtol/atol 1e-4) and bf16 masked at the edge B=3, T'=37;
 11. campplus slice  CAMPPlus at the width of campplus.yaml (feat 80,
              embed 512, TSTP) with random weights and randomised BN
              statistics from a seed: make_eval_embed_fn in bf16 over 2 s
              chunks at B=64, the kernel path against the layer-by-layer
              path with plain pooling (cosine >= 0.9999), exactly 3
              dense-block launches and one masked-stats launch (its TSTP)
              per forward; then the same in f32 on a copy whose BN statistics
              come from one train-mode forward over seeded synthetic
              voices, so that its embeddings depend on the input;
 12. campplus serving  an EmbeddingServer built from a CAM++ YAML and a .pt
              the phase saves: three waves of concurrent /embed requests of
              1-3 s served in buckets of T' = 49, 99 and 149 frames; each
              reply against batch=1 (cosine >= 0.9999); the kernel must
              have launched;
 13. campplus timing  CUDA events after warm-up at B=512, T=200 (T'=100),
              bf16: each block's kernel and plain version with its bound
              and its kernel launches and copies (torch.profiler), the
              three blocks against the design's floor (each layer reads
              its live channels from device memory); CAMPPlus extraction
              audio-s/s on the kernel path and with fused_blocks=False
              and plain pooling;
 14. gemini kernels  the Gemini stage kernel against its plain version at
              each of Gemini_DF_ResNet114's four full-width stage shapes
              ((F, C, blocks) = (40, 32, 3), (20, 64, 3), (10, 128, 27),
              (5, 256, 3)), B=64: bf16 at 200 frames (cosine >= 0.9999)
              and f32 at a ragged 198 frames (TF32 off, rtol/atol 1e-4);
              then at the edges of the bf16 kernel's tile plan
              (GEMINI_EDGES: B = 1, F = 1, T' = 1, T' = 49, T' not a
              multiple of the tile, F = 3 at C = 32, C = 256 at F = 5 and
              T' = 7) in bf16 and f32 at the same bars;
 15. gemini slice  Gemini_DF_ResNet114 at the width of
              gemini_dfresnet_adam.yaml (feat 80, embed 256, TSTP), random
              weights and BN statistics from a seed: make_eval_embed_fn in
              bf16 over 2 s chunks at B=64, the kernel path against the
              block-by-block path with plain pooling (cosine >= 0.9999),
              exactly 4 stage launches and one masked-stats launch per
              forward; then f32 on a copy whose BN statistics come from
              synthetic voices;
 16. gemini serving  an EmbeddingServer from a Gemini YAML and a .pt of the
              calibrated copy: three waves of concurrent /embed requests in
              buckets of T' = 49, 99 and 149 frames; each reply against the
              same request padded to its bucket (cosine >= 0.9999), and
              against batch=1, recorded only;
 17. gemini timing  CUDA events after warm-up at B=512 x 200 frames, bf16:
              each stage's kernel and plain version with its bound, its
              kernel launches a call (torch.profiler; one a block, 36 in
              all) and the device memory the call takes beyond its input
              beside the h and g the parent design allocated;
              Gemini_DF_ResNet114 extraction audio-s/s and peak device
              memory on the kernel path and with fused_stages=False and
              plain pooling;
 18. res2 kernels  the Res2 chain kernel (ECAPA's fused_res2 route) against
              its plain version at ECAPA_TDNN_GLOB_c512's three chains (width
              64, dilation 2/3/4) and a c1024 chain (width 128), B=64: bf16
              at T=200 (cosine >= 0.9999) and f32 at T=198 (TF32 off,
              rtol/atol 1e-4); bf16 at the edge B=3, T=37;
 19. res2 slice  ECAPA_TDNN_GLOB_c512 in eval with fused=False,
              fused_res2=True, make_eval_embed_fn in bf16 over 2 s chunks at
              B=64, against the layer-by-layer path with plain pooling
              (cosine >= 0.9999), exactly 3 chain launches and one launch
              of each pooling kernel (its ASTP) per forward, nothing else;
 20. res2 timing  CUDA events at B=512, T=200, C=512, bf16: the chain kernel,
              its plain version, its bound and its launches a call and a
              forward (torch.profiler); ECAPA extraction audio-s/s
              with fused_res2 and layer by layer (plain pooling in both);
 21. dw kernels  dw_pack (the tap-packed 3x3 filter gradient) against its
              plain version at ResNet34's three packed shapes at B=128 x
              200 frames (the stem 80 x 200, 1 -> 32; layer1 80 x 200,
              32 -> 32; layer2 40 x 100, 64 -> 64) and the zoo's five
              (ZOO_DW: ERes2Net34's and Res2Net34's 16 -> 16 and
              ERes2Net34_aug's 24 -> 24 at 80 x 200, the 1 -> 64 stem,
              48 -> 48 at 40 x 100, 64 -> 64 at 20 x 50): bf16 (cosine >= 0.9999)
              and f32 (TF32 off, error <= 1e-4 of the largest magnitude),
              two calls bit-identical; the same at eight edge shapes
              (Ci -> Co 1 -> 32, 8 -> 24, 48 -> 48, 64 -> 64; W of 1, 17
              and 250; H = 1; B*H below the SM count); an ineligible shape
              (Ci = 128, a stride-2 conv's dy) raises;
 22. resnet slice  ResNet34 at resnet.yaml's width (feat 80, embed 256,
              TSTP), weights from the seed and BN statistics from synthetic
              voices: make_eval_embed_fn over 2 s chunks at B=64, f32 on the
              card (TF32 off) against the same weights on the CPU (cosine
              >= 0.9999), bf16 against f32 recorded; no dw launch, one
              masked-stats launch (its TSTP) per forward;
 23. resnet serving  an EmbeddingServer from a ResNet34 YAML and a .pt:
              three waves of concurrent /embed requests in buckets of 1, 2
              and 3 s; each reply against the same request padded to its
              bucket (cosine >= 0.9999), against batch=1 recorded only;
 24. resnet train  ResNet34 + ArcMargin over 17,982 classes, B=128 x 200
              frames, bf16 AMP, SGD (nesterov, momentum 0.9, wd 1e-4),
              conv_dw_mode packed: 3 finite steps with exactly 14 dw
              launches each; one step packed and one native from the same
              weights without randomness, bf16 and f32 (TF32 off): loss
              within 1e-3 relative, each layer's update at cosine >= 0.999;
              then bin/train.py with a ResNet34 YAML (conv_dw_mode: packed)
              for one epoch of 3 steps on the synthetic corpus (batch 32):
              42 dw launches, final_model.pt, reloaded by the extractor;
 25. resnet timing  CUDA events after warm-up: dw_pack at each of the three
              shapes (kernel and cuDNN's weight gradient timed 3 times in
              turns by CUDA-graph replay, median and spread; plain;
              bound);
              ResNet34 extraction audio-s/s at B=512 x 2 s bf16; the
              ResNet34 train step's audio-s/s at B=128 bf16, packed and
              native.
 26. family train  CAMPPlus, Gemini_DF_ResNet114 and ReDimNetB2 at their
              YAMLs' widths (ReDimNetB2: 72-bin fbank, embed 192) with
              ArcMargin over 17,982 classes: 3 bf16 AMP steps each at
              B=32 x 2 s (dither, spec-aug, SGD); finite losses, no kernel
              launch; then each family's ms a step after those warm-up
              steps (CUDA events over 3 steps) and one more step's device
              ms, launches and busy share (torch.profiler);
 27. pool kernels  the two statistics-pooling kernels (ASTP's softmax-
              weighted mean and std; the masked mean and std) against their
              plain versions: bf16 at ReDimNetB2's pooling shape (B=512,
              T=200, D=1152), ResNet34's TSTP shape (T'=25, D=2560),
              ERes2Net34's (T'=25, D=5120) and the x-vector's (T'=186,
              D=1500) (cosine >= 0.9999 per output), f32 at T=198, D=600, B=3 with
              a ragged mask and an utterance with no valid frame (within
              1e-4 of the largest magnitude), the masked stats at ddof 0
              and 1; the masked stats at its edges: T = 1, one valid frame
              (count <= ddof), D = 7 and 600, f32 with mean 1e3 and std
              1e-2 (also the std within 1e-4 of its magnitude of the
              contract in f64) and B = 65,536,
              T = 2, D = 8; the softmax stats also with f32 logits (the
              ECAPA tail's) and at its edges, bf16 and f32 logits: T = 1,
              one valid frame, D = 7, B = 65,537 with T = 3 and D = 8, and
              logits near 80, each with an utterance of no valid frame;
              an input that requires grad, or of another type, raises;
 28. redimnet slice  ReDimNetB2 at redimnet.yaml's width (feat 72 from a
              72-bin fbank, embed 192, ASTP with global context), random
              weights and BN statistics from the seed: make_eval_embed_fn in
              bf16 over 2 s chunks at B=64, one launch of each pooling
              kernel per forward, against fused=False pooling (cosine >=
              0.9999); then f32 on the card against the CPU on a copy with
              BN statistics from synthetic voices (cosine >= 0.9999);
 29. redimnet serving  an EmbeddingServer from a ReDimNetB2 YAML and a .pt
              of the calibrated copy: three waves of concurrent /embed
              requests in buckets of 1, 2 and 3 s, one launch of each
              pooling kernel per batch; each reply against the same request
              padded to its bucket and embedded directly (cosine >=
              0.99999), against batch=1 recorded only;
 30. redimnet timing  CUDA events after warm-up at B=512 x 200 frames,
              bf16: each pooling kernel at ReDimNetB2's shape (kernel,
              plain, torch.std_mean for the masked stats, bound) and the
              masked stats at ResNet34's TSTP shape, the masked stats and
              torch.std_mean timed 3 times in turns by CUDA-graph replay
              (median and spread); ReDimNetB2 and
              ResNet34 extraction audio-s/s with the pooling kernels and
              with fused=False pooling;
 31. dino     bench.py's DINO config (ECAPA_TDNN_GLOB_c512, a 65,536-d BN
              head 2048 / 256, B=64 utterances as 2 global 3 s and 4 local
              2 s crops, bf16, SGD, teacher temp 0.04, weights from the
              seed), ssl/dino.py's DINOTrainStep: 3 finite steps, each
              launching the SE block kernel 3 times and the tail kernel
              once (the teacher's eval forward) and the training tail's
              forward and backward twice (the student, global then local
              crops), nothing else; rows 4 and 5 against their plain
              versions at (B, T) = (128, 298) and (256, 198) in bf16
              (cosine >= 0.9999 on each output and gradient, db2 = 0);
              then one step of the kernel path and one of the plain path
              (fused=False, plain pooling) from the same weights in f32
              (TF32 off) and bf16, each path's teacher the EMA of its
              student: the loss within 1e-3 relative and the center at
              cosine >= 0.999; in f32 each layer's update and teacher move
              at cosine >= 0.999; in bf16 each path's update against the
              plain f32 step's, layer by layer, the kernel path's error no
              more than 1.1 x the plain path's + 0.05 (compare_dino_paths
              says why); rows 1 and 2 against their plain versions on the
              teacher's own bf16 activations of the global crops
              (B=128, T=298), cosine >= 0.9999;
 32. dino timing  crop-audio-s/s (64 x 14 s a step) and peak device memory
              of that step on the kernel path and the plain path, features
              precomputed, CUDA events over 5 steps after 2 warm-up, 3
              repeats (median and spread); then one step of each by
              torch.profiler: device ms, launches and busy share;
 33. dino trainer  bin/train_dino.py with ecapa_dino.yaml at full width in
              bf16 on a synthetic corpus of 192 utterances: one epoch of
              3 steps (stop_epoch 1) with the step's launches 3 times,
              model_0.pt and trainer_state.pt written; then resume=true
              for the second epoch, whose steps continue at 3; the
              extractor loads model_1.pt and embeds one utterance;
 34. contrastive  bin/train_contrastive.py with ecapa_moco.yaml (queue
              65,536) and ecapa_simclr.yaml, B=64 x 2 s, bf16, 3 steps
              each: finite logged losses, per step MoCo's rows 1 and 2
              (key encoder) 3 and 1 times and rows 4 and 5 once, SimCLR's
              rows 4 and 5 once; MoCo's queue pointer at 3 x 64;
 35. quality  bin/smoke_quality.py's synthetic formant corpus at 12
              speakers (8 training and 2 evaluation utterances of 3 s
              each) and its supervised config (ECAPA_TDNN at 256
              channels, embed 128, ArcMargin, SGD, bf16 AMP, B=64 x 200
              frames), driven through the port's CLIs in this process:
              bin/train.py for 2 epochs of 20 steps, rows 4 and 5 once a
              step and nothing else; bin/extract.py --bf16 at batch 8,
              row 2 once a batch and nothing else (the SE blocks of
              width 32 run layer by layer); each embedding against
              make_eval_embed_fn's plain path on the same checkpoint and
              buckets (cosine >= 0.9999); bin/score.py, each score within
              1e-5 of a numpy f64 cosine over the ark; the EER and minDCF
              of bin/compute_metrics.py, printed without a bar; then the
              smoke's back end (bin/smoke_quality.py::back_end): the
              training list extracted, PLDA, AS-Norm and QMF through
              bin/plda_tools.py, bin/score_norm.py, bin/prep_data.py and
              bin/score_calibration.py, their EERs printed without a bar.
 36. diar     diarization on the quality phase's trained ECAPA_TDNN
              (C=256) and checkpoint: a recording of 6 of its corpus's
              speakers, their 2 held-out 3 s evaluation utterances in 12
              alternating turns with 0.3 s of silence (16 kHz); the turns
              are the oracle SAD and the reference RTTM.
              bin/diarize.py --bf16 (batch 64) with spectral clustering,
              the count estimated and then num_spks 6, and with
              UMAP+HDBSCAN: row 2 once a batch and nothing else (the SE
              blocks take the layers at this width); each run again
              through diarize_wav on the plain path (fused=False, plain
              pooling, f32, no launch): the kernel path's hypothesis
              within DER 0.05 of the plain path's; the window embeddings
              of the bf16 kernel path against the f32 plain path, and of
              the kernel path against the plain path in one type (bf16,
              f32), at cosine >= 0.9999; two UMAP layouts of the same
              window embeddings bit-identical; each run's DER against the
              turns printed without a bar; an EmbeddingServer from the same YAML and
              checkpoint answers /diarize with the segments of
              diarize_wav in-process on the same model (energy VAD,
              spectral, f32 kernel path); cli/speaker.py's Speaker on a
              model directory (config.yaml, final_model.pt): diarize,
              compute_similarity, register of the 6 speakers and
              recognize of their other utterances (printed, no bar);
 37. diar full  diarization at full width: ECAPA_TDNN_GLOB_c512 as
              examples/voxceleb/v2/conf/ecapa_tdnn_c512.yaml (the
              voxconverse v2 recipe's default model), random weights from
              the seed, BN statistics from synthetic voices; 30 minutes of
              6 formant speakers (bin/smoke_quality.py's voices, drawn on
              the card for any length), turns of 2-8 s, gaps of 0.2-1 s,
              oracle SAD, bf16, batch 64: per clusterer (spectral with
              the count estimated, UMAP) bin/diarize.py --bf16, row 1
              three times a batch and row 2 once, nothing else, its DER
              against the turns printed without a bar (random weights)
              and its seconds (the model's load and the first calls
              included); then diarize_wav in-process, warm, with a `mark`
              that times each of its stages (fbank, embedding, then
              spectral's affinity, eigh, k-means or UMAP's graph+init,
              layout of 500 epochs, HDBSCAN, PAHC, then merge; the
              embedding's ms between CUDA events too) and its seconds
              over the recording's (the real-time factor); then on the
              plain path (fused=False, plain pooling, f32, no launch):
              the spectral hypothesis of bin/diarize.py within DER 0.05
              of the plain path's (UMAP's printed, no bar); the window
              embeddings of the kernel path (bf16 and f32) against the
              plain path at cosine >= 0.9999, as in diar; the
              Laplacian's eigh on the card against scipy's on the host,
              timed, with the same eigengap count;
 38. backend  the SRE recipes' back end on examples/sre/v2/conf/
              resnet34_sre.yaml (ResNet34, 8 kHz, fbank 40, embed 256,
              TSTP) at full width: a seeded port model (BN statistics
              from synthetic voices) mapped to flax trees
              (utils.weights.to_jax_variables) and written as three
              perturbed model_{0,1,2}.ckpt by the port's msgpack writer;
              bin/average_model.py -> avg_model.ckpt; bin/extract.py over
              128 speakers x 4 synthetic 2 s utterances (16 kHz, resampled
              to 8 kHz) at batch 128 from the .ckpt and from a .pt holding
              the same average (summed in f64 by torch): the two arks
              must be equal byte for byte, and the .ckpt run must launch
              row 7 (the TSTP's masked stats) once a batch and nothing
              else; then examples/sre/v3's stages 5-8 through the CLIs:
              bin/embd_proc.py (mean-subtract | length-norm | lda dim 100
              | length-norm), bin/plda_tools.py train, adapt and eval,
              bin/compute_metrics.py; each LLR of the trial list on the
              card within 1e-4 of the same function in f64 on the CPU,
              relative to max(|LLR|, 1); each step's seconds and the EERs
              (random model, no bar) printed. The files are the JAX
              package's formats: embd_proc.pkl a pickle, plda.h5 and
              plda_adapt.h5 HDF5 (by their first bytes); each read back
              through the port's readers equals, to the bit, the model
              estimated in memory from the same arks, and the LLRs on the
              card from plda_adapt.h5 read back equal the in-memory
              model's exactly.
 39. aug      the recipes' MUSAN/RIR stores, synthetic (24 decaying-noise
              RIRs of 0.3-1 s; 24 noises keyed noise-, music-, speech-),
              packed by `python -m wespeaker_tpu_torch.bin.prep_data
              aug_store`; train/device_aug.py::device_augment on the card
              against the port's CPU result on the same int16 samples and
              host choices (attach_device_aug, aug_prob 0.6, reverb rows
              first), B=128 x 32,240 samples, R=16,000: f32 max abs error
              <= 1e-4 of the peak, modes 0, 1 and 2 present, mode-0 rows
              bit-equal; the card's ms a batch (CUDA events) and one
              call's device ms by kernel (torch.profiler) beside the
              host's augment_one over the same 128 rows (host clock);
              the phase's seconds, the stores' among them;
 40. recipe train  bin/train.py on the recipe YAMLs unchanged but for the
              corpus (8 synthetic tar shards, 16 speakers x 8 utterances
              of 2.5-4 s, and the stores), the epoch and step counts, and the
              option each run is about. First the host pipeline alone
              (SpeakerDataset over the shards, one process, ms a batch
              of 64): without speed perturb and augmentation, with speed
              perturb, with host augmentation, with the device-aug
              picks. Then ecapa_tdnn_c512.yaml (full width,
              B=64, 14 steps) with host augmentation in one process, with
              min(4, cores - 1) worker processes and with device_aug,
              rows 4 and 5 once a step and nothing else, each run's wall
              ms a step over the 8 steps before its last (TrainStep
              wrapped from the outside: host clock between synchronizes,
              no profiler), its last step's device ms (torch.profiler)
              and the busy share of the two, and the device-aug step
              alone on one held batch (ms a step, device ms and busy
              share); the same YAML
              with sphereface2 and arc_margin_intertopk_subcenter (3
              steps); resnet.yaml with conv_dw_mode packed (B=128, 3
              steps, row 10 14 times a step); examples/sre/v2/conf/
              resnet34_sre.yaml (softmax head, its 8 workers, 8 kHz,
              B=256, 3 steps; the head's BatchNorm statistics carried).
              Every loss finite, every run's model_0.pt holding the
              trained model and head; each run's seconds and the phase's.
 41. zoo slice  the rest of the model zoo at the recipes' widths with
              random weights from SEED (ZOO: ERes2Net34_Base as
              eres2net.yaml, Res2Net34_Base as res2net.yaml,
              REPVGG_TINY_A0 as repvgg.yaml, XVEC as xvec.yaml,
              XI_VEC_ECAPA_TDNN_c512 as xi_vector.yaml, ReDimNet2B6 as
              redimnet2.yaml's model on a 72-bin fbank, SimAM_ResNet34_ASP
              at its defaults), B=64 x 2 s: each model's launches a
              forward (rows 7; 6 and 7; 1 three times; none for SimAM's
              plain ASP), the kernel route against the plain route
              (set_pooling_fused False, ECAPA's set_fused(False)) in bf16
              (cosine >= 0.9999) and f32 (>= 0.99999), f32 on the card
              against the CPU on a copy whose BN statistics come from
              synthetic voices (>= 0.9999), and the frame features' shape;
 42. zoo serving  an EmbeddingServer from eres2net.yaml and a .pt of the
              calibrated ERes2Net34_Base: three waves of /embed in buckets
              of 1, 2 and 3 s, each reply against the request padded to
              its bucket (cosine >= 0.99999), row 7 once a batch;
 43. zoo train  bin/train.py on eres2net.yaml unchanged but for the
              corpus (write_shards and the aug phase's stores), 3 steps
              and conv_dw_mode packed, at B=128: row 10 27 times a step,
              the second step's wall ms and the third's device ms, the
              extractor on model_0.pt; redimnet2.yaml unchanged but for
              the corpus and 2 steps at B=32 (its tfmel frontend and
              sphereface2 head; no kernel), the extractor through tfmel
              on its model_0.pt (rows 6 and 7 once); 3 bf16 steps
              in-process at B=32 for
              the other six (ReDimNet2B6 with sphereface2, the rest
              ArcMargin), every loss finite and no kernel launched; one
              ERes2Net34_Base step packed and one native from the same
              weights in bf16 and f32 (loss within 1e-3, each layer's
              update at cosine >= 0.999);
 44. repvgg deploy  repvgg.yaml through bin/train.py (3 steps at B=64),
              bin/convert_repvgg.py on its model_0.pt, bin/extract.py in
              f32 over 8 utterances with the train form and with
              model_args.deploy=true: cosine >= 0.99999;
 45. zoo timing  ERes2Net34_Base and XVEC extraction at B=512 x 2 s bf16
              with row 7 and then with plain pooling (CUDA events, 5
              calls after 2), with the card's name and power limit;
 46. frontend slice  the neural frontends' recipes at their YAMLs' full
              widths with random weights from SEED, built on the card:
              WavLM-Large + ECAPA_TDNN_GLOB_c512 (ecapa_wavlm_joint_ft),
              the Whisper-large-v2 encoder (24 blocks) + whisper_PMFA
              (whisper_pmfa_stage2), w2v-bert 2.0 + W2VBert_Adapter_MFA
              (w2vbert_s2_ft). Each: bin/extract.py --bf16 on a ragged
              list of 6 utterances in 2 batches, its launches (rows 1 x3
              and 2 a batch for WavLM + ECAPA, rows 6 and 7 at D = 10,240
              for Whisper-PMFA, none for w2v-bert's plain ASP), its
              embeddings against the buckets embedded directly (>=
              0.99999), the kernel route against the plain route in bf16
              (>= 0.9999), f32 on the card against a CPU copy on two
              utterances (>= 0.99999); for WavLM the raw waveform rounded
              to bf16 against f32 (>= 0.9999) and the whole bf16 path
              recorded; a server from the YAML and a .pt (replies against
              the buckets, >= 0.99999, launches a batch; /diarize 501);
 47. frontend timing  extraction B=64 x 2 s bf16 audio-s/s of each
              family (CUDA events, the median of 5 readings of 3 calls
              after 1);
 48. frontend train  bin/train.py on the eight YAMLs of the three
              families unchanged but for the corpus (write_shards at
              4.2-6.5 s and the aug phase's stores), 3 steps at each
              YAML's own batch size: rows 4 and 5 once a WavLM + ECAPA
              step, no launch under the others, frozen frontends
              bit-identical after the steps and joint ones moved, the
              second step's wall ms and the third's device ms.
 49. deploy  (right after the trainer, so that its trace is the process's
              first torch.profiler session) ECAPA_TDNN_GLOB_c512 at full
              width: recipe stage 1 (prep_data raw and shard over 8
              speakers x 4 seeded wavs), 2 steps of bin/train.py on
              ecapa_tdnn_c512.yaml unchanged but for the corpus, with
              profile_args: rows 4 and 5 launch twice each and the trace
              names their kernels; bin/export_model.py to .pt2 (on the
              CPU) loaded on the card: at (B, T) = (64, 200) and (1, 137)
              in f32 it launches se=3 tail=1 a call and meets the eager
              model within 1e-4 of the largest magnitude (TF32 off), with
              its ms against eager at B=64 (CUDA events, eager, .pt2,
              .pt2, eager); the ONNX export run by export/onnx_numpy.py
              against the eager CPU plain forward (relative 1e-4) at two
              shapes; bin/infer_demo.py on a 3 s wav against
              bin/extract.py's embedding (cosine >= 0.9999); the C++
              runtime built with the host compiler: its fbank against the
              port's (atol 2e-3, rtol 1e-3), its engine with the model on
              the card as the callback against the same chunking in
              Python (cosine >= 0.9999, rows 1 and 2 once a chunk) and its
              real-time factor, extract_emb_main and asv_main.
 50. ddp eval  (after diar, on its files) --data_parallel with two
              replicas on cuda:0 against one replica: bin/extract.py bf16
              with ECAPA_TDNN_GLOB_c512 (random weights from SEED) over
              the quality corpus's evaluation list, the same keys in the
              same order at cosine >= 0.9999, rows 1 x3 and 2 x1 a
              replica batch (twice the one replica's); bin/diarize.py on
              the diar recording with the quality checkpoint, the same
              RTTM.
 51. ddp  (after recipe train, with the aug stores) the parallel layer
              on one card. Two ranks of this script (--ddp-rank) over gloo
              on CUDA tensors (NCCL refuses two ranks on one device):
              bin/train.py on ecapa_tdnn_c512.yaml unchanged but for the
              corpus (write_shards) with distributed_args, B=64 a rank, 3
              steps: each rank launches rows 4 and 5 three times, the
              ranks' parameters and buffers hash alike, rank 0 alone
              writes model_0.pt and a resume in 2 ranks loads it; a step's
              wall and device ms and one gradient all_reduce's ms (gloo
              stages through the host: no NCCL figure). One step of
              ECAPA_TDNN_GLOB_c512 + ArcMargin 17,982 in 2 ranks x 64 rows
              against one process on the 128 (the parent's rows, dither 0,
              no spec-aug, no aug; rank 1's rows quiet in their first
              half), the one process taking its BatchNorm statistics as
              the ranks do (from the sums, through a group of one): f32
              (TF32 off) the loss within 1e-4, every BatchNorm running
              statistic element-wise within 1e-4 of max(1, its largest
              magnitude), every parameter after the step within 1e-4 of
              the same or twice what the one-process step moves it when
              the same rows come in another order, whichever is larger
              (~1e-4 on the H100 at LR 0.1), each layer's update at
              cosine >= 0.999; the f32 step with each rank's
              own BatchNorm statistics must miss that bar; bf16 the loss
              within 1e-3, each layer's error against the f32 step's
              update at most 1.1 x the one-process bf16 step's + 0.05
              (phase dino's bf16 bar), and cosine >= 0.999 in every
              layer where the control (the one-process step with the
              plain two-pass statistics, a change of f32 rounding only)
              stays at >= 0.9999; the control's cosines are printed.
              DINO, MoCo and SimCLR one f32 and one bf16 step each on the
              quality smoke's ECAPA_TDNN (C=256) in 2 ranks x 16 against
              one process on the global 32 (view-major), at the same
              bars; DINO's centre and MoCo's new queue rows at cosine >=
              0.999 and bit-identical over the ranks. parallel_args.model
              2 (data 1): 2 steps within 1e-3 of one process's losses, the
              checkpoint holding the whole head loads into a one-card
              model. NCCL in a world of one: an all_reduce and one step;
              two ranks over NCCL only where there are two cards, which
              the line says.
 52. deploy families  (last: torch.profiler on the card's machine sees
              fewer kernel records as a process ages, sooner after
              torch.export, and earlier phases gate on its counts) a .pt2
              of each family whose eval route holds rows 3 and 6-9
              (DEPLOY_FAMILIES, full width, seeded weights and BN from
              synthetic voices: campplus.yaml, gemini_dfresnet_adam.yaml at
              Gemini_DF_ResNet60's depth, resnet.yaml, redimnet.yaml and
              ecapa_tdnn_c512.yaml with fused: false, fused_res2: true),
              exported on the CPU (its seconds printed) and loaded on the
              card: at (64, 200) and (1, 137) in f32 its launches a call
              equal eager's and the table's (cam=3 masked=1; gemini=4
              masked=1; masked=1; softmax=1 masked=1; res2=3 softmax=1
              masked=1), its embeddings within 1e-4 of the largest
              magnitude of eager's, its ms against eager at B=64 (eager,
              .pt2, .pt2, eager); infer_demo on the CAM++ .pt2 against
              bin/extract.py (cosine >= 0.9999, cam=3 masked=1);
              torch.library.opcheck of the seven ops on the card at B=2,
              T=16 in f32 and bf16.
 53. http shards  (after recipe train, on its 8 shards and the aug
              stores) the shards served by a ThreadingHTTPServer on
              127.0.0.1 (loopback) and a shard list of their URLs: the
              first SpeakerDataset batch of ecapa_tdnn_c512.yaml's
              dataset_args from the URLs equal to the local list's at the
              same seed, then bin/train.py on ecapa_tdnn_c512.yaml (B=64,
              ArcMargin, host aug, one process) from the URL list for 3
              steps: rows 4 and 5 once a step and nothing else, every loss
              finite, the server's GET count and the phase's seconds.
Then the script's total seconds, one JSON line of per-kernel results and,
last, the result line. Any failure raises and exits non-zero; without a
GPU the script exits 1.
"""

import concurrent.futures
import contextlib
import copy
import functools
import http.server
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import scipy.linalg
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from wespeaker_tpu_torch.backend.embedding_processing import (  # noqa
    EmbeddingProcessingChain)
from wespeaker_tpu_torch.backend.plda import TwoCovPLDA, _llr  # noqa: E402
from wespeaker_tpu_torch.bin import train as train_cli  # noqa: E402
from wespeaker_tpu_torch.bin import (  # noqa: E402
    average_model as avg_cli, embd_proc as proc_cli, plda_tools as plda_cli)
from wespeaker_tpu_torch.bin import (  # noqa: E402
    compute_metrics as metrics_cli, extract as extract_cli,
    score as score_cli, smoke_quality)
from wespeaker_tpu_torch.bin import (  # noqa: E402
    train_contrastive as contrastive_cli)
from wespeaker_tpu_torch.bin import train_dino as dino_cli  # noqa: E402
from wespeaker_tpu_torch.bin import diarize as diarize_cli  # noqa: E402
from wespeaker_tpu_torch.bin import convert_repvgg  # noqa: E402
from wespeaker_tpu_torch.bin import (  # noqa: E402
    export_model, infer_demo, prep_data)
from wespeaker_tpu_torch import runtime_binding  # noqa: E402
from wespeaker_tpu_torch.export import fx_to_onnx, onnx_numpy  # noqa: E402
from wespeaker_tpu_torch.bin.extract import (  # noqa: E402
    fbank_config, iter_wavs_from_list, load_model_for_eval)
from wespeaker_tpu_torch.cli.speaker import Speaker  # noqa: E402
from wespeaker_tpu_torch.diar import pipeline as diar_pipe  # noqa: E402
from wespeaker_tpu_torch.diar import rttm as rttm_mod  # noqa: E402
from wespeaker_tpu_torch.diar import manifold as diar_manifold  # noqa
from wespeaker_tpu_torch.diar import (  # noqa: E402
    spectral_clusterer as spectral)
from wespeaker_tpu_torch.data.dataset import (  # noqa: E402
    SpeakerDataset, eval_batches)
from wespeaker_tpu_torch.data.pipeline import (  # noqa: E402
    attach_device_aug, augment_one, batch_samples, spk2id_from_utt2spk)
from wespeaker_tpu_torch.data.store import PackedAudioStore  # noqa: E402
from wespeaker_tpu_torch.bin import kernel_bounds  # noqa: E402
from wespeaker_tpu_torch.bin import profile_extract  # noqa: E402
from wespeaker_tpu_torch.bin.profile_train import (  # noqa: E402
    DINO_BATCH, DINO_OUT, dino_features, dino_step)
from wespeaker_tpu_torch.bin.kernel_bounds import (  # noqa: E402
    PEAK_F32_FLOPS, bound, cam_dense_block, inv_bottleneck_stage,
    masked_stats, softmax_stats)
from wespeaker_tpu_torch.bin.time_kernels import graph_ms  # noqa: E402
from wespeaker_tpu_torch.data.wav_io import read_wav, write_wav  # noqa: E402
from wespeaker_tpu_torch.frontend.fbank import (  # noqa: E402
    FbankConfig, compute_fbank)
from wespeaker_tpu_torch.models.campplus import CAMPPlus  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import (  # noqa: E402
    ECAPA_TDNN_GLOB_c512)
from wespeaker_tpu_torch.models.eres2net import ERes2Net34_Base  # noqa
from wespeaker_tpu_torch.models.redimnet2 import ReDimNet2B6  # noqa: E402
from wespeaker_tpu_torch.models.repvgg import REPVGG_TINY_A0  # noqa: E402
from wespeaker_tpu_torch.models.res2net import Res2Net34_Base  # noqa: E402
from wespeaker_tpu_torch.models.samresnet import (  # noqa: E402
    SimAM_ResNet34_ASP)
from wespeaker_tpu_torch.models.tdnn import XVEC  # noqa: E402
from wespeaker_tpu_torch.models.xi_vector import (  # noqa: E402
    XI_VEC_ECAPA_TDNN_c512)
from wespeaker_tpu_torch.models.gemini_dfresnet import (  # noqa: E402
    Gemini_DF_ResNet114, folded_stage)
from wespeaker_tpu_torch.models.pooling_layers import (  # noqa: E402
    set_pooling_fused)
from wespeaker_tpu_torch.models.projections import (  # noqa: E402
    ArcMarginProduct, get_projection)
from wespeaker_tpu_torch.models.redimnet import ReDimNetB2  # noqa: E402
from wespeaker_tpu_torch.models.resnet import ResNet34  # noqa: E402
from wespeaker_tpu_torch.ops import (_build, cam_block,  # noqa: E402
                                     conv_dw_pack, inv_bottleneck, mfa_astp,
                                     mfa_astp_vjp, pooling, res2_chain,
                                     se_block)
from wespeaker_tpu_torch.serving import EmbeddingServer  # noqa: E402
from wespeaker_tpu_torch.train import (AugConfig,  # noqa: E402
                                       build_train_state, make_eval_embed_fn,
                                       make_train_step)
from wespeaker_tpu_torch.train.composite import (  # noqa: E402
    build_model, featurizers)
from wespeaker_tpu_torch.train.device_aug import (  # noqa: E402
    device_augment)
from wespeaker_tpu_torch.train.train_step import (  # noqa: E402
    features_from_batch)
from wespeaker_tpu_torch.utils import checkpoint as ckpt_io  # noqa: E402
from wespeaker_tpu_torch.utils import hdf5  # noqa: E402
from wespeaker_tpu_torch.utils.config import (  # noqa: E402
    load_yaml, parse_config_or_kwargs)
from wespeaker_tpu_torch.utils.kaldi_io import (  # noqa: E402
    read_spk2emb, read_vec_scp_dict)
from wespeaker_tpu_torch.utils.schedulers import (  # noqa: E402
    ExponentialDecrease, MarginScheduler)
from wespeaker_tpu_torch.utils.weights import (  # noqa: E402
    to_jax_projection, to_jax_variables)

B, T, C = 512, 200, 512
SMOKE_C = 256  # ECAPA_TDNN of the quality smoke (bin/smoke_quality.py)
SLICE_BATCH = 64
CHUNK_SAMPLES = (200 - 1) * 160 + 400  # 32,240 samples: 200 frames
CHUNK_SECONDS = 2.0                     # counted as bench.py counts them
SEED = 0
# the train step of bench.py: ArcMargin over 5,994 VoxCeleb2 speakers x 3
# speed-perturb classes, SGD with momentum 0.9, at B=256
NUM_CLASS = 17982
TRAIN_BATCH = 256
TRAINER_BATCH = 32   # bin/train.py phase: 3 steps of it
B2 = "pool.linear2.bias"  # its exact gradient is 0: a softmax shift
SGD_CONF = {"optimizer": "SGD", "optimizer_args": {
    "momentum": 0.9, "nesterov": False, "weight_decay": 0.0}}
COUNTERS = {"se": se_block.fused_se_res2_block,
            "tail": mfa_astp.fused_mfa_astp,
            "train_fwd": mfa_astp_vjp.mfa_astp_train_fwd,
            "train_bwd": mfa_astp_vjp.mfa_astp_train_bwd,
            "cam": cam_block.fused_cam_dense_block,
            "gemini": inv_bottleneck.fused_inv_bottleneck_stage,
            "res2": res2_chain.fused_res2_chain,
            "dw": conv_dw_pack.dw_pack,
            "softmax": pooling.fused_softmax_stats,
            "masked": pooling.fused_masked_stats}
NO_LAUNCH = dict.fromkeys(COUNTERS, 0)
# CAMPPlus's dense blocks: (C0, layers, dilation); T' = 100 after the
# stride-2 TDNN at 200 frames
CAM_BLOCKS = ((128, 12, 1), (256, 24, 2), (512, 16, 2))
CAM_T = 100
CAM_EMBED = 512
# Gemini_DF_ResNet114 (gemini_dfresnet_adam.yaml: feat 80, embed 256, TSTP):
# its stages at 200 frames, (F, T, C, blocks)
GEMINI_EMBED = 256
GEMINI_STAGES = ((40, 200, 32, 3), (20, 100, 64, 3), (10, 100, 128, 27),
                 (5, 100, 256, 3))
# (B, F, T', C) at the edges of the bf16 stage kernel's tile plan: B = 1;
# F = 1; T' = 1; the served T' = 49; T' not a multiple of the tile and over
# two tiles (12-frame tiles: 61 frames at C = 32, 37 at C = 128); F = 3 at
# C = 32; C = 256 at F = 5 and T' = 7
GEMINI_EDGES = ((1, 10, 100, 128), (2, 1, 37, 32), (2, 20, 1, 64),
                (2, 10, 49, 128), (2, 5, 49, 256), (2, 10, 37, 128),
                (2, 40, 61, 32), (2, 3, 50, 32), (2, 5, 7, 256))
GEMINI_YAML = ("model: Gemini_DF_ResNet114\nmodel_args:\n  feat_dim: 80\n"
               f"  embed_dim: {GEMINI_EMBED}\n  pooling_func: TSTP\n"
               "  two_emb_layer: false\ndataset_args:\n  fbank_args:\n"
               "    num_mel_bins: 80\n")
# ResNet34 (resnet.yaml: feat 80, embed 256, TSTP, B=128, SGD with nesterov
# momentum 0.9 and weight decay 1e-4, no spec-aug); its packed dW shapes at
# 200 frames, (H, W, Ci, Co, calls per train step): the stem, layer1's six
# 3x3 convs, layer2's seven stride-1 ones (layer2.0.conv1 has stride 2)
RESNET_EMBED = 256
RESNET_BATCH = 128
RESNET_DW = ((80, 200, 1, 32, 1), (80, 200, 32, 32, 6), (40, 100, 64, 64, 7))
# (B, H, W, Ci, Co) at the edges of dw_pack's kernels: a position chunk of
# one, of 17 and wider than one chunk (250); H = 1; B*H below the SM count
DW_EDGES = ((2, 9, 1, 1, 32), (2, 9, 17, 8, 24), (2, 9, 250, 48, 48),
            (1, 1, 250, 64, 64), (3, 5, 17, 64, 64), (2, 1, 17, 1, 32),
            (4, 7, 250, 8, 24), (2, 3, 1, 48, 48))
TIMING_REPS = 3  # kernel and library timed in turns; median and spread
DW_PER_STEP = sum(n for *_, n in RESNET_DW)
RESNET_YAML = ("model: ResNet34\nmodel_args:\n  feat_dim: 80\n"
               f"  embed_dim: {RESNET_EMBED}\n  pooling_func: TSTP\n"
               "  two_emb_layer: false\ndataset_args:\n  fbank_args:\n"
               "    num_mel_bins: 80\n")
RESNET_SGD = {"optimizer": "SGD", "optimizer_args": {
    "momentum": 0.9, "nesterov": True, "weight_decay": 1e-4}}
# ReDimNetB2 (redimnet.yaml: feat 72 from a 72-bin fbank, embed 192, ASTP
# with global context over D = 16 * 72 = 1152)
REDIM_FEAT, REDIM_EMBED, REDIM_D = 72, 192, 1152
REDIM_FBANK = FbankConfig(num_mel_bins=REDIM_FEAT)
REDIM_YAML = ("model: ReDimNetB2\nmodel_args:\n  feat_dim: 72\n"
              f"  embed_dim: {REDIM_EMBED}\n  pooling_func: ASTP\n"
              "  two_emb_layer: false\ndataset_args:\n  fbank_args:\n"
              "    num_mel_bins: 72\n")
RESNET_TSTP = (25, 2560)  # ResNet34's pooled (T', D) at 200 frames


def zero_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in COUNTERS.items()}


def cosine(a, b):
    """In float64: over millions of elements an f32 sum of squares is off
    by more than the 1e-4 being tested."""
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def row_cosines(a, b):
    a, b = a.double(), b.double()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))


def random_model(dev):
    """ECAPA_TDNN_GLOB_c512 with torch's default init from SEED and BN
    statistics and affines randomised from a generator."""
    torch.manual_seed(SEED)
    model = ECAPA_TDNN_GLOB_c512(80, 192)
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return model.to(dev).eval()


def ragged_mask(rng, b, t, dev):
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    return torch.as_tensor((np.arange(t)[None] < lens[:, None]).astype(
        np.float32), device=dev)


def se_inputs(model, rng, b, t, dtype, dev):
    pre, res2, post, se = model.layer3.se_res2block
    x = torch.as_tensor(rng.standard_normal((b, t, C)).astype(np.float32),
                        device=dev).to(dtype)
    weights = (*pre.folded(), *res2.folded(), *post.folded(), *se.folded())
    return x, [w.detach() for w in weights], model.layer3.dilation


def tail_inputs(model, rng, b, t, dtype, dev, c=C, glob=True):
    """x2, x3, x4 (B, T, c) and the tail's weights: the model's, or at
    another width c a random MFA conv (3c -> 1536) with the model's
    pooling weights. Without the global context, attention's first conv
    takes the rows of the model's that act on the frames (1536 -> 128)."""
    xs = [torch.as_tensor(rng.standard_normal((b, t, c)).astype(np.float32),
                          device=dev).to(dtype) for _ in range(3)]
    p = model.pool
    wm, bm = model.conv.weight[:, :, 0].t(), model.conv.bias
    if c != C:
        d = wm.shape[1]
        wm = torch.as_tensor(rng.standard_normal((d, 3 * c)).astype(
            np.float32) * (3 * c) ** -0.5, device=dev).t()
    k1 = p.linear1.weight[:, :, 0].t()
    if not glob:
        k1 = k1[:wm.shape[1]].contiguous()
    weights = (wm, bm, k1, p.linear1.bias,
               p.linear2.weight[:, :, 0].t(), p.linear2.bias)
    return xs, [w.detach() for w in weights]


def compare(got, want, dtype):
    """max abs error and cosine; raises outside the stated tolerance."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    cos = cosine(got, want)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    elif cos < 0.9999:
        raise AssertionError(f"cosine {cos} < 0.9999")
    return err, cos


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    for name in _build.KERNELS:
        _build.load(name)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(_build.BUILD_DIR, "nvcc.log"), "w") as f:
        f.write("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__} cuda "
          f"{torch.version.cuda}; built {sorted(logs) or 'nothing new'} in "
          f"{build_s:.1f} s")
    return smi


def phase_kernels(model, dev):
    rng = np.random.default_rng(SEED)
    errs, parts = {}, []
    # the edge: B*T = 111, no multiple of the GEMM's 128-row tile, masked;
    # the tail also at C=1024 (three A maps of 1024 columns) and at C=256
    # without the global context (the quality smoke's ECAPA_TDNN) in both
    # types and at the edge, and once with it
    for dtype, t, masked, b, c, glob in (
            (torch.bfloat16, T, False, SLICE_BATCH, C, True),
            (torch.float32, 198, True, SLICE_BATCH, C, True),
            (torch.bfloat16, 37, True, 3, C, True),
            (torch.bfloat16, 37, True, 3, 1024, True),
            (torch.bfloat16, T, False, SLICE_BATCH, SMOKE_C, False),
            (torch.float32, 198, True, SLICE_BATCH, SMOKE_C, False),
            (torch.bfloat16, 37, True, 3, SMOKE_C, False),
            (torch.bfloat16, T, False, SLICE_BATCH, SMOKE_C, True)):
        mask = ragged_mask(rng, b, t, dev) if masked else None
        if c == C:
            x, w, dil = se_inputs(model, rng, b, t, dtype, dev)
            got = se_block.fused_se_res2_block(x, *w, dilation=dil,
                                               mask=mask)
            torch.cuda.synchronize()
            want = se_block.se_res2_block_reference(x, *w, dilation=dil,
                                                    mask=mask)
            err, cos = compare(got, want, dtype)
            errs.setdefault("se", err)
            parts.append(f"se_res2_block {str(dtype)[6:]} B={b} T={t} "
                         f"{'masked' if masked else 'unmasked'} "
                         f"max_abs_err={err:.3g} cos={cos:.7f}")
        xs, tw = tail_inputs(model, rng, b, t, dtype, dev, c, glob)
        got = mfa_astp.fused_mfa_astp(*xs, *tw, mask=mask, glob=glob)
        torch.cuda.synchronize()
        want = mfa_astp.mfa_astp_reference(*xs, *tw, mask=mask, glob=glob)
        err, cos = compare(got, want, dtype)
        errs.setdefault("tail", err)
        parts.append(f"mfa_astp {str(dtype)[6:]} B={b} T={t} C={c} "
                     f"{'glob ' if glob else 'no-glob '}"
                     f"{'masked' if masked else 'unmasked'} "
                     f"max_abs_err={err:.3g} cos={cos:.7f}")
    print("kernels: " + "; ".join(parts))
    return errs


def phase_slice(model, dev):
    rng = np.random.default_rng(SEED + 1)
    wav = torch.as_tensor(rng.uniform(-0.5, 0.5, (SLICE_BATCH, CHUNK_SAMPLES))
                          .astype(np.float32), device=dev)
    embed = make_eval_embed_fn(model, FbankConfig(),
                               compute_dtype=torch.bfloat16,
                               fbank_conv_dtype=torch.bfloat16, device=dev)
    zero_counts()
    emb = embed({"wav": wav})
    torch.cuda.synchronize()
    launches = counts()
    if launches != dict(NO_LAUNCH, se=3, tail=1):
        raise AssertionError(f"main path launches {launches}, want SE 3 "
                             "and tail 1 per forward, no train kernel")
    assert emb.shape == (SLICE_BATCH, 192) and torch.isfinite(emb).all()
    plain = make_eval_embed_fn(set_pooling_fused(model.set_fused(False),
                                                 False), FbankConfig(),
                               compute_dtype=torch.bfloat16,
                               fbank_conv_dtype=torch.bfloat16,
                               device=dev)({"wav": wav})
    f32 = make_eval_embed_fn(model, FbankConfig(), device=dev)({"wav": wav})
    set_pooling_fused(model.set_fused(True), None)
    cos = row_cosines(emb, plain).min().item()
    cos32 = row_cosines(emb, f32).min().item()
    if cos < 0.9999:
        raise AssertionError(f"kernel path vs plain path cosine {cos}")
    print(f"slice: ECAPA_TDNN_GLOB_c512 bf16 B={SLICE_BATCH} x "
          f"{CHUNK_SAMPLES} samples -> {tuple(emb.shape)}; launches "
          f"se={launches['se']} tail={launches['tail']}; min cosine vs "
          f"plain bf16 path {cos:.7f}, vs plain f32 path {cos32:.7f}")
    return launches


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def phase_serving(model, dev):
    rng = np.random.default_rng(SEED + 2)
    wavs = [rng.uniform(-0.5, 0.5, n).astype(np.float32)
            for n in (16000, 20800, 27200, 35200, 41600, 48000)]
    config = {"model": "ECAPA_TDNN_GLOB_c512",
              "model_args": {"feat_dim": 80, "embed_dim": 192}}
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "model.pt")
        torch.save(model.state_dict(), ckpt)
        server = EmbeddingServer(config, ckpt, port=0, max_batch=8,
                                 max_wait_ms=50, device=dev).start()
        try:
            url = f"http://127.0.0.1:{server.port}"
            with urllib.request.urlopen(f"{url}/health", timeout=60) as r:
                assert json.load(r)["status"] == "ok"
            zero_counts()
            with concurrent.futures.ThreadPoolExecutor(len(wavs)) as ex:
                replies = list(ex.map(
                    lambda w: _post(f"{url}/embed", {"wav": w.tolist(),
                                                     "sample_rate": 16000}),
                    wavs))
            sim = _post(f"{url}/similarity",
                        {"wav1": wavs[0].tolist(), "wav2": wavs[3].tolist()})
            launches = counts()
        finally:
            server.close()
    if min(launches["se"], launches["tail"]) < 1:
        raise AssertionError(f"serving did not reach the kernels: {launches}")
    single = make_eval_embed_fn(model, FbankConfig(), device=dev)
    cos, refs = [], []
    for w, rep in zip(wavs, replies):
        ref = single({"wav": w[None]})[0].cpu()
        refs.append(ref)
        cos.append(cosine(torch.tensor(rep["embedding"]), ref))
    if min(cos) < 0.9999:
        raise AssertionError(f"served replies vs batch=1: {cos}")
    want_sim = (cosine(refs[0], refs[3]) + 1) / 2
    if abs(sim["similarity"] - want_sim) > 1e-3:
        raise AssertionError(f"similarity {sim} vs {want_sim}")
    print(f"serving: {len(wavs)} concurrent /embed (1-3 s) + /similarity; "
          f"launches se={launches['se']} tail={launches['tail']}; min "
          f"cosine vs batch=1 {min(cos):.7f}; similarity "
          f"{sim['similarity']:.6f} (batch=1 {want_sim:.6f})")


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, library, reps=TIMING_REPS):
    """kernel and library timed `reps` times each in turns (kernel,
    library, kernel, ...) with graph_ms; -> ((median, spread) of the
    kernel's, (median, spread) of the library's), spread = max - min."""
    ks, ls = [], []
    for _ in range(reps):
        ks.append(graph_ms(kernel))
        ls.append(graph_ms(library))
    return tuple((float(np.median(v)), max(v) - min(v)) for v in (ks, ls))


def _nbytes(tensors, io):
    """Bytes of the operands as the kernel reads them: activations and
    matrices in the io type, biases and affines in f32."""
    return sum(v.numel() * (io.itemsize if v.dim() >= 2 else 4)
               for v in tensors)


def phase_timing(model, dev, smi):
    rng = np.random.default_rng(SEED + 3)
    io = torch.bfloat16
    m = B * T
    x, w, dil = se_inputs(model, rng, B, T, io, dev)
    width, nums = C // 8, 7
    se_flops = (2 * 2 * m * C * C + 2 * nums * m * 3 * width * width
                + 2 * 2 * B * C * 128)
    se_bytes = 2 * x.numel() * io.itemsize + _nbytes(w, io)
    res = {"se": {"ms": cuda_ms(lambda: se_block.fused_se_res2_block(
        x, *w, dilation=dil)),
        "plain_ms": cuda_ms(lambda: se_block.se_res2_block_reference(
            x, *w, dilation=dil), iters=5)}}
    res["se"]["bound_ms"], res["se"]["bound_by"] = bound(se_flops, se_bytes)
    # the port's kernels one call launches (torch.profiler): 7 in both types
    se_launches = count_launches(lambda: se_block.fused_se_res2_block(
        x, *w, dilation=dil), "ws::")[0]
    del x
    xs, tw = tail_inputs(model, rng, B, T, io, dev)
    res["tail"] = {"ms": cuda_ms(lambda: mfa_astp.fused_mfa_astp(
        *xs, *tw, glob=True)),
        "plain_ms": cuda_ms(lambda: mfa_astp.mfa_astp_reference(
            *xs, *tw, glob=True), iters=5)}
    res["tail"]["bound_ms"], res["tail"]["bound_by"] = bound(
        *kernel_bounds.mfa_astp_tail(B, T, C))
    tail_floor = sum(ms for _, ms, _ in kernel_bounds.mfa_astp_tail_floor(
        B, T, C))
    # the tail's launches a call (torch.profiler, printed), and those on
    # gemm_sm90 (the MFA, context, tanh and logits products) and on the
    # WMMA GEMM (none), as the library counts them
    tail_call = lambda: mfa_astp.fused_mfa_astp(  # noqa: E731
        *xs, *tw, glob=True)
    tail_all = count_launches(tail_call, "ws::")[1]
    routes = routes_launched("mfa_astp", tail_call)
    tail_sm90, tail_wmma = routes["gemm_sm90"], routes["wmma"]
    if (tail_sm90, tail_wmma) != (4, 0):
        raise AssertionError(f"the bf16 tail launched gemm_sm90 {tail_sm90} "
                             f"times and the WMMA GEMM {tail_wmma}, not 4 "
                             "and 0")
    del xs
    wav = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, CHUNK_SAMPLES)).astype(
        np.float32), device=dev)
    rates = {}
    for path, fused in (("kernel", True), ("plain", False)):
        embed = make_eval_embed_fn(set_pooling_fused(model.set_fused(fused),
                                                     fused), FbankConfig(),
                                   compute_dtype=io, fbank_conv_dtype=io,
                                   device=dev)
        ms = cuda_ms(lambda: embed({"wav": wav}), iters=5, warmup=2)
        rates[path] = (B * CHUNK_SECONDS / (ms / 1e3), ms)
    set_pooling_fused(model.set_fused(True), None)
    fmt = "; ".join(
        f"{k} {v['ms']:.3f} ms (plain {v['plain_ms']:.3f}, bound "
        f"{v['bound_ms']:.3f} by {v['bound_by']})" for k, v in res.items())
    print(f"timing [{smi}] B={B} T={T} C={C} bf16: {fmt}; tail floor of "
          f"its chain {tail_floor:.3f} ms, {tail_all} kernel launches a "
          f"call ({tail_sm90} gemm_sm90, {tail_wmma} WMMA); se_res2_block "
          f"{se_launches} kernel launches a call, {3 * se_launches} a "
          f"forward (3 calls); extraction "
          f"kernel path {rates['kernel'][0]:.1f} audio-s/s "
          f"({rates['kernel'][1]:.2f} ms/batch), plain path "
          f"{rates['plain'][0]:.1f} audio-s/s ({rates['plain'][1]:.2f} "
          f"ms/batch)")
    return res


def scaled_compare(got, want, dtype, cos_min=0.9999):
    """A gradient against its plain version: f32 scaled by the plain
    one's largest magnitude at rtol/atol 1e-4 (sums over B*T rows in
    another order), bf16 by cosine >= cos_min. Returns (max abs error,
    cosine); raises outside the tolerance."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    cos = cosine(got, want)
    if dtype == torch.float32:
        scale = max(want.abs().max().item(), 1e-3)
        torch.testing.assert_close(got.float() / scale, want.float() / scale,
                                   rtol=1e-4, atol=1e-4)
    elif cos < cos_min:
        raise AssertionError(f"cosine {cos} < {cos_min}")
    return err, cos


FWD_NAMES = ("pooled", "h", "att", "cstats")
GRAD_NAMES = ("dx2", "dx3", "dx4", "dwm", "dbm", "dk1", "db1", "dk2")


def phase_train_kernels(model, dev):
    """The training tail's forward and backward kernels against their
    plain versions at B=64, C=512: bf16 at T=200 and f32 at T=198; bf16
    at the WavLM + ECAPA recipes' shapes (3 s of 20 ms frames, T=149, at
    B=256 and, for 6 s, T=299 at B=64); bf16 at C=1024 (a random MFA
    conv), B=3, T=37; and at C=256 (the quality
    smoke's width, a random MFA conv), B=64, T=200, bf16 and f32, each
    without the global context (the smoke's ECAPA_TDNN) and with it. The
    backward takes the plain forward's residuals, so both sides see the
    same relu mask, and is also held against autograd through the plain
    forward: at the same bars, but db1 in bf16 at cosine >= 0.99, since
    autograd rounds datt to bf16 where the kernels (and the JAX kernel)
    keep it in f32, and db1, a sum of dpre over B*T with cancellation,
    shows it (0.998 at B=2 on the CPU, every other gradient >= 0.99999)."""
    rng = np.random.default_rng(SEED + 4)
    errs, parts = {}, []
    for dtype, t, b, c, glob in (
            (torch.bfloat16, T, SLICE_BATCH, C, True),
            (torch.float32, 198, SLICE_BATCH, C, True),
            (torch.bfloat16, 149, 256, C, True),
            (torch.bfloat16, 299, SLICE_BATCH, C, True),
            (torch.bfloat16, 37, 3, 1024, True),
            (torch.bfloat16, T, SLICE_BATCH, SMOKE_C, False),
            (torch.float32, T, SLICE_BATCH, SMOKE_C, False),
            (torch.bfloat16, T, SLICE_BATCH, SMOKE_C, True),
            (torch.float32, T, SLICE_BATCH, SMOKE_C, True)):
        xs, tw = tail_inputs(model, rng, b, t, dtype, dev, c, glob)
        wm, bm, k1, b1, k2, b2 = tw
        got = mfa_astp_vjp.mfa_astp_train_fwd(*xs, *tw, glob=glob)
        torch.cuda.synchronize()
        want = mfa_astp_vjp.mfa_astp_train_fwd_reference(*xs, *tw, glob=glob)
        fwd = []
        for n, gv, wv in zip(FWD_NAMES, got, want):
            if n == "cstats" and not glob:  # no context: zeros on both
                if gv.shape != wv.shape or gv.any() or wv.any():
                    raise AssertionError("cstats without glob is not zero")
                fwd.append((0.0, 1.0))
            else:
                fwd.append(compare(gv, wv, dtype))
        errs.setdefault("train_fwd", max(e for e, _ in fwd))
        parts.append(f"train fwd {str(dtype)[6:]} B={b} T={t} C={c} "
                     f"{'glob ' if glob else 'no-glob '}"
                     + " ".join(f"{n}(err={e:.3g} cos={c_:.7f})"
                                for n, (e, c_) in zip(FWD_NAMES, fwd)))
        g = torch.as_tensor(rng.standard_normal((b, 3072)).astype(
            np.float32), device=dev)
        pooled, h, att, cstats = want
        res = (*xs, wm, k1, b2, k2, pooled, h, att, cstats, g)
        grads = mfa_astp_vjp.mfa_astp_train_bwd(*res, glob=glob)
        torch.cuda.synchronize()
        if grads[-1].abs().max().item() != 0.0:
            raise AssertionError("db2 is not exactly zero")
        plain = mfa_astp_vjp.mfa_astp_train_bwd_reference(*res, glob=glob)
        bwd = [scaled_compare(gv, wv, dtype)
               for gv, wv in zip(grads[:-1], plain[:-1])]
        ins = [v.clone().requires_grad_(True) for v in (*xs, *tw)]
        out = mfa_astp_vjp.mfa_astp_train_reference(*ins, glob=glob)
        auto = torch.autograd.grad((out * g).sum(), ins)
        vs_auto = [scaled_compare(gv, av.to(gv.dtype), dtype,
                                  0.99 if n == "db1" else 0.9999)
                   for n, gv, av in zip(GRAD_NAMES, grads[:-1], auto[:-1])]
        errs.setdefault("train_bwd", max(e for e, _ in bwd))
        parts.append(f"train bwd {str(dtype)[6:]} B={b} T={t} C={c} "
                     f"{'glob ' if glob else 'no-glob '}db2=0 "
                     + " ".join(
            f"{n}(err={e:.3g} cos={c_:.7f} autograd cos={ca:.7f})"
            for n, (e, c_), (_, ca) in zip(GRAD_NAMES, bwd, vs_auto)))
        del xs, got, want, grads, plain, ins, out, auto
    print("train kernels: " + "; ".join(parts))
    return errs


def train_modules(dev):
    """Full-width ECAPA_TDNN_GLOB_c512 and an ArcMargin head over
    NUM_CLASS classes, torch's default init from SEED, with SGD."""
    return build_train_state(
        lambda: (ECAPA_TDNN_GLOB_c512(80, 192),
                 ArcMarginProduct(192, NUM_CLASS)),
        SGD_CONF, seed=SEED, device=dev)


def bench_schedules(batch):
    """bench.py's LR and margin schedules (VoxCeleb2 epoch length)."""
    epoch_iter = 1092009 // batch
    return (ExponentialDecrease(150, epoch_iter, 0.1, 5e-5, warm_up_epoch=6),
            MarginScheduler(epoch_iter, 20, 40, 0.0, 0.2))


def train_batch(rng, b, dev):
    return {"wav": torch.as_tensor(rng.uniform(
        -0.5, 0.5, (b, CHUNK_SAMPLES)).astype(np.float32), device=dev),
        "label": torch.as_tensor(rng.integers(0, NUM_CLASS, b), device=dev)}


def phase_train_step(dev):
    """A few bf16 AMP train steps with dither and spec-aug on the kernel
    path, one launch of each train kernel per step and none of the
    inference kernels; then one step of each path from the same initial
    weights without randomness, the updates compared layer by layer."""
    model, proj, opt, gen = train_modules(dev)
    rng = np.random.default_rng(SEED + 5)
    batch = train_batch(rng, SLICE_BATCH, dev)
    lr_fn, margin_fn = (lambda s: 0.1), (lambda s: 0.2)
    step = make_train_step(model, proj, opt, lr_fn, margin_fn,
                           FbankConfig(dither=1.0), AugConfig(),
                           compute_dtype=torch.bfloat16, device=dev,
                           generator=gen)
    losses = []
    zero_counts()
    for i in range(3):
        losses.append(float(step(batch)["loss"]))
        want = dict(NO_LAUNCH, train_fwd=i + 1, train_bwd=i + 1)
        if counts() != want:
            raise AssertionError(f"after step {i}: launches {counts()}, "
                                 f"want {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")

    del model, proj, opt, step
    # from the seeded initial weights again, once per path and type
    parts, bad = [], []
    for dtype in (torch.bfloat16, torch.float32):
        rel, worst, per_tensor = compare_train_paths(dev, batch, lr_fn,
                                                     margin_fn, dtype)
        parts.append(
            f"{str(dtype)[6:]}: loss rel {rel:.2e}, update cosine per layer "
            "lowest " + ", ".join(f"{n} {c:.6f}" for n, c in worst)
            + f" (per tensor lowest {per_tensor[1]} {per_tensor[0]:.6f})")
        if rel > 1e-3 or worst[0][1] < 0.999:
            bad.append(str(dtype))
    print(f"train step: ECAPA_TDNN_GLOB_c512 + ArcMargin {NUM_CLASS} bf16 "
          f"B={SLICE_BATCH}, dither 1 + spec-aug: losses "
          f"{[round(v, 4) for v in losses]}, launches per step train_fwd=1 "
          f"train_bwd=1 se=0 tail=0; one step of each path from the same "
          "weights without randomness, kernel vs plain (bars 1e-3 and "
          "0.999): " + "; ".join(parts))
    if bad:
        raise AssertionError(f"kernel and plain train steps disagree in "
                             f"{bad}")


def compare_train_paths(dev, batch, lr_fn, margin_fn, dtype):
    """One step of the kernel path and one of the plain path from the
    seeded initial weights, dither 0 and spec-aug off. Returns the loss's
    relative difference, the three lowest update cosines per layer (a
    module's parameters as one vector) and the lowest per tensor. b2's
    update must be exactly zero on the kernel path (its gradient is 0) and
    is left out of the cosines."""
    updates, loss = {}, {}
    for fused in (True, False):
        model, proj, opt, _ = train_modules(dev)
        model.set_fused(fused)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        one = make_train_step(model, proj, opt, lr_fn, margin_fn,
                              FbankConfig(dither=0.0),
                              AugConfig(spec_aug=False),
                              compute_dtype=dtype, device=dev)
        loss[fused] = float(one(batch)["loss"])
        updates[fused] = {n: (p.detach() - start[n]).float()
                          for n, p in model.named_parameters()}
        del model, proj, opt, one
    if updates[True].pop(B2).abs().max().item() != 0.0:
        raise AssertionError("kernel path: b2 moved; its gradient is 0")
    updates[False].pop(B2)
    layers = {}
    for n in updates[True]:
        layers.setdefault(n.rsplit(".", 1)[0], []).append(n)
    cos = {k: cosine(torch.cat([updates[True][n].flatten() for n in ns]),
                     torch.cat([updates[False][n].flatten() for n in ns]))
           for k, ns in layers.items()}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    per_tensor = min((cosine(updates[True][n], updates[False][n]), n)
                     for n in updates[True])
    return abs(loss[True] - loss[False]) / abs(loss[False]), worst, per_tensor


def write_corpus(root, rng, n_spk=12, n_utt=4):
    """PCM16 wavs of 2.5-4 s (a tone per speaker plus noise), a jsonl raw
    list and utt2spk."""
    lines, u2s = [], []
    for s in range(n_spk):
        tone = 2 * np.pi * (150 + 40 * s) / 16000
        for u in range(n_utt):
            key = f"spk{s:02d}-utt{u}"
            n = int(rng.uniform(2.5, 4.0) * 16000)
            wav = (0.3 * np.sin(tone * np.arange(n))
                   + rng.uniform(-0.1, 0.1, n)).astype(np.float32)
            path = os.path.join(root, f"{key}.wav")
            write_wav(path, wav, 16000)
            lines.append(json.dumps({"key": key, "wav": path,
                                     "spk": f"spk{s:02d}"}))
            u2s.append(f"{key} spk{s:02d}")
    for name, rows in (("raw.list", lines), ("utt2spk", u2s)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    return os.path.join(root, "raw.list"), os.path.join(root, "utt2spk")


def phase_trainer(dev):
    """bin/train.py at full width on a synthetic corpus: bf16 AMP, batch
    TRAINER_BATCH, 200 frames, speed perturb, one epoch of 3 steps; then
    the extractor loads its checkpoint and embeds one utterance."""
    import yaml

    rng = np.random.default_rng(SEED + 6)
    with tempfile.TemporaryDirectory() as d:
        raw, utt2spk = write_corpus(d, rng)
        conf = {
            "exp_dir": os.path.join(d, "exp"), "train_data": raw,
            "utt2spk": utt2spk, "data_type": "raw", "num_epochs": 1,
            "samples_per_epoch": 3 * TRAINER_BATCH, "seed": SEED,
            "log_batch_interval": 1,
            "enable_amp": True, "model": "ECAPA_TDNN_GLOB_c512",
            "model_args": {"feat_dim": 80, "embed_dim": 192},
            "projection_args": {"project_type": "arc_margin"},
            "dataset_args": {"batch_size": TRAINER_BATCH, "num_frms": 200,
                             "fbank_args": {"num_mel_bins": 80},
                             "speed_perturb": True, "spec_aug": True},
            "scheduler_args": {"initial_lr": 0.1, "final_lr": 0.01,
                               "warm_up_epoch": 0}}
        path = os.path.join(d, "conf.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(conf, f)
        zero_counts()
        t0 = time.perf_counter()
        step = train_cli.train(path, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = counts()
        want = dict(NO_LAUNCH, train_fwd=3, train_bwd=3)
        if launches != want or step.step != 3:
            raise AssertionError(f"trainer: {step.step} steps, launches "
                                 f"{launches}, want 3 and {want}")
        exp = os.path.join(d, "exp")
        with open(os.path.join(exp, "train.log")) as f:
            log = f.read()
        last = [ln for ln in log.splitlines() if "it 2/3 loss" in ln]
        if not last:
            raise AssertionError(f"trainer log: {log}")
        final = os.path.join(exp, "models", "final_model.pt")
        if os.readlink(final) != "model_0.pt":
            raise AssertionError("final_model.pt does not link model_0.pt")
        configs = load_yaml(os.path.join(exp, "config.yaml"))
        loaded = load_model_for_eval(configs, final, device=dev)
        for k, v in step.model.state_dict().items():
            if not torch.equal(loaded.state_dict()[k], v):
                raise AssertionError(f"checkpoint differs from the trained "
                                     f"model at {k}")
        wav = np.random.default_rng(SEED + 7).uniform(
            -0.5, 0.5, (1, 48000)).astype(np.float32)
        emb = make_eval_embed_fn(loaded, FbankConfig(), device=dev)(
            {"wav": wav})
    if emb.shape != (1, 192) or not torch.isfinite(emb).all():
        raise AssertionError(f"embedding {emb}")
    print(f"trainer: bin/train.py ECAPA_TDNN_GLOB_c512 bf16 batch "
          f"{TRAINER_BATCH} x 200 frames, 48 utterances of 12 speakers (36 "
          f"classes with speed perturb), 3 steps in {train_s:.1f} s; launches "
          f"train_fwd={launches['train_fwd']} "
          f"train_bwd={launches['train_bwd']}; log "
          f"'{last[0].split(' ', 3)[3]}'; model_0.pt served a (1, 192) "
          f"embedding, norm {emb.norm().item():.4f}")
    return launches


def phase_train_timing(model, dev, smi):
    """At B=256, T=200, C=512, bf16: the backward kernels against their
    plain version on the same residuals (each of the eight gradients at
    cosine >= 0.9999, db2 exactly zero), since the weight-gradient launch
    splits K by the shape (7 splits here, 3 at B=64); CUDA events after
    warm-up for the train kernels and their plain versions with bounds;
    then the train step of
    bench.py (B=256, 2 s chunks, bf16, dither, spec-aug, ArcMargin 17,982,
    SGD) on the kernel path and the plain path, host clock around 5 steps
    that end in a synchronize."""
    rng = np.random.default_rng(SEED + 8)
    io, b = torch.bfloat16, TRAIN_BATCH
    m, d, a = b * T, 1536, 128
    xs, tw = tail_inputs(model, rng, b, T, io, dev)
    wm, bm, k1, b1, k2, b2 = tw
    g = torch.as_tensor(rng.standard_normal((b, 2 * d)).astype(np.float32),
                        device=dev)
    pooled, h, att, cstats = mfa_astp_vjp.mfa_astp_train_fwd(*xs, *tw)
    res = (*xs, wm, k1, b2, k2, pooled, h, att, cstats, g)
    grads = mfa_astp_vjp.mfa_astp_train_bwd(*res)
    torch.cuda.synchronize()
    if grads[-1].abs().max().item() != 0.0:
        raise AssertionError(f"db2 is not exactly zero at B={b}")
    plain = mfa_astp_vjp.mfa_astp_train_bwd_reference(*res)
    bwd = [scaled_compare(gv, wv, io)
           for gv, wv in zip(grads[:-1], plain[:-1])]
    errs = {"train_bwd": max(e for e, _ in bwd)}
    print(f"train bwd bf16 B={b} T={T} C={C} against its plain version: "
          "db2=0 " + " ".join(f"{n}(err={e:.3g} cos={c_:.7f})"
                              for n, (e, c_) in zip(GRAD_NAMES, bwd)))
    del grads, plain
    fwd_flops, fwd_bytes = kernel_bounds.mfa_astp_tail(b, T, C, train=True)
    bwd_flops, bwd_bytes = kernel_bounds.mfa_astp_tail_bwd(b, T, C)
    res_t = {
        "train_fwd": {
            "ms": cuda_ms(lambda: mfa_astp_vjp.mfa_astp_train_fwd(*xs, *tw)),
            "plain_ms": cuda_ms(
                lambda: mfa_astp_vjp.mfa_astp_train_fwd_reference(*xs, *tw),
                iters=5)},
        "train_bwd": {
            "ms": cuda_ms(lambda: mfa_astp_vjp.mfa_astp_train_bwd(*res)),
            "plain_ms": cuda_ms(
                lambda: mfa_astp_vjp.mfa_astp_train_bwd_reference(*res),
                iters=3, warmup=1)}}
    for k, (fl, nb) in (("train_fwd", (fwd_flops, fwd_bytes)),
                        ("train_bwd", (bwd_flops, bwd_bytes))):
        res_t[k]["bound_ms"], res_t[k]["bound_by"] = bound(fl, nb)
    bwd_floor = sum(ms for _, ms, _ in kernel_bounds.mfa_astp_tail_bwd_floor(
        b, T, C))
    # a bf16 backward call's launches (torch.profiler, printed), and as the
    # library counts them: the logits, dpre, dcms, dacc and dx products on
    # gemm_sm90, the three weight gradients in one gemm_tn_sm90 launch, and
    # nothing on the WMMA or FMA GEMMs
    bwd_call = lambda: mfa_astp_vjp.mfa_astp_train_bwd(*res)  # noqa: E731
    bwd_all = count_launches(bwd_call, "ws::")[1]
    routes = routes_launched("mfa_astp_train", bwd_call)
    bwd_sm90, bwd_tn = routes["gemm_sm90"], routes["gemm_tn_sm90"]
    bwd_old = routes["wmma"] + routes["fma"]
    if (bwd_sm90, bwd_tn, bwd_old) != (5, 1, 0):
        raise AssertionError(f"the bf16 backward launched gemm_sm90 "
                             f"{bwd_sm90}, gemm_tn_sm90 {bwd_tn} and the "
                             f"WMMA/FMA GEMMs {bwd_old} times, not 5, 1, 0")
    del xs, tw, res, pooled, h, att, cstats, g

    lr_fn, margin_fn = bench_schedules(b)
    batch = train_batch(rng, b, dev)
    rates = {}
    for path, fused in (("kernel", True), ("plain", False)):
        tm, tp, opt, gen = train_modules(dev)
        step = make_train_step(tm.set_fused(fused), tp, opt, lr_fn,
                               margin_fn, FbankConfig(dither=1.0),
                               AugConfig(), compute_dtype=io, device=dev,
                               generator=gen)
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            loss = step(batch)["loss"]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        if not np.isfinite(float(loss)):
            raise AssertionError(f"{path} train step loss {float(loss)}")
        rates[path] = (b * CHUNK_SECONDS / (ms / 1e3), ms,
                       torch.cuda.max_memory_allocated() / 2**30)
        del tm, tp, opt, step
    fmt = "; ".join(
        f"{k} {v['ms']:.3f} ms (plain {v['plain_ms']:.3f}, bound "
        f"{v['bound_ms']:.3f} by {v['bound_by']})" for k, v in res_t.items())
    print(f"train timing [{smi}] B={b} T={T} C={C} bf16: {fmt}; backward "
          f"floor of its launches {bwd_floor:.3f} ms, {bwd_all} kernel "
          f"launches a call ({bwd_sm90} gemm_sm90, {bwd_tn} gemm_tn_sm90, "
          f"{bwd_old} WMMA or FMA); train step "
          + "; ".join(f"{k} path {v[0]:.1f} audio-s/s ({v[1]:.1f} ms/step, "
                      f"peak {v[2]:.1f} GiB)" for k, v in rates.items()))
    return res_t, errs


def voice(rng, n):
    """A synthetic voice: a harmonic tone at a random pitch with a slow
    random amplitude modulation, plus noise; n samples at 16 kHz."""
    t = np.arange(n) / 16000
    f0, rate = rng.uniform(90, 260), rng.uniform(1.0, 5.0)
    tone = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 8))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rate * t + rng.uniform(0, 6.3))
    return (0.2 * tone * env + rng.uniform(-0.05, 0.05, n)).astype(np.float32)


def random_campplus(dev, calibrate=False):
    """CAMPPlus at campplus.yaml's width with torch's default init from
    SEED and BN statistics and affines randomised from a generator. With
    `calibrate`, the BN statistics are then those of one train-mode
    forward over 16 seeded synthetic voices: with random statistics the
    52-layer trunk maps every input onto nearly one embedding."""
    torch.manual_seed(SEED)
    return randomised_bn(CAMPPlus(80, CAM_EMBED, pooling_func="TSTP"), dev,
                         calibrate)


def randomised_bn(model, dev, calibrate, fbank=FbankConfig()):
    """`model` on dev in eval mode, its BN statistics and affines
    randomised from a generator seeded with SEED; with `calibrate`, the
    statistics then replaced by those of one train-mode forward over 16
    seeded synthetic voices (features by `fbank`)."""
    g = torch.Generator().manual_seed(SEED)
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    with torch.no_grad():
        for m in bns:
            m.running_mean.normal_(0.0, 0.1, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
            if m.affine:
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    model = model.to(dev)
    if calibrate:
        calibrate_bn(model, dev, fbank)
    return model.eval()


def calibrate_bn(model, dev, fbank=FbankConfig()):
    """Set `model`'s BN running statistics to those of one train-mode
    forward over 16 seeded synthetic voices (features by `fbank`); the
    model is left in eval mode."""
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    rng = np.random.default_rng(SEED + 20)
    wav = np.stack([voice(rng, CHUNK_SAMPLES) for _ in range(16)])
    feat = features_from_batch({"wav": wav}, fbank, None, None, False, dev)
    for m in bns:
        m.momentum = 1.0  # running statistics := this batch's
    with torch.no_grad():
        model.train()(feat)
    for m in bns:
        m.momentum = 0.1
    return model.eval()


def cam_inputs(model, i, rng, b, t, dtype, dev):
    """Block i's folded, stacked weights as CAMPPlus passes them, and a
    random block input."""
    block = getattr(model.xvector, f"block{i + 1}")
    c0, layers, _ = CAM_BLOCKS[i]
    cols = zip(*(layer.folded(c0 + 32 * layers)
                 for layer in block.children()))
    w = [torch.stack(c).detach() for c in cols]
    x = torch.as_tensor(rng.standard_normal((b, t, c0)).astype(np.float32),
                        device=dev).to(dtype)
    return x, w, block.dilation


def phase_cam_kernels(model, dev):
    rng = np.random.default_rng(SEED + 10)
    errs, parts = [], []
    # the edge: T' = 37 and B*T' = 111, masked
    for dtype, t, masked, b in ((torch.bfloat16, CAM_T, False, SLICE_BATCH),
                                (torch.float32, 249, True, SLICE_BATCH),
                                (torch.bfloat16, 37, True, 3)):
        mask = ragged_mask(rng, b, t, dev) if masked else None
        for i, (c0, layers, _) in enumerate(CAM_BLOCKS):
            x, w, dil = cam_inputs(model, i, rng, b, t, dtype, dev)
            got = cam_block.fused_cam_dense_block(x, *w, dilation=dil,
                                                  mask=mask)
            torch.cuda.synchronize()
            want = cam_block.cam_dense_block_reference(x, *w, dilation=dil,
                                                       mask=mask)
            if not torch.equal(got[..., :c0], x):
                raise AssertionError(f"block{i + 1}: input channels moved")
            err, cos = compare(got[..., c0:], want[..., c0:], dtype)
            errs.append(err)
            parts.append(f"block{i + 1} (C0={c0}, L={layers}, d={dil}) "
                         f"{str(dtype)[6:]} B={b} T'={t} "
                         f"{'masked' if masked else 'unmasked'} "
                         f"max_abs_err={err:.3g} cos={cos:.7f}")
            del x, w, got, want
    print("cam kernels: " + "; ".join(parts))
    return {"cam": max(errs)}


def phase_campplus_slice(model, dev):
    """The CAM++ extraction path: bf16 kernel path against the
    layer-by-layer path, 3 launches per forward; then f32 on the
    calibrated copy."""
    rng = np.random.default_rng(SEED + 11)
    wav = torch.as_tensor(np.stack([voice(rng, CHUNK_SAMPLES)
                                    for _ in range(SLICE_BATCH)]), device=dev)
    io = torch.bfloat16
    embed = make_eval_embed_fn(model, FbankConfig(), compute_dtype=io,
                               fbank_conv_dtype=io, device=dev)
    zero_counts()
    emb = embed({"wav": wav})
    torch.cuda.synchronize()
    launches = counts()
    if launches != dict(NO_LAUNCH, cam=3, masked=1):
        raise AssertionError(f"CAM++ path launches {launches}, want the "
                             "CAM block 3 times and the masked stats once "
                             "per forward, nothing else")
    assert emb.shape == (SLICE_BATCH, CAM_EMBED) and torch.isfinite(emb).all()
    plain = make_eval_embed_fn(set_pooling_fused(model.set_fused(False),
                                                 False), FbankConfig(),
                               compute_dtype=io, fbank_conv_dtype=io,
                               device=dev)({"wav": wav})
    set_pooling_fused(model.set_fused(None), None)
    cos = row_cosines(emb, plain).min().item()
    if cos < 0.9999:
        raise AssertionError(f"CAM++ kernel path vs plain path cosine {cos}")
    cross = row_cosines(emb[:-1], emb[1:]).mean().item()

    cal = random_campplus(dev, calibrate=True)
    fn = make_eval_embed_fn(cal, FbankConfig(), device=dev)
    zero_counts()
    emb32 = fn({"wav": wav[:16]})
    torch.cuda.synchronize()
    if counts() != dict(NO_LAUNCH, cam=3, masked=1):
        raise AssertionError(f"calibrated CAM++ launches {counts()}")
    plain32 = make_eval_embed_fn(set_pooling_fused(cal.set_fused(False),
                                                   False), FbankConfig(),
                                 device=dev)({"wav": wav[:16]})
    cos32 = row_cosines(emb32, plain32).min().item()
    err32 = (emb32 - plain32).abs().max().item()
    cross32 = row_cosines(emb32[:-1], emb32[1:]).mean().item()
    if cos32 < 0.9999:
        raise AssertionError(f"calibrated CAM++ f32 kernel path vs plain "
                             f"path cosine {cos32}")
    print(f"campplus slice: CAMPPlus feat 80 embed {CAM_EMBED} TSTP bf16 "
          f"B={SLICE_BATCH} x {CHUNK_SAMPLES} samples (T'={CAM_T}) -> "
          f"{tuple(emb.shape)}; launches cam={launches['cam']} "
          f"masked={launches['masked']}; min cosine "
          f"vs plain bf16 path {cos:.7f} (mean cosine between neighbouring "
          f"utterances {cross:.7f}); calibrated BN statistics, f32 B=16: "
          f"min cosine vs plain path {cos32:.7f}, max abs err {err32:.3g} "
          f"(between utterances {cross32:.4f})")
    return launches


CAM_YAML = ("model: CAMPPlus\nmodel_args:\n  feat_dim: 80\n"
            f"  embed_dim: {CAM_EMBED}\n  pooling_func: TSTP\n"
            "dataset_args:\n  fbank_args:\n    num_mel_bins: 80\n")


def serve_waves(model, dev, waves, yaml_text, probe=None):
    """An EmbeddingServer built from a YAML and `model` saved as a .pt; each wave's requests are posted concurrently,
    the waves in turn; then `probe(url)`, if given, before the server
    closes. Returns the replies, the batch shapes served and the
    launches."""
    with tempfile.TemporaryDirectory() as d:
        ckpt, conf = os.path.join(d, "model.pt"), os.path.join(d, "m.yaml")
        torch.save(model.state_dict(), ckpt)
        with open(conf, "w") as f:
            f.write(yaml_text)
        server = EmbeddingServer(parse_config_or_kwargs(conf), ckpt, port=0,
                                 max_batch=8, max_wait_ms=50,
                                 device=dev).start()
        served, inner = [], server.batcher.embed_fn

        def recording(wavs, mask):
            served.append(wavs.shape)
            return inner(wavs, mask)

        server.batcher.embed_fn = recording
        replies = []
        try:
            url = f"http://127.0.0.1:{server.port}"
            zero_counts()
            for wave in waves:
                with concurrent.futures.ThreadPoolExecutor(len(wave)) as ex:
                    replies += ex.map(
                        lambda w: _post(f"{url}/embed",
                                        {"wav": w.tolist(),
                                         "sample_rate": 16000}), wave)
            launches = counts()
            if probe is not None:
                probe(url)
        finally:
            server.close()
    return torch.tensor([r["embedding"] for r in replies]), served, launches


def phase_campplus_serving(model, dev):
    """Three waves of concurrent /embed requests, one per bucket (16,000,
    32,000 and 48,000 samples: T' = 49, 99, 149), each reply against
    batch=1 (cosine >= 0.9999). Then the same requests to a server of the
    calibrated copy, whose embeddings depend on the input: each reply
    against the same request padded and masked to its bucket and embedded
    directly (cosine >= 0.9999), and, measured only, against batch=1 (the
    frames next to the padding see it through the convolutions, as in the
    JAX package; tests/test_masked_eval_equivalence.py)."""
    rng = np.random.default_rng(SEED + 12)
    wavs = [voice(rng, n) for n in (12000, 16000, 20800, 27200, 32000,
                                    35200, 41600, 48000)]
    waves = [wavs[:2], wavs[2:5], wavs[5:]]
    parts = []
    for name, m in (("random", model),
                    ("calibrated", random_campplus(dev, calibrate=True))):
        embs, served, launches = serve_waves(m, dev, waves, CAM_YAML)
        if (launches["cam"] < 3 or launches["cam"] != 3 * launches["masked"]
                or launches["se"] or launches["tail"]):
            raise AssertionError(f"CAM++ serving launches {launches}")
        frames = sorted({((n - 400) // 160 + 2) // 2 for _, n in served})
        if frames != [49, 99, 149]:
            raise AssertionError(f"served buckets {served}: T' {frames}")
        fn = make_eval_embed_fn(m, FbankConfig(), device=dev)
        single = torch.cat([fn({"wav": w[None]}).cpu() for w in wavs])
        bucket = []
        for w in wavs:
            n = -(-len(w) // 16000) * 16000
            padded, mask = np.zeros((1, n), np.float32), np.zeros((1, n),
                                                                  np.float32)
            padded[0, :len(w)], mask[0, :len(w)] = w, 1.0
            bucket.append(fn({"wav": padded, "mask": mask}).cpu())
        vs_single = row_cosines(embs, single)
        vs_bucket = row_cosines(embs, torch.cat(bucket))
        bar = vs_single if name == "random" else vs_bucket
        if bar.min().item() < 0.9999:
            raise AssertionError(f"CAM++ {name} served replies: vs batch=1 "
                                 f"{vs_single}, vs bucket {vs_bucket}")
        parts.append(
            f"{name} BN statistics: batches {served} (T' {frames}), "
            f"launches cam={launches['cam']} masked={launches['masked']}; "
            f"min cosine vs batch=1 "
            f"{vs_single.min().item():.7f}, vs the bucket embedded directly "
            f"{vs_bucket.min().item():.7f}, between neighbouring replies "
            f"{row_cosines(embs[:-1], embs[1:]).mean().item():.4f}")
    print(f"campplus serving: CAMPPlus from a YAML + .pt, {len(wavs)} /embed "
          "(0.75-3 s) in three concurrent waves; " + "; ".join(parts))


def phase_campplus_timing(model, dev, smi):
    """CUDA events after warm-up at B=512, T'=100, bf16: each block's
    kernel and plain version with its bound; CAMPPlus extraction audio-s/s
    on the kernel path and with fused_blocks=False and plain pooling."""
    rng = np.random.default_rng(SEED + 13)
    io = torch.bfloat16
    blocks, res = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    flops_all = bytes_all = 0
    for i, (c0, layers, _) in enumerate(CAM_BLOCKS):
        x, w, dil = cam_inputs(model, i, rng, B, CAM_T, io, dev)
        # from this call's shapes: live channels only, the gate once per
        # segment; x read once, the dense map written once, the weights
        # in the io type and the affines in f32
        flops, nbytes = cam_dense_block(*x.shape, layers)
        ms = cuda_ms(lambda: cam_block.fused_cam_dense_block(
            x, *w, dilation=dil))
        plain_ms = cuda_ms(lambda: cam_block.cam_dense_block_reference(
            x, *w, dilation=dil), iters=3, warmup=1)
        bms, by = bound(flops, nbytes)
        # the port's kernels and copies one call launches (torch.profiler)
        kl, _, copies = count_launches(
            lambda: cam_block.fused_cam_dense_block(x, *w, dilation=dil),
            "ws::")
        blocks.append((i, ms, plain_ms, bms, by, kl, copies))
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        flops_all += flops
        bytes_all += nbytes
        del x, w
    res["bound_ms"], res["bound_by"] = bound(flops_all, bytes_all)
    # every layer reads its live channels from device memory
    floor_ms = sum(kernel_bounds.cam_dense_block_floor(B, CAM_T, c0, n)
                   for c0, n, _ in CAM_BLOCKS) / kernel_bounds.PEAK_BYTES * 1e3
    wav = torch.as_tensor(np.stack([voice(rng, CHUNK_SAMPLES)
                                    for _ in range(B)]), device=dev)
    rates = {}
    for path, fused in (("kernel", None), ("plain", False)):
        embed = make_eval_embed_fn(set_pooling_fused(model.set_fused(fused),
                                                     fused), FbankConfig(),
                                   compute_dtype=io, fbank_conv_dtype=io,
                                   device=dev)
        ms = cuda_ms(lambda: embed({"wav": wav}), iters=5, warmup=2)
        rates[path] = (B * CHUNK_SECONDS / (ms / 1e3), ms)
    set_pooling_fused(model.set_fused(None), None)
    fmt = "; ".join(f"block{i + 1} {ms:.3f} ms (plain {pm:.3f}, bound "
                    f"{bm:.3f} by {by}; {kl} kernel launches, {cp} copy)"
                    for i, ms, pm, bm, by, kl, cp in blocks)
    print(f"campplus timing [{smi}] B={B} T'={CAM_T} bf16: {fmt}; three "
          f"blocks {res['ms']:.3f} ms (plain {res['plain_ms']:.3f}, bound "
          f"{res['bound_ms']:.3f}, the design's floor "
          f"{floor_ms:.3f}; {sum(b[5] for b in blocks)} kernel launches and "
          f"{sum(b[6] for b in blocks)} copies a forward); CAMPPlus "
          "extraction kernel path "
          f"{rates['kernel'][0]:.1f} audio-s/s ({rates['kernel'][1]:.2f} "
          f"ms/batch), fused_blocks=False {rates['plain'][0]:.1f} audio-s/s "
          f"({rates['plain'][1]:.2f} ms/batch)")
    return {"cam": res}


def random_gemini(dev, calibrate=False):
    """Gemini_DF_ResNet114 at gemini_dfresnet_adam.yaml's width with
    torch's default init from SEED and BN statistics randomised (or, with
    `calibrate`, taken from synthetic voices) as random_campplus's."""
    torch.manual_seed(SEED)
    return randomised_bn(Gemini_DF_ResNet114(80, GEMINI_EMBED), dev,
                         calibrate)


def stage_frames(t, i):
    """Frames of stage i at t input frames: stage 1's downsample halves
    T."""
    return t if i == 0 else (t - 1) // 2 + 1


def gemini_inputs(model, i, rng, b, t, dtype, dev):
    """Stage i's folded, stacked weights as the model passes them, and a
    random channels-last stage input at t input frames."""
    f, _, c, _ = GEMINI_STAGES[i]
    x = torch.as_tensor(rng.standard_normal(
        (b, f, stage_frames(t, i), c)).astype(np.float32), device=dev)
    return x.to(dtype).permute(0, 3, 1, 2), folded_stage(model.stages[i])


def phase_gemini_kernels(model, dev):
    """The stage kernel against its plain version at each of the four
    Gemini_DF_ResNet114 stage shapes, B=64: bf16 at 200 frames (T' = 200,
    100, 100, 100) and f32 at 198 (T' = 198, 99, 99, 99); then at each of
    GEMINI_EDGES in bf16 and f32, with the stage's weights of that width
    (its first 3 blocks)."""
    rng = np.random.default_rng(SEED + 14)
    errs, parts = [], []
    widths = {}
    for dtype, t in ((torch.bfloat16, T), (torch.float32, 198)):
        for i, (f, _, c, blocks) in enumerate(GEMINI_STAGES):
            x, w = gemini_inputs(model, i, rng, SLICE_BATCH, t, dtype, dev)
            widths[c] = [v[:3] for v in w]
            got = inv_bottleneck.fused_inv_bottleneck_stage(x, *w)
            torch.cuda.synchronize()
            want = inv_bottleneck.inv_bottleneck_stage_reference(x, *w)
            if not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f"stage{i}: output not channels-last")
            err, cos = compare(got, want, dtype)
            errs.append(err)
            parts.append(f"stage{i} (F={f}, T'={x.shape[-1]}, C={c}, "
                         f"L={blocks}) {str(dtype)[6:]} max_abs_err="
                         f"{err:.3g} cos={cos:.7f}")
            del x, w, got, want
    edges = []
    for b, f, t, c in GEMINI_EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.as_tensor(rng.standard_normal((b, f, t, c)).astype(
                np.float32), device=dev).to(dtype).permute(0, 3, 1, 2)
            got = inv_bottleneck.fused_inv_bottleneck_stage(x, *widths[c])
            torch.cuda.synchronize()
            want = inv_bottleneck.inv_bottleneck_stage_reference(
                x, *widths[c])
            err, cos = compare(got, want, dtype)
            errs.append(err)
            edges.append(f"({b}, {f}, {t}, {c}) {str(dtype)[6:]} "
                         f"cos={cos:.7f}")
    print("gemini kernels: " + "; ".join(parts) + "; edges (B, F, T', C): "
          + ", ".join(edges))
    return {"gemini": max(errs)}


def phase_gemini_slice(model, dev):
    """The Gemini extraction path: bf16 kernel path against the
    block-by-block path, 4 launches per forward; then f32 on the
    calibrated copy."""
    rng = np.random.default_rng(SEED + 15)
    wav = torch.as_tensor(np.stack([voice(rng, CHUNK_SAMPLES)
                                    for _ in range(SLICE_BATCH)]), device=dev)
    io = torch.bfloat16
    embed = make_eval_embed_fn(model, FbankConfig(), compute_dtype=io,
                               fbank_conv_dtype=io, device=dev)
    zero_counts()
    emb = embed({"wav": wav})
    torch.cuda.synchronize()
    launches = counts()
    if launches != dict(NO_LAUNCH, gemini=4, masked=1):
        raise AssertionError(f"Gemini path launches {launches}, want the "
                             "stage kernel 4 times and the masked stats "
                             "once per forward, nothing else")
    assert emb.shape == (SLICE_BATCH, GEMINI_EMBED)
    assert torch.isfinite(emb).all()
    plain = make_eval_embed_fn(set_pooling_fused(model.set_fused(False),
                                                 False), FbankConfig(),
                               compute_dtype=io, fbank_conv_dtype=io,
                               device=dev)({"wav": wav})
    set_pooling_fused(model.set_fused(None), None)
    cos = row_cosines(emb, plain).min().item()
    cross = row_cosines(emb[:-1], emb[1:]).mean().item()
    if cos < 0.9999:
        raise AssertionError(f"Gemini kernel path vs plain path cosine {cos}")

    cal = random_gemini(dev, calibrate=True)
    fn = make_eval_embed_fn(cal, FbankConfig(), device=dev)
    zero_counts()
    emb32 = fn({"wav": wav[:16]})
    torch.cuda.synchronize()
    if counts() != dict(NO_LAUNCH, gemini=4, masked=1):
        raise AssertionError(f"calibrated Gemini launches {counts()}")
    plain32 = make_eval_embed_fn(set_pooling_fused(cal.set_fused(False),
                                                   False), FbankConfig(),
                                 device=dev)({"wav": wav[:16]})
    cos32 = row_cosines(emb32, plain32).min().item()
    err32 = (emb32 - plain32).abs().max().item()
    cross32 = row_cosines(emb32[:-1], emb32[1:]).mean().item()
    if cos32 < 0.9999:
        raise AssertionError(f"calibrated Gemini f32 kernel path vs plain "
                             f"path cosine {cos32}")
    print(f"gemini slice: Gemini_DF_ResNet114 feat 80 embed {GEMINI_EMBED} "
          f"TSTP bf16 B={SLICE_BATCH} x {CHUNK_SAMPLES} samples -> "
          f"{tuple(emb.shape)}; launches gemini={launches['gemini']} "
          f"masked={launches['masked']}; min "
          f"cosine vs plain bf16 path {cos:.7f} (mean cosine between "
          f"neighbouring utterances {cross:.7f}); calibrated BN statistics, "
          f"f32 B=16: min cosine vs plain path {cos32:.7f}, max abs err "
          f"{err32:.3g} (between utterances {cross32:.4f})")
    return launches


def phase_gemini_serving(dev):
    """An EmbeddingServer built from a Gemini YAML and a .pt of the
    calibrated copy (embeddings that depend on the input): three waves of
    concurrent /embed requests, one per bucket (T' = 49, 99, 149); each
    reply against the same request padded and masked to its bucket and
    embedded directly (cosine >= 0.9999) and, measured only, against
    batch=1 (the stages see the padding through their 3x3 convs, as in the
    JAX package)."""
    rng = np.random.default_rng(SEED + 16)
    wavs = [voice(rng, n) for n in (12000, 16000, 20800, 27200, 32000,
                                    35200, 41600, 48000)]
    model = random_gemini(dev, calibrate=True)
    embs, served, launches = serve_waves(
        model, dev, [wavs[:2], wavs[2:5], wavs[5:]], GEMINI_YAML)
    if launches["gemini"] < 12 or launches["gemini"] != 4 * launches[
            "masked"] or any(v for k, v in launches.items()
                             if k not in ("gemini", "masked")):
        raise AssertionError(f"Gemini serving launches {launches}")
    frames = sorted({((n - 400) // 160 + 2) // 2 for _, n in served})
    if frames != [49, 99, 149]:
        raise AssertionError(f"served buckets {served}: T' {frames}")
    fn = make_eval_embed_fn(model, FbankConfig(), device=dev)
    single = torch.cat([fn({"wav": w[None]}).cpu() for w in wavs])
    bucket = []
    for w in wavs:
        n = -(-len(w) // 16000) * 16000
        padded, mask = np.zeros((1, n), np.float32), np.zeros((1, n),
                                                              np.float32)
        padded[0, :len(w)], mask[0, :len(w)] = w, 1.0
        bucket.append(fn({"wav": padded, "mask": mask}).cpu())
    vs_single = row_cosines(embs, single)
    vs_bucket = row_cosines(embs, torch.cat(bucket))
    if vs_bucket.min().item() < 0.9999:
        raise AssertionError(f"Gemini served replies vs bucket {vs_bucket}")
    print(f"gemini serving: Gemini_DF_ResNet114 from a YAML + .pt "
          f"(calibrated BN statistics), {len(wavs)} /embed (0.75-3 s) in "
          f"three concurrent waves; batches {served} (T' {frames}), launches "
          f"gemini={launches['gemini']} masked={launches['masked']}; min "
          f"cosine vs the bucket embedded "
          f"directly {vs_bucket.min().item():.7f}, vs batch=1 (not gated) "
          f"{vs_single.min().item():.7f}, between neighbouring replies "
          f"{row_cosines(embs[:-1], embs[1:]).mean().item():.4f}")


def routes_launched(lib, fn):
    """The GEMM launches one call of fn makes, by route, as library `lib`
    counts them where it launches each (_build.gemm_routes). Gates read
    these: torch.profiler drops kernel records now and then on the card's
    machine (2 of a tail call's 4 gemm_sm90 launches once, late in a
    run)."""
    torch.cuda.synchronize()
    before = _build.gemm_routes(lib)
    fn()
    torch.cuda.synchronize()
    after = _build.gemm_routes(lib)
    return {k: after[k] - before[k] for k in after}


def count_launches(fn, mark="inv_block_kernel"):
    """Device kernels one call of fn launches, by torch.profiler: (the
    launches of kernels whose name holds `mark`, all kernels', copies)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.count, e.key) for e in prof.key_averages()
            if profile_extract._device_us(e) > 0]
    copies = sum(n for n, k in rows if "Memcpy" in k or "Memset" in k)
    return (sum(n for n, k in rows if mark in k),
            sum(n for n, _ in rows) - copies, copies)


def phase_gemini_timing(model, dev, smi):
    """CUDA events after warm-up at B=512 x 200 frames, bf16: each stage's
    kernel and plain version with its bound, its kernel launches a call
    (torch.profiler) and the device memory the call takes beyond its input
    (torch.cuda.max_memory_allocated after a reset); Gemini_DF_ResNet114
    extraction audio-s/s and peak device memory on the kernel path and
    with fused_stages=False and plain pooling."""
    rng = np.random.default_rng(SEED + 17)
    io = torch.bfloat16
    stages, res = [], {"ms": 0.0, "plain_ms": 0.0}
    flops_all = bytes_all = 0
    for i, (f, _, c, blocks) in enumerate(GEMINI_STAGES):
        x, w = gemini_inputs(model, i, rng, B, T, io, dev)
        # from this call's shapes: x read once, the output written once,
        # the matrices and taps in the io type, the affines in f32
        flops, nbytes = inv_bottleneck_stage(B, f, x.shape[-1], c, blocks)
        ms = cuda_ms(lambda: inv_bottleneck.fused_inv_bottleneck_stage(
            x, *w))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        inv_bottleneck.fused_inv_bottleneck_stage(x, *w)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        # the gate reads the wrapper's counter (one a stage call); the
        # profiler's kernel counts are printed only, as it has dropped
        # records (35 of 36 once)
        before = inv_bottleneck.fused_inv_bottleneck_stage.launches
        launched = count_launches(
            lambda: inv_bottleneck.fused_inv_bottleneck_stage(x, *w))[:2] + (
            inv_bottleneck.fused_inv_bottleneck_stage.launches - before,)
        # the parent's three-launch design allocated h and g, (B, F, T, 4C)
        # each
        hg = 2 * x.numel() * 4 * x.element_size() / 2 ** 30
        plain_ms = cuda_ms(
            lambda: inv_bottleneck.inv_bottleneck_stage_reference(x, *w),
            iters=3, warmup=1)
        bms, by = bound(flops, nbytes)
        stages.append((i, ms, plain_ms, bms, by, launched, extra, hg))
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        flops_all += flops
        bytes_all += nbytes
        del x, w
        torch.cuda.empty_cache()
    res["bound_ms"], res["bound_by"] = bound(flops_all, bytes_all)
    wav = torch.as_tensor(np.stack([voice(rng, CHUNK_SAMPLES)
                                    for _ in range(B)]), device=dev)
    rates = {}
    for path, fused in (("kernel", None), ("plain", False)):
        embed = make_eval_embed_fn(set_pooling_fused(model.set_fused(fused),
                                                     fused), FbankConfig(),
                                   compute_dtype=io, fbank_conv_dtype=io,
                                   device=dev)
        ms = cuda_ms(lambda: embed({"wav": wav}), iters=5, warmup=2)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        embed({"wav": wav})
        torch.cuda.synchronize()
        rates[path] = (B * CHUNK_SECONDS / (ms / 1e3), ms,
                       torch.cuda.max_memory_allocated() / 2 ** 30)
    set_pooling_fused(model.set_fused(None), None)
    wrapper_launches = [v[5][2] for v in stages]
    if wrapper_launches != [1] * len(GEMINI_STAGES):
        raise AssertionError(f"stage wrapper launches {wrapper_launches} "
                             "over the four stage calls, want one each")
    fmt = "; ".join(
        f"stage{i} {ms:.3f} ms (plain {pm:.3f}, bound {bm:.3f} by {by}; "
        f"wrapper launches {ln[2]}; by torch.profiler, not gated: {ln[0]} "
        f"stage-kernel launches, {ln[1]} kernels in all; "
        f"{ex:.3f} GiB beyond x, where the parent design's h and g took "
        f"{hg:.3f})" for i, ms, pm, bm, by, ln, ex, hg in stages)
    print(f"gemini timing [{smi}] B={B} T={T} bf16: {fmt}; four stages "
          f"{res['ms']:.3f} ms (plain {res['plain_ms']:.3f}, bound "
          f"{res['bound_ms']:.3f}), {sum(wrapper_launches)} stage calls, "
          f"{sum(v[5][0] for v in stages)} stage-kernel launches by "
          "torch.profiler (not gated); "
          f"Gemini_DF_ResNet114 extraction kernel path "
          f"{rates['kernel'][0]:.1f} audio-s/s ({rates['kernel'][1]:.2f} "
          f"ms/batch, peak {rates['kernel'][2]:.3f} GiB), fused_stages=False "
          f"{rates['plain'][0]:.1f} audio-s/s ({rates['plain'][1]:.2f} "
          f"ms/batch, peak {rates['plain'][2]:.3f} GiB)")
    return {"gemini": res}


def chain_inputs(block, rng, b, t, dtype, dev):
    """A random chain input and the chain's folded weights: an ECAPA c512
    block's (width 64), or, for block None, random ones of a c1024 chain
    (width 128, dilation 3)."""
    if block is None:
        c, dil = 1024, 3
        w = c // 8

        def r(*shape, scale=1.0):
            return torch.as_tensor(rng.standard_normal(shape).astype(
                np.float32) * scale, device=dev)

        weights = [r(7, 3, w, w, scale=(3 * w) ** -0.5), r(7, w, scale=.1),
                   1 + r(7, w, scale=.1), r(7, w, scale=.1)]
    else:
        c, dil = C, block.dilation
        weights = [v.detach() for v in block.se_res2block[1].folded()]
    x = torch.as_tensor(rng.standard_normal((b, t, c)).astype(np.float32),
                        device=dev).to(dtype)
    return x, weights, dil


def phase_res2_kernels(model, dev):
    """The chain kernel against its plain version at the three c512 chains
    and a c1024 chain, B=64: bf16 at T=200, f32 at T=198."""
    rng = np.random.default_rng(SEED + 21)
    errs, parts = [], []
    for dtype, t, b in ((torch.bfloat16, T, SLICE_BATCH),
                        (torch.float32, 198, SLICE_BATCH),
                        (torch.bfloat16, 37, 3)):
        for name, block in (("layer2", model.layer2),
                            ("layer3", model.layer3),
                            ("layer4", model.layer4), ("c1024", None)):
            x, w, dil = chain_inputs(block, rng, b, t, dtype, dev)
            got = res2_chain.fused_res2_chain(x, *w, dilation=dil)
            torch.cuda.synchronize()
            want = res2_chain.res2_chain_reference(x, *w, dilation=dil)
            err, cos = compare(got, want, dtype)
            errs.append(err)
            parts.append(f"{name} (C={x.shape[-1]}, d={dil}) "
                         f"{str(dtype)[6:]} B={b} T={t} "
                         f"max_abs_err={err:.3g} "
                         f"cos={cos:.7f}")
            del x, w, got, want
    print("res2 kernels: " + "; ".join(parts))
    return {"res2": max(errs)}


def phase_res2_slice(model, dev):
    """ECAPA_TDNN_GLOB_c512 in eval with fused=False, fused_res2=True: 3
    chain launches per forward and nothing else, against the layer-by-layer
    path."""
    rng = np.random.default_rng(SEED + 22)
    wav = torch.as_tensor(rng.uniform(-0.5, 0.5, (SLICE_BATCH, CHUNK_SAMPLES))
                          .astype(np.float32), device=dev)
    io = torch.bfloat16
    embed = make_eval_embed_fn(model.set_fused(False, fused_res2=True),
                               FbankConfig(), compute_dtype=io,
                               fbank_conv_dtype=io, device=dev)
    zero_counts()
    emb = embed({"wav": wav})
    torch.cuda.synchronize()
    launches = counts()
    if launches != dict(NO_LAUNCH, res2=3, softmax=1, masked=1):
        raise AssertionError(f"fused_res2 path launches {launches}, want "
                             "the chain 3 times and each pooling kernel "
                             "once per forward, nothing else")
    assert emb.shape == (SLICE_BATCH, 192) and torch.isfinite(emb).all()
    plain = make_eval_embed_fn(
        set_pooling_fused(model.set_fused(False, fused_res2=False), False),
        FbankConfig(), compute_dtype=io, fbank_conv_dtype=io,
        device=dev)({"wav": wav})
    set_pooling_fused(model.set_fused(True), None)
    cos = row_cosines(emb, plain).min().item()
    if cos < 0.9999:
        raise AssertionError(f"fused_res2 path vs layer path cosine {cos}")
    print(f"res2 slice: ECAPA_TDNN_GLOB_c512 fused=False fused_res2=True bf16 "
          f"B={SLICE_BATCH} x {CHUNK_SAMPLES} samples -> {tuple(emb.shape)}; "
          f"launches res2={launches['res2']} softmax={launches['softmax']} "
          f"masked={launches['masked']}; min cosine vs the layer path "
          f"{cos:.7f}")
    return launches


def phase_res2_timing(model, dev, smi):
    """CUDA events at B=512, T=200, C=512, bf16: the layer3 chain's kernel,
    plain version and bound; ECAPA extraction with fused_res2 and layer by
    layer (fused=False both)."""
    rng = np.random.default_rng(SEED + 23)
    io = torch.bfloat16
    x, w, dil = chain_inputs(model.layer3, rng, B, T, io, dev)
    res = {"ms": cuda_ms(lambda: res2_chain.fused_res2_chain(
        x, *w, dilation=dil)),
        "plain_ms": cuda_ms(lambda: res2_chain.res2_chain_reference(
            x, *w, dilation=dil), iters=5), "library_ms": None}
    res["bound_ms"], res["bound_by"] = bound(
        *kernel_bounds.res2_chain(B, T, C))
    chain_launches = count_launches(lambda: res2_chain.fused_res2_chain(
        x, *w, dilation=dil), "ws::")[0]
    del x
    wav = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, CHUNK_SAMPLES)).astype(
        np.float32), device=dev)
    rates = {}
    for path, flag in (("fused_res2", True), ("layer", False)):
        embed = make_eval_embed_fn(
            set_pooling_fused(model.set_fused(False, fused_res2=flag), False),
            FbankConfig(), compute_dtype=io, fbank_conv_dtype=io, device=dev)
        ms = cuda_ms(lambda: embed({"wav": wav}), iters=5, warmup=2)
        rates[path] = (B * CHUNK_SECONDS / (ms / 1e3), ms)
    set_pooling_fused(model.set_fused(True, fused_res2=False), None)
    print(f"res2 timing [{smi}] B={B} T={T} C={C} d={dil} bf16: chain "
          f"{res['ms']:.3f} ms (plain {res['plain_ms']:.3f}, bound "
          f"{res['bound_ms']:.3f} by {res['bound_by']}; {chain_launches} "
          f"kernel launch a call, {3 * chain_launches} a forward); ECAPA "
          "extraction "
          "fused=False: fused_res2 " + ", layer path ".join(
              f"{v[0]:.1f} audio-s/s ({v[1]:.2f} ms/batch)"
              for v in rates.values()))
    return {"res2": res}


def dw_inputs(rng, b, h, w, ci, co, dtype, dev):
    def r(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev).to(dtype)

    return r(b, h, w, ci), r(b, h, w, co)


def phase_dw_kernels(dev):
    """dw_pack against its plain version at ResNet34's three packed shapes
    and the zoo's five (ZOO_DW), B=128 x 200 frames, and at DW_EDGES: bf16 by cosine, f32 within 1e-4
    of the largest magnitude; two calls bit-identical; ineligible shapes
    raise."""
    rng = np.random.default_rng(SEED + 24)
    errs, parts = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for h, w, ci, co in [s[:4] for s in RESNET_DW] + list(ZOO_DW):
            x, dy = dw_inputs(rng, RESNET_BATCH, h, w, ci, co, dtype, dev)
            got = conv_dw_pack.dw_pack(x, dy)
            again = conv_dw_pack.dw_pack(x, dy)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"dw_pack {h}x{w} {ci}->{co}: two calls "
                                     "differ")
            want = conv_dw_pack.dw_pack_reference(x, dy)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            cos = cosine(got, want)
            if (rel > 1e-4 if dtype == torch.float32 else cos < 0.9999):
                raise AssertionError(f"dw_pack {h}x{w} {ci}->{co} "
                                     f"{dtype}: error {rel:.3g} of the "
                                     f"largest magnitude, cosine {cos}")
            errs.append(err)
            parts.append(f"{h}x{w} {ci}->{co} {str(dtype)[6:]} "
                         f"max_abs_err={err:.3g} ({rel:.2g} of max) "
                         f"cos={cos:.7f} bit-identical")
            del x, dy, got, again, want
    edges = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, w, ci, co in DW_EDGES:
            x, dy = dw_inputs(rng, b, h, w, ci, co, dtype, dev)
            got = conv_dw_pack.dw_pack(x, dy)
            again = conv_dw_pack.dw_pack(x, dy)
            torch.cuda.synchronize()
            want = conv_dw_pack.dw_pack_reference(x, dy)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            cos = cosine(got, want)
            if (not torch.equal(got, again) or got.shape != (co, ci, 3, 3)
                    or (rel > 1e-4 if dtype == torch.float32
                        else cos < 0.9999)):
                raise AssertionError(
                    f"dw_pack B={b} {h}x{w} {ci}->{co} {dtype}: error "
                    f"{rel:.3g} of the largest magnitude, cosine {cos}, "
                    f"bit-identical {torch.equal(got, again)}")
            edges.append(rel)
    parts.append(f"{len(edges)} edge shapes (Ci->Co 1->32, 8->24, 48->48, "
                 f"64->64; W 1, 17, 250; H=1; B*H below the SM count; bf16 "
                 f"and f32) bit-identical, at most {max(edges):.2g} of the "
                 f"largest magnitude")
    x = torch.zeros(2, 8, 10, 32, device=dev, dtype=torch.bfloat16)
    wide = torch.zeros(2, 8, 10, 128, device=dev, dtype=torch.bfloat16)
    refused = 0
    for args in ((wide, x), (x, x[:, ::2, ::2].contiguous())):
        try:
            conv_dw_pack.dw_pack(*args)
        except ValueError:
            refused += 1
    strided = torch.nn.Conv2d(32, 32, 3, stride=2, padding=1, bias=False)
    if refused != 2 or conv_dw_pack.eligible((2, 32, 8, 10), strided):
        raise AssertionError("dw_pack took Ci = 128 or a stride-2 conv")
    print("dw kernels: " + "; ".join(parts) + "; Ci=128 and a stride-2 "
          "conv's dy raise, and a stride-2 conv is not eligible")
    return {"dw": max(errs)}


def random_resnet(dev, calibrate=True):
    """ResNet34 at resnet.yaml's width with torch's default init from SEED
    and BN statistics from synthetic voices (random_campplus's
    calibration)."""
    torch.manual_seed(SEED)
    return randomised_bn(ResNet34(80, RESNET_EMBED), dev, calibrate)


def phase_resnet_slice(dev):
    """ResNet34 extraction: f32 on the card against the same weights on the
    CPU, bf16 against f32 recorded; no dw launch."""
    rng = np.random.default_rng(SEED + 25)
    wav = torch.as_tensor(np.stack([voice(rng, CHUNK_SAMPLES)
                                    for _ in range(SLICE_BATCH)]), device=dev)
    model = random_resnet(dev)
    cpu_model = copy.deepcopy(model).cpu()
    zero_counts()
    emb32 = make_eval_embed_fn(model, FbankConfig(), device=dev)({"wav": wav})
    emb16 = make_eval_embed_fn(model, FbankConfig(),
                               compute_dtype=torch.bfloat16,
                               fbank_conv_dtype=torch.bfloat16,
                               device=dev)({"wav": wav})
    torch.cuda.synchronize()
    launches = counts()
    if launches != dict(NO_LAUNCH, masked=2):
        raise AssertionError(f"ResNet34 extraction launched {launches}, "
                             "want the masked stats once per forward")
    assert emb32.shape == (SLICE_BATCH, RESNET_EMBED)
    assert torch.isfinite(emb32).all() and torch.isfinite(emb16).all()
    cpu = make_eval_embed_fn(cpu_model, FbankConfig(), device="cpu")(
        {"wav": wav.cpu()})
    cos32 = row_cosines(emb32.cpu(), cpu).min().item()
    err32 = (emb32.cpu() - cpu).abs().max().item()
    cos16 = row_cosines(emb16, emb32).min().item()
    cross = row_cosines(emb32[:-1], emb32[1:]).mean().item()
    if cos32 < 0.9999:
        raise AssertionError(f"ResNet34 f32 card vs CPU cosine {cos32}")
    print(f"resnet slice: ResNet34 feat 80 embed {RESNET_EMBED} TSTP, BN "
          f"statistics from synthetic voices, B={SLICE_BATCH} x "
          f"{CHUNK_SAMPLES} samples -> {tuple(emb32.shape)}; launches "
          f"dw={launches['dw']} masked={launches['masked']} (two forwards); "
          f"f32 card vs CPU min cosine {cos32:.7f} "
          f"(max abs err {err32:.3g}); bf16 vs f32 min cosine {cos16:.7f} "
          f"(not gated); between neighbouring utterances {cross:.4f}")


def phase_resnet_serving(dev):
    """A server from a ResNet34 YAML and a .pt: three waves of concurrent
    /embed requests in buckets of 1, 2 and 3 s; each reply against the same
    request padded and masked to its bucket (cosine >= 0.9999), against
    batch=1 recorded."""
    rng = np.random.default_rng(SEED + 26)
    wavs = [voice(rng, n) for n in (12000, 16000, 20800, 27200, 32000,
                                    35200, 41600, 48000)]
    model = random_resnet(dev)
    embs, served, launches = serve_waves(
        model, dev, [wavs[:2], wavs[2:5], wavs[5:]], RESNET_YAML)
    if launches != dict(NO_LAUNCH, masked=len(served)):
        raise AssertionError(f"ResNet34 serving launches {launches} for "
                             f"{len(served)} batches")
    lengths = sorted({n for _, n in served})
    if lengths != [16000, 32000, 48000]:
        raise AssertionError(f"served buckets {served}")
    fn = make_eval_embed_fn(model, FbankConfig(), device=dev)
    single = torch.cat([fn({"wav": w[None]}).cpu() for w in wavs])
    bucket = []
    for w in wavs:
        n = -(-len(w) // 16000) * 16000
        padded, mask = np.zeros((1, n), np.float32), np.zeros((1, n),
                                                              np.float32)
        padded[0, :len(w)], mask[0, :len(w)] = w, 1.0
        bucket.append(fn({"wav": padded, "mask": mask}).cpu())
    vs_single = row_cosines(embs, single)
    vs_bucket = row_cosines(embs, torch.cat(bucket))
    if vs_bucket.min().item() < 0.9999:
        raise AssertionError(f"ResNet34 served replies vs bucket {vs_bucket}")
    print(f"resnet serving: ResNet34 from a YAML + .pt (BN statistics from "
          f"synthetic voices), {len(wavs)} /embed (0.75-3 s) in three "
          f"concurrent waves; batches {served}, launches masked="
          f"{launches['masked']}; min cosine vs the bucket "
          f"embedded directly {vs_bucket.min().item():.7f}, vs batch=1 (not "
          f"gated) {vs_single.min().item():.7f}, between neighbouring "
          f"replies {row_cosines(embs[:-1], embs[1:]).mean().item():.4f}")


def resnet_train_modules(dev):
    """ResNet34 and an ArcMargin head over NUM_CLASS classes, torch's
    default init from SEED, with resnet.yaml's SGD."""
    return build_train_state(
        lambda: (ResNet34(80, RESNET_EMBED),
                 ArcMarginProduct(RESNET_EMBED, NUM_CLASS)),
        RESNET_SGD, seed=SEED, device=dev)


def resnet_step(model, proj, opt, dtype, dev, gen=None):
    """resnet.yaml's train step (dither, no spec-aug) at a constant LR and
    margin; dither 0 without a generator."""
    return make_train_step(model, proj, opt, lambda s: 0.1, lambda s: 0.2,
                           FbankConfig(dither=1.0 if gen else 0.0),
                           AugConfig(spec_aug=False), compute_dtype=dtype,
                           device=dev, generator=gen)


def phase_resnet_train(dev):
    """3 bf16 packed steps, 14 dw launches each; then one step packed and
    one native from the same weights without randomness, in bf16 and f32,
    the updates compared layer by layer."""
    model, proj, opt, gen = resnet_train_modules(dev)
    rng = np.random.default_rng(SEED + 27)
    batch = train_batch(rng, RESNET_BATCH, dev)
    step = resnet_step(model, proj, opt, torch.bfloat16, dev, gen)
    losses = []
    relayouts = conv_dw_pack.Conv2dPackedDW.relayouts
    conv_dw_pack.set_conv_dw_mode("packed")
    try:
        zero_counts()
        for i in range(3):
            losses.append(float(step(batch)["loss"]))
            want = dict(NO_LAUNCH, dw=DW_PER_STEP * (i + 1))
            if counts() != want:
                raise AssertionError(f"after step {i}: launches {counts()}, "
                                     f"want {want}")
    finally:
        conv_dw_pack.set_conv_dw_mode("native")
    relayouts = conv_dw_pack.Conv2dPackedDW.relayouts - relayouts
    if not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    del model, proj, opt, step
    parts, bad = [], []
    for dtype in (torch.bfloat16, torch.float32):
        rel, worst, per_tensor = compare_dw_modes(dev, batch, dtype)
        parts.append(
            f"{str(dtype)[6:]}: loss rel {rel:.2e}, update cosine per layer "
            "lowest " + ", ".join(f"{n} {c:.6f}" for n, c in worst)
            + f" (per tensor lowest {per_tensor[1]} {per_tensor[0]:.6f})")
        if rel > 1e-3 or worst[0][1] < 0.999:
            bad.append(str(dtype))
    print(f"resnet train: ResNet34 + ArcMargin {NUM_CLASS} bf16 "
          f"B={RESNET_BATCH}, dither 1, conv_dw_mode packed: losses "
          f"{[round(v, 4) for v in losses]}, dw launches per step "
          f"{DW_PER_STEP}, maps copied to channels-last for the kernel "
          f"{relayouts}; one step packed and one native from the same "
          "weights without randomness (bars 1e-3 and 0.999): "
          + "; ".join(parts))
    if bad:
        raise AssertionError(f"packed and native steps disagree in {bad}")


def compare_dw_modes(dev, batch, dtype, modules=resnet_train_modules,
                     per_step=DW_PER_STEP):
    """One step with conv_dw_mode packed and one native from the seeded
    weights of `modules(dev)` (ResNet34's by default), dither 0, the packed
    step launching row 10 `per_step` times. Returns the loss's relative
    difference, the three lowest update cosines per layer and the lowest
    per tensor."""
    updates, loss = {}, {}
    for mode in ("packed", "native"):
        model, proj, opt, _ = modules(dev)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        one = resnet_step(model, proj, opt, dtype, dev)
        conv_dw_pack.set_conv_dw_mode(mode)
        try:
            zero_counts()
            loss[mode] = float(one(batch)["loss"])
            want = per_step if mode == "packed" else 0
            if counts() != dict(NO_LAUNCH, dw=want):
                raise AssertionError(f"{mode} step launches {counts()}")
        finally:
            conv_dw_pack.set_conv_dw_mode("native")
        updates[mode] = {n: (p.detach() - start[n]).float()
                         for n, p in model.named_parameters()}
        del model, proj, opt, one
    layers = {}
    for n in updates["packed"]:
        layers.setdefault(n.rsplit(".", 1)[0], []).append(n)
    cos = {k: cosine(torch.cat([updates["packed"][n].flatten() for n in ns]),
                     torch.cat([updates["native"][n].flatten() for n in ns]))
           for k, ns in layers.items()}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    per_tensor = min((cosine(updates["packed"][n], updates["native"][n]), n)
                     for n in updates["packed"])
    return (abs(loss["packed"] - loss["native"]) / abs(loss["native"]), worst,
            per_tensor)


def phase_resnet_trainer(dev):
    """bin/train.py with a ResNet34 YAML, conv_dw_mode packed, bf16, batch
    TRAINER_BATCH x 200 frames, one epoch of 3 steps on the synthetic
    corpus; the extractor reloads final_model.pt."""
    import yaml

    rng = np.random.default_rng(SEED + 28)
    with tempfile.TemporaryDirectory() as d:
        raw, utt2spk = write_corpus(d, rng)
        conf = {
            "exp_dir": os.path.join(d, "exp"), "train_data": raw,
            "utt2spk": utt2spk, "data_type": "raw", "num_epochs": 1,
            "samples_per_epoch": 3 * TRAINER_BATCH, "seed": SEED,
            "log_batch_interval": 1, "enable_amp": True,
            "conv_dw_mode": "packed", "model": "ResNet34",
            "model_args": {"feat_dim": 80, "embed_dim": RESNET_EMBED,
                           "pooling_func": "TSTP", "two_emb_layer": False},
            "projection_args": {"project_type": "arc_margin"},
            "optimizer": "SGD", "optimizer_args": RESNET_SGD[
                "optimizer_args"],
            "dataset_args": {"batch_size": TRAINER_BATCH, "num_frms": 200,
                             "fbank_args": {"num_mel_bins": 80},
                             "speed_perturb": True, "spec_aug": False},
            "scheduler_args": {"initial_lr": 0.1, "final_lr": 0.01,
                               "warm_up_epoch": 0}}
        path = os.path.join(d, "conf.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(conf, f)
        zero_counts()
        t0 = time.perf_counter()
        try:
            step = train_cli.train(path, device=dev)
            torch.cuda.synchronize()
        finally:
            conv_dw_pack.set_conv_dw_mode("native")
        train_s = time.perf_counter() - t0
        launches = counts()
        want = dict(NO_LAUNCH, dw=3 * DW_PER_STEP)
        if launches != want or step.step != 3:
            raise AssertionError(f"ResNet34 trainer: {step.step} steps, "
                                 f"launches {launches}, want 3 and {want}")
        exp = os.path.join(d, "exp")
        with open(os.path.join(exp, "train.log")) as f:
            last = [ln for ln in f.read().splitlines() if "it 2/3 loss" in ln]
        if not last:
            raise AssertionError("ResNet34 trainer log has no step 2")
        final = os.path.join(exp, "models", "final_model.pt")
        if os.readlink(final) != "model_0.pt":
            raise AssertionError("final_model.pt does not link model_0.pt")
        loaded = load_model_for_eval(
            load_yaml(os.path.join(exp, "config.yaml")), final, device=dev)
        for k, v in step.model.state_dict().items():
            if not torch.equal(loaded.state_dict()[k], v):
                raise AssertionError(f"checkpoint differs at {k}")
        wav = np.random.default_rng(SEED + 29).uniform(
            -0.5, 0.5, (1, 48000)).astype(np.float32)
        emb = make_eval_embed_fn(loaded, FbankConfig(), device=dev)(
            {"wav": wav})
    if emb.shape != (1, RESNET_EMBED) or not torch.isfinite(emb).all():
        raise AssertionError(f"embedding {emb}")
    print(f"resnet trainer: bin/train.py ResNet34 conv_dw_mode packed bf16 "
          f"batch {TRAINER_BATCH} x 200 frames, 3 steps in {train_s:.1f} s; "
          f"launches dw={launches['dw']}; log "
          f"'{last[0].split(' ', 3)[3]}'; final_model.pt served a "
          f"(1, {RESNET_EMBED}) embedding, norm {emb.norm().item():.4f}")
    return launches


def phase_resnet_timing(dev, smi):
    """CUDA events after warm-up: dw_pack at the three shapes (kernel and
    cuDNN's weight gradient timed TIMING_REPS times in turns by graph
    replay, median and spread; plain; bound), summed over the 14 calls of a
    step; ResNet34 extraction at B=512 x 2 s bf16; the ResNet34 train step
    at B=128 bf16, packed and native (host clock around 5 steps that end in
    a synchronize, after 2 warm-up steps)."""
    rng = np.random.default_rng(SEED + 30)
    io = torch.bfloat16
    shapes, res = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    flops_all = bytes_all = 0
    for h, w, ci, co, calls in RESNET_DW:
        x, dy = dw_inputs(rng, RESNET_BATCH, h, w, ci, co, io, dev)
        weight = torch.zeros(co, ci, 3, 3, device=dev, dtype=io)
        xm, dym = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        (ms, ms_sp), (lib_ms, lib_sp) = in_turns(
            lambda: conv_dw_pack.dw_pack(x, dy),
            lambda: torch.ops.aten.convolution_backward(
                dym, xm, weight, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                1, [False, True, False]))
        plain_ms = cuda_ms(lambda: conv_dw_pack.dw_pack_reference(x, dy),
                           iters=3, warmup=1)
        flops, nbytes = kernel_bounds.dw_pack(RESNET_BATCH, h, w, ci, co)
        bms, by = bound(flops, nbytes)
        shapes.append((h, w, ci, co, calls, ms, ms_sp, plain_ms, lib_ms,
                       lib_sp, bms, by))
        res["ms"] += calls * ms
        res["plain_ms"] += calls * plain_ms
        res["library_ms"] += calls * lib_ms
        flops_all += calls * flops
        bytes_all += calls * nbytes
        del x, dy, xm, dym
    res["bound_ms"], res["bound_by"] = bound(flops_all, bytes_all)

    model = random_resnet(dev, calibrate=False)
    wav = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, CHUNK_SAMPLES)).astype(
        np.float32), device=dev)
    embed = make_eval_embed_fn(model, FbankConfig(), compute_dtype=io,
                               fbank_conv_dtype=io, device=dev)
    ext_ms = cuda_ms(lambda: embed({"wav": wav}), iters=5, warmup=2)
    del model, embed, wav
    torch.cuda.empty_cache()

    batch = train_batch(rng, RESNET_BATCH, dev)
    rates = {}
    for mode in ("packed", "native"):
        tm, tp, opt, gen = resnet_train_modules(dev)
        step = resnet_step(tm, tp, opt, io, dev, gen)
        conv_dw_pack.set_conv_dw_mode(mode)
        try:
            for _ in range(2):
                step(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(5):
                loss = step(batch)["loss"]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 5 * 1e3
        finally:
            conv_dw_pack.set_conv_dw_mode("native")
        if not np.isfinite(float(loss)):
            raise AssertionError(f"{mode} train step loss {float(loss)}")
        rates[mode] = (RESNET_BATCH * CHUNK_SECONDS / (ms / 1e3), ms,
                       torch.cuda.max_memory_allocated() / 2**30)
        del tm, tp, opt, step
    fmt = "; ".join(
        f"{h}x{w} {ci}->{co} x{n}: {ms:.4f} ms (spread {sp:.4f}; plain "
        f"{pm:.3f}, cuDNN {lm:.4f} spread {lsp:.4f}, bound {bm:.4f} by {by})"
        for h, w, ci, co, n, ms, sp, pm, lm, lsp, bm, by in shapes)
    print(f"resnet timing [{smi}] dw_pack B={RESNET_BATCH} bf16, medians "
          f"of {TIMING_REPS} graph-replay timings in turns with cuDNN's: "
          f"{fmt}; the "
          f"{DW_PER_STEP} calls of a step {res['ms']:.3f} ms (plain "
          f"{res['plain_ms']:.3f}, cuDNN {res['library_ms']:.3f}, bound "
          f"{res['bound_ms']:.3f}); ResNet34 extraction B={B} x 2 s bf16 "
          f"{B * CHUNK_SECONDS / (ext_ms / 1e3):.1f} audio-s/s "
          f"({ext_ms:.2f} ms/batch); train step B={RESNET_BATCH} bf16 "
          + "; ".join(f"{k} {v[0]:.1f} audio-s/s ({v[1]:.1f} ms/step, peak "
                      f"{v[2]:.1f} GiB)" for k, v in rates.items()))
    return {"dw": res}


def phase_family_train(dev):
    """CAMPPlus (campplus.yaml's width), Gemini_DF_ResNet114
    (gemini_dfresnet_adam.yaml's) and ReDimNetB2 (redimnet.yaml's: a
    72-bin fbank, embed 192) with an ArcMargin head over NUM_CLASS
    classes: 3 bf16 AMP train steps each at B=32 x 2 s, dither and
    spec-aug on, SGD; every loss finite and no kernel launched (training
    runs layer by layer, and the pooling kernels are inference-only); then
    each family's step time after those warm-up steps, by CUDA events over
    3 more steps."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 31)
    batch = train_batch(rng, TRAINER_BATCH, dev)
    parts = []
    for name, make, embed, fbank in (
            ("CAMPPlus", lambda: CAMPPlus(80, CAM_EMBED), CAM_EMBED,
             FbankConfig(dither=1.0)),
            ("Gemini_DF_ResNet114",
             lambda: Gemini_DF_ResNet114(80, GEMINI_EMBED), GEMINI_EMBED,
             FbankConfig(dither=1.0)),
            ("ReDimNetB2", lambda: ReDimNetB2(REDIM_FEAT, REDIM_EMBED),
             REDIM_EMBED, FbankConfig(num_mel_bins=REDIM_FEAT, dither=1.0))):
        model, proj, opt, gen = build_train_state(
            lambda: (make(), ArcMarginProduct(embed, NUM_CLASS)), SGD_CONF,
            seed=SEED, device=dev)
        step = make_train_step(model, proj, opt, lambda s: 0.1,
                               lambda s: 0.2, fbank,
                               AugConfig(), compute_dtype=torch.bfloat16,
                               device=dev, generator=gen)
        zero_counts()
        t0 = time.perf_counter()
        losses = [float(step(batch)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if not all(np.isfinite(losses)) or counts() != NO_LAUNCH:
            raise AssertionError(f"{name} train steps: losses {losses}, "
                                 f"launches {counts()}")
        ms = cuda_ms(lambda: step(batch), iters=3, warmup=0)
        if not np.isfinite(float(step(batch)["loss"])):
            raise AssertionError(f"{name}: a timed step is not finite")
        parts.append(f"{name} losses " + " ".join(f"{v:.4f}" for v in losses)
                     + f" ({sec:.1f} s with warm-up; {ms:.1f} ms a step "
                     f"after it; one more step by torch.profiler: "
                     f"{fmt_device(*device_time(lambda: step(batch)))})")
        del model, proj, opt, step
        torch.cuda.empty_cache()
    print(f"family train: 3 bf16 steps at B={TRAINER_BATCH} x 2 s + ArcMargin "
          f"{NUM_CLASS}: " + "; ".join(parts)
          + f"; {time.perf_counter() - t_start:.1f} s")


def pool_inputs(rng, b, t, d, dtype, dev, masked=False):
    """Random logits and x (B, T, D); with `masked` a ragged mask whose
    last utterance has no valid frame."""
    def r():
        return torch.as_tensor(rng.standard_normal((b, t, d)).astype(
            np.float32), device=dev).to(dtype)

    mask = None
    if masked:
        mask = ragged_mask(rng, b, t, dev)
        mask[-1] = 0
    return r(), r(), mask


def masked_stats_f64(x, mask, ddof):
    """fused_masked_stats' contract evaluated in f64 (the f32 plain version
    carries its own rounding where |mean| >> std)."""
    xd = x.double()
    m = (torch.ones(x.shape[:2] + (1,), device=x.device, dtype=torch.float64)
         if mask is None else mask[..., None].double())
    count = m.sum(1)
    mean = (xd * m).sum(1) / count.clamp(min=1)
    var = (((xd - mean[:, None]) * m) ** 2).sum(1) / (count - ddof).clamp(
        min=1)
    return mean, torch.sqrt(var + 1e-7)


def stats_compare(got, want, dtype):
    """(mean, std), f32 whatever the input type, against the plain
    version, each output by scaled_compare. Returns the max abs error and
    the least cosine."""
    assert all(g.dtype == torch.float32 for g in got)
    errs, coss = zip(*(scaled_compare(g, w, dtype)
                       for g, w in zip(got, want)))
    return max(errs), min(coss)


def phase_pool_kernels(dev):
    """Rows 6 and 7 against their plain versions: at ReDimNetB2's pooling
    shape (B=512, T=200, D=1152), ResNet34's TSTP shape (T'=25,
    D=2560), ERes2Net34's (T'=25, D=5120), the x-vector's (T'=186,
    D=1500) and Whisper-PMFA's (B=64, T=100 and 250, D=10,240) in bf16,
    and in f32 at T=198, D=600, B=3 with a ragged mask
    whose last utterance has no valid frame; the masked stats at ddof 0
    and 1; and the masked stats' edges (T = 1, count <= ddof, D = 7 and
    600, f32 with mean 1e3 and std 1e-2, 65,536 utterances). Inputs that
    need a backward or another type are refused."""
    rng = np.random.default_rng(SEED + 32)
    errs, parts = {}, []
    cases = ((torch.bfloat16, B, T, REDIM_D, False),
             (torch.bfloat16, B, *RESNET_TSTP, False),
             (torch.float32, 3, 198, 600, True),
             *((torch.bfloat16, B, t, d, False) for t, d in ZOO_TSTP),
             *((torch.bfloat16, FRONTEND_B, t, d, False)
               for t, d in WHISPER_POOL))
    for dtype, b, t, d, masked in cases:
        logits, x, mask = pool_inputs(rng, b, t, d, dtype, dev, masked)
        got = pooling.fused_softmax_stats(logits, x, mask)
        torch.cuda.synchronize()
        err, cos = stats_compare(got, pooling.softmax_stats_reference(
            logits, x, mask), dtype)
        errs.setdefault("softmax", err)
        where = (f"{str(dtype)[6:]} B={b} T={t} D={d}"
                 f"{' masked' if masked else ''}")
        parts.append(f"softmax_stats {where} max_abs_err={err:.3g} "
                     f"cos={cos:.7f}")
        if dtype == torch.bfloat16:  # and f32 logits (the ECAPA tail's)
            got = pooling.fused_softmax_stats(logits.float(), x, mask)
            torch.cuda.synchronize()
            err, cos = stats_compare(got, pooling.softmax_stats_reference(
                logits.float(), x, mask), dtype)
            errs["softmax"] = max(errs["softmax"], err)
            parts.append(f"softmax_stats f32 logits {where} "
                         f"max_abs_err={err:.3g} cos={cos:.7f}")
        for ddof in (1, 0):
            got = pooling.fused_masked_stats(x, mask, ddof=ddof)
            torch.cuda.synchronize()
            err, cos = stats_compare(got, pooling.masked_stats_reference(
                x, mask, ddof), dtype)
            errs.setdefault("masked", err)
            parts.append(f"masked_stats {where} ddof={ddof} "
                         f"max_abs_err={err:.3g} cos={cos:.7f}")
        del logits, x, got
    # edges of the one-pass masked stats: T = 1 and a mask with one valid
    # frame (count <= ddof), D = 7 (no vector path) and an unmasked D=600,
    # f32 with mean 1e3 and std 1e-2 (the std within 1e-4 of its
    # magnitude: raw sums of x and x^2 would lose it), and 65,536
    # utterances, which the two-pass kernel's grid refused
    one = torch.zeros(4, 9, device=dev)
    one[:, 3] = 1
    edge_cases = (
        ("T=1", torch.bfloat16, 4, 1, 64, None, 0.0, 1.0),
        ("T=1", torch.float32, 4, 1, 64, None, 0.0, 1.0),
        ("one valid frame", torch.float32, 4, 9, 64, one, 0.0, 1.0),
        ("D=7", torch.float32, 5, 9, 7, "ragged", 0.0, 1.0),
        ("D=7", torch.bfloat16, 5, 9, 7, None, 0.0, 1.0),
        ("D=600", torch.bfloat16, 3, 30, 600, None, 0.0, 1.0),
        ("mean 1e3 std 1e-2", torch.float32, 4, 200, 256, "ragged", 1e3,
         1e-2),
        ("B=65536", torch.bfloat16, 65536, 2, 8, None, 0.0, 1.0))
    edge_errs = []
    for what, dtype, b, t, d, mask, offset, scale in edge_cases:
        x = torch.as_tensor((rng.standard_normal((b, t, d)) * scale
                             + offset).astype(np.float32), device=dev)
        x = x.to(dtype)
        if isinstance(mask, str):
            mask = ragged_mask(rng, b, t, dev)
        for ddof in (1, 0):
            got = pooling.fused_masked_stats(x, mask, ddof=ddof)
            torch.cuda.synchronize()
            err, _ = stats_compare(got, pooling.masked_stats_reference(
                x, mask, ddof), dtype)
            edge_errs.append(err)
            if offset:  # the std against the contract in f64
                truth = masked_stats_f64(x, mask, ddof)[1]
                off = (got[1].double() - truth).abs().max().item()
                if off > 1e-4 * truth.abs().max().item():
                    raise AssertionError(f"masked_stats at mean 1e3, std "
                                         f"1e-2: std off by {off:.3g}")
        del x
    parts.append(f"masked_stats edges ({', '.join(c[0] for c in edge_cases)};"
                 f" ddof 0 and 1) max_abs_err={max(edge_errs):.3g}")
    # edges of the one-pass softmax stats: T = 1, one valid frame, D = 7
    # (the scalar path), an all-masked utterance, 65,537 utterances (past
    # the grid.y of the thread-per-channel kernel it replaced), logits
    # near +80; bf16 and f32 logits
    soft_errs = []
    for what, dtype, b, t, d, mask, shift in (
            ("T=1", torch.bfloat16, 4, 1, 128, None, 0.0),
            ("one valid frame", torch.float32, 4, 9, 64, one, 0.0),
            ("D=7", torch.float32, 5, 9, 7, "ragged", 0.0),
            ("B=65537", torch.bfloat16, 65537, 3, 8, "ragged", 0.0),
            ("logits near 80", torch.bfloat16, 8, 200, 256, "ragged",
             80.0)):
        logits, x, _ = pool_inputs(rng, b, t, d, dtype, dev, False)
        logits = logits + shift
        if isinstance(mask, str):
            mask = ragged_mask(rng, b, t, dev)
            mask[-1] = 0  # an utterance with no valid frame
        for lg in (logits, logits.float()):
            got = pooling.fused_softmax_stats(lg, x, mask)
            torch.cuda.synchronize()
            err, cos = stats_compare(got, pooling.softmax_stats_reference(
                lg, x, mask), dtype)
            soft_errs.append(err)
        del logits, x
    parts.append("softmax_stats edges (T=1, one valid frame, D=7, "
                 "B=65537, logits near 80; an all-masked utterance; bf16 "
                 f"and f32 logits) max_abs_err={max(soft_errs):.3g}")
    x = torch.zeros(2, 8, 128, device=dev)
    refused = []
    for what, call in (
            ("requires grad", lambda: pooling.fused_masked_stats(
                x.clone().requires_grad_())),
            ("requires grad", lambda: pooling.fused_softmax_stats(
                x.clone().requires_grad_(), x)),
            ("f16", lambda: pooling.fused_masked_stats(x.half())),
            ("f64", lambda: pooling.fused_softmax_stats(x, x.double()))):
        try:
            call()
        except (RuntimeError, TypeError) as e:
            refused.append(f"{what}: {type(e).__name__}")
        else:
            raise AssertionError(f"a pooling kernel took an input that "
                                 f"{what}")
    print("pool kernels: " + "; ".join(parts) + "; refused "
          + ", ".join(refused))
    return errs


def random_redimnet(dev, calibrate=False):
    """ReDimNetB2 at redimnet.yaml's width with torch's default init from
    SEED and randomised BN statistics; with `calibrate`, statistics from
    synthetic voices (random_campplus's calibration, 72-bin fbank)."""
    torch.manual_seed(SEED)
    return randomised_bn(ReDimNetB2(REDIM_FEAT, REDIM_EMBED), dev,
                         calibrate, fbank=REDIM_FBANK)


def phase_redimnet_slice(model, dev):
    """The ReDimNet extraction path: one launch of each pooling kernel per
    forward; the kernel route against fused=False pooling in bf16; then
    f32 on the card against the CPU on the calibrated copy."""
    rng = np.random.default_rng(SEED + 33)
    wav = torch.as_tensor(np.stack([voice(rng, CHUNK_SAMPLES)
                                    for _ in range(SLICE_BATCH)]), device=dev)
    io = torch.bfloat16
    embed = make_eval_embed_fn(model, REDIM_FBANK, compute_dtype=io,
                               fbank_conv_dtype=io, device=dev)
    zero_counts()
    emb = embed({"wav": wav})
    torch.cuda.synchronize()
    launches = counts()
    if launches != dict(NO_LAUNCH, softmax=1, masked=1):
        raise AssertionError(f"ReDimNet path launches {launches}, want each "
                             "pooling kernel once per forward, nothing else")
    assert emb.shape == (SLICE_BATCH, REDIM_EMBED)
    assert torch.isfinite(emb).all()
    plain = make_eval_embed_fn(set_pooling_fused(model, False), REDIM_FBANK,
                               compute_dtype=io, fbank_conv_dtype=io,
                               device=dev)({"wav": wav})
    set_pooling_fused(model, None)
    cos = row_cosines(emb, plain).min().item()
    cross = row_cosines(emb[:-1], emb[1:]).mean().item()
    if cos < 0.9999:
        raise AssertionError(f"ReDimNet pooling kernels vs plain pooling "
                             f"cosine {cos}")

    cal = random_redimnet(dev, calibrate=True)
    cpu_model = copy.deepcopy(cal).cpu()
    zero_counts()
    emb32 = make_eval_embed_fn(cal, REDIM_FBANK, device=dev)(
        {"wav": wav[:16]})
    torch.cuda.synchronize()
    if counts() != dict(NO_LAUNCH, softmax=1, masked=1):
        raise AssertionError(f"calibrated ReDimNet launches {counts()}")
    cpu = make_eval_embed_fn(cpu_model, REDIM_FBANK, device="cpu")(
        {"wav": wav[:16].cpu()})
    cos32 = row_cosines(emb32.cpu(), cpu).min().item()
    err32 = (emb32.cpu() - cpu).abs().max().item()
    cross32 = row_cosines(emb32[:-1], emb32[1:]).mean().item()
    if cos32 < 0.9999:
        raise AssertionError(f"calibrated ReDimNet f32 card vs CPU cosine "
                             f"{cos32}")
    print(f"redimnet slice: ReDimNetB2 feat {REDIM_FEAT} embed {REDIM_EMBED} "
          f"ASTP (global context, D={REDIM_D}) bf16 B={SLICE_BATCH} x "
          f"{CHUNK_SAMPLES} samples -> {tuple(emb.shape)}; launches "
          f"softmax={launches['softmax']} masked={launches['masked']}; min "
          f"cosine vs fused=False pooling {cos:.7f} (between neighbouring "
          f"utterances {cross:.7f}); calibrated BN statistics, f32 B=16 card "
          f"vs CPU: min cosine {cos32:.7f}, max abs err {err32:.3g} (between "
          f"utterances {cross32:.4f})")
    return launches


def phase_redimnet_serving(dev):
    """A server from a ReDimNetB2 YAML (72-bin fbank) and a .pt of the
    calibrated copy: three waves of concurrent /embed requests in buckets
    of 1, 2 and 3 s; each reply against the same request padded and masked
    to its bucket and embedded directly (cosine >= 0.99999), against
    batch=1 recorded only (the convolutions see the padding)."""
    rng = np.random.default_rng(SEED + 34)
    wavs = [voice(rng, n) for n in (12000, 16000, 20800, 27200, 32000,
                                    35200, 41600, 48000)]
    model = random_redimnet(dev, calibrate=True)
    embs, served, launches = serve_waves(
        model, dev, [wavs[:2], wavs[2:5], wavs[5:]], REDIM_YAML)
    if launches != dict(NO_LAUNCH, softmax=len(served), masked=len(served)):
        raise AssertionError(f"ReDimNet serving launches {launches} for "
                             f"{len(served)} batches")
    lengths = sorted({n for _, n in served})
    if lengths != [16000, 32000, 48000]:
        raise AssertionError(f"served buckets {served}")
    fn = make_eval_embed_fn(model, REDIM_FBANK, device=dev)
    single = torch.cat([fn({"wav": w[None]}).cpu() for w in wavs])
    bucket = []
    for w in wavs:
        n = -(-len(w) // 16000) * 16000
        padded, mask = np.zeros((1, n), np.float32), np.zeros((1, n),
                                                              np.float32)
        padded[0, :len(w)], mask[0, :len(w)] = w, 1.0
        bucket.append(fn({"wav": padded, "mask": mask}).cpu())
    vs_single = row_cosines(embs, single)
    vs_bucket = row_cosines(embs, torch.cat(bucket))
    if vs_bucket.min().item() < 0.99999:
        raise AssertionError(f"ReDimNet served replies vs bucket {vs_bucket}")
    print(f"redimnet serving: ReDimNetB2 from a YAML + .pt (BN statistics "
          f"from synthetic voices), {len(wavs)} /embed (0.75-3 s) in three "
          f"concurrent waves; batches {served}, launches softmax="
          f"{launches['softmax']} masked={launches['masked']}; min cosine vs "
          f"the bucket embedded directly {vs_bucket.min().item():.7f}, vs "
          f"batch=1 (not gated) {vs_single.min().item():.7f}, between "
          f"neighbouring replies "
          f"{row_cosines(embs[:-1], embs[1:]).mean().item():.4f}")


def phase_redimnet_timing(model, dev, smi):
    """CUDA events after warm-up at B=512 x 200 frames, bf16: rows 6 and 7
    at ReDimNetB2's pooling shape (kernel, plain, library, bound; row 7's
    library call is torch.std_mean, unmasked, which differs only by the
    +1e-7, timed TIMING_REPS times in turns with the kernel by graph
    replay, medians and spreads; row 6 has none) and row 7 at ResNet34's
    TSTP shape likewise; ReDimNetB2 extraction audio-s/s with the pooling
    kernels and with fused=False pooling; ResNet34 extraction audio-s/s
    with and without row 7."""
    rng = np.random.default_rng(SEED + 35)
    io = torch.bfloat16
    logits, x, _ = pool_inputs(rng, B, T, REDIM_D, io, dev)
    res = {"softmax": {
        "ms": cuda_ms(lambda: pooling.fused_softmax_stats(logits, x)),
        "plain_ms": cuda_ms(lambda: pooling.softmax_stats_reference(
            logits, x), iters=5),
        "library_ms": None},
        "masked": {
        "plain_ms": cuda_ms(lambda: pooling.masked_stats_reference(x),
                            iters=5)}}
    (res["masked"]["ms"], res["masked"]["spread"]), (
        res["masked"]["library_ms"], res["masked"]["library_spread"]) = (
        in_turns(lambda: pooling.fused_masked_stats(x),
                 lambda: torch.std_mean(x, dim=1, correction=1)))
    res["softmax"]["bound_ms"], res["softmax"]["bound_by"] = bound(
        *softmax_stats(B, T, REDIM_D, logit_bytes=logits.element_size(),
                       x_bytes=x.element_size()), PEAK_F32_FLOPS)
    res["masked"]["bound_ms"], res["masked"]["bound_by"] = bound(
        *masked_stats(B, T, REDIM_D, x_bytes=x.element_size(),
                      masked=False), PEAK_F32_FLOPS)
    del logits, x
    _, xt, _ = pool_inputs(rng, B, *RESNET_TSTP, io, dev)
    tstp = {"plain_ms": cuda_ms(lambda: pooling.masked_stats_reference(xt),
                                iters=5),
            "bound_ms": bound(*masked_stats(B, *RESNET_TSTP, masked=False),
                              PEAK_F32_FLOPS)[0]}
    (tstp["ms"], tstp["spread"]), (tstp["library_ms"],
                                   tstp["library_spread"]) = in_turns(
        lambda: pooling.fused_masked_stats(xt),
        lambda: torch.std_mean(xt, dim=1, correction=1))
    del xt

    def rates(m, fbank):
        out = {}
        wav = torch.as_tensor(np.stack([voice(rng, CHUNK_SAMPLES)
                                        for _ in range(B)]), device=dev)
        for path, fused in (("kernel", None), ("plain", False)):
            embed = make_eval_embed_fn(set_pooling_fused(m, fused), fbank,
                                       compute_dtype=io, fbank_conv_dtype=io,
                                       device=dev)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: embed({"wav": wav}), iters=5, warmup=2)
            out[path] = (B * CHUNK_SECONDS / (ms / 1e3), ms,
                         torch.cuda.max_memory_allocated() / 2**30)
        set_pooling_fused(m, None)
        return out

    redim = rates(model, REDIM_FBANK)
    resnet = random_resnet(dev, calibrate=False)
    res34 = rates(resnet, FbankConfig())
    del resnet
    torch.cuda.empty_cache()

    def fmt_kernel(name, v):
        lib = spread = ""
        if v["library_ms"] is not None:
            lib = (f", torch.std_mean {v['library_ms']:.4f} spread "
                   f"{v['library_spread']:.4f}")
            spread = (f" (median of {TIMING_REPS} graph replays in turns "
                      f"with torch.std_mean, spread {v['spread']:.4f})")
        return (f"{name} {v['ms']:.4f} ms{spread} (plain "
                f"{v['plain_ms']:.4f}{lib}, bound {v['bound_ms']:.4f})")

    def fmt_rates(r):
        return ", ".join(f"{k} {v[0]:.1f} audio-s/s ({v[1]:.2f} ms/batch, "
                         f"peak {v[2]:.1f} GiB)" for k, v in r.items())

    print(f"redimnet timing [{smi}] B={B} T={T} bf16: "
          f"{fmt_kernel(f'softmax_stats D={REDIM_D}', res['softmax'])} by "
          f"{res['softmax']['bound_by']}; "
          f"{fmt_kernel(f'masked_stats D={REDIM_D}', res['masked'])} by "
          f"{res['masked']['bound_by']}; "
          f"{fmt_kernel('masked_stats ResNet34 TSTP T=25 D=2560', tstp)}; "
          f"ReDimNetB2 extraction (kernel = pooling kernels, plain = "
          f"fused=False pooling) {fmt_rates(redim)}; ResNet34 extraction "
          f"{fmt_rates(res34)}")
    return res


RECIPES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "voxceleb", "v3")  # the SSL YAMLs
DINO_CROP_SECONDS = 2 * 3.0 + 4 * 2.0  # crop audio of one utterance
DINO_PER_STEP = dict(NO_LAUNCH, se=3, tail=1, train_fwd=2, train_bwd=2)
MOCO_PER_STEP = dict(NO_LAUNCH, se=3, tail=1, train_fwd=1, train_bwd=1)
SIMCLR_PER_STEP = dict(NO_LAUNCH, train_fwd=1, train_bwd=1)
# biases whose exact gradient is 0 in the DINO step: b2 shifts a softmax
# column over frames; the pooled BN's bias, the embedding's bias and the
# head's hidden biases shift a feature that the next BatchNorm over the
# batch removes. The plain path updates them by rounding noise.
DINO_ZERO_GRAD = ("backbone." + B2, "backbone.bn.bias",
                  "backbone.linear.bias", "head.mlp_0.bias",
                  "head.mlp_1.bias")


def check_train_tail(model, rng, b, t, dev):
    """Rows 4 and 5 against their plain versions at (b, t) in bf16 with
    the model's tail weights: cosine >= 0.9999 on each of the forward's
    four outputs and the backward's eight gradients, db2 exactly zero.
    Returns (max abs error, lowest cosine) of each row."""
    io = torch.bfloat16
    xs, tw = tail_inputs(model, rng, b, t, io, dev)
    wm, bm, k1, b1, k2, b2 = tw
    got = mfa_astp_vjp.mfa_astp_train_fwd(*xs, *tw, glob=True)
    torch.cuda.synchronize()
    want = mfa_astp_vjp.mfa_astp_train_fwd_reference(*xs, *tw, glob=True)
    fwd = [compare(gv, wv, io) for gv, wv in zip(got, want)]
    g = torch.as_tensor(rng.standard_normal((b, 3072)).astype(np.float32),
                        device=dev)
    res = (*xs, wm, k1, b2, k2, *want, g)
    grads = mfa_astp_vjp.mfa_astp_train_bwd(*res, glob=True)
    torch.cuda.synchronize()
    if grads[-1].abs().max().item() != 0.0:
        raise AssertionError(f"db2 is not exactly zero at B={b} T={t}")
    plain = mfa_astp_vjp.mfa_astp_train_bwd_reference(*res, glob=True)
    bwd = [scaled_compare(gv, wv, io)
           for gv, wv in zip(grads[:-1], plain[:-1])]
    return [(max(e for e, _ in r), min(c for _, c in r)) for r in (fwd, bwd)]


def check_eval_tail(model, x):
    """Rows 1 and 2 against their plain versions where the DINO teacher
    runs them: its three SE-Res2 blocks and its MFA+ASTP tail on its own
    activations of x, the global crops (B=128, T=298) in bf16, each block
    fed the kernel's output of the one before; cosine >= 0.9999 (compare).
    Returns (max abs error, lowest cosine) of each row."""
    model.eval()
    rows = {"se": [], "tail": []}
    with torch.no_grad():
        h, outs = model.layer1(x), []
        for layer in (model.layer2, model.layer3, model.layer4):
            pre, res2, post, se = layer.se_res2block
            w = (*pre.folded(), *res2.folded(), *post.folded(),
                 *se.folded())
            got = se_block.fused_se_res2_block(h, *w, dilation=layer.dilation)
            torch.cuda.synchronize()
            want = se_block.se_res2_block_reference(h, *w,
                                                    dilation=layer.dilation)
            rows["se"].append(compare(got, want, x.dtype))
            h = got
            outs.append(h)
        tw = model._tail_weights()
        got = mfa_astp.fused_mfa_astp(*outs, *tw, glob=True)
        torch.cuda.synchronize()
        want = mfa_astp.mfa_astp_reference(*outs, *tw, glob=True)
        rows["tail"].append(compare(got, want, x.dtype))
    return [(max(e for e, _ in r), min(c for _, c in r))
            for r in rows.values()]


def per_layer(fn, got, want, skip=()):
    """fn(got's, want's parameters of a module as one vector each) per
    module, the names in `skip` left out."""
    layers = {}
    for n in got:
        if n not in skip:
            layers.setdefault(n.rsplit(".", 1)[0], []).append(n)
    return {k: fn(torch.cat([got[n].flatten() for n in ns]),
                  torch.cat([want[n].flatten() for n in ns]))
            for k, ns in layers.items()}


def layer_cosines(got, want, skip=()):
    """Per module, the cosine of two updates; sorted, lowest first."""
    return sorted(per_layer(cosine, got, want, skip).items(),
                  key=lambda kv: kv[1])


def dino_one_step(dev, feats, dtype, fused):
    """One DINO step from the seeded weights at the recipe's base LR 0.2 *
    64 / 256 (its schedule starts at 0), the last layer not frozen, so
    that every layer moves. Returns (loss, the student's update, the
    teacher's move, the center); raises unless the teacher moved to the
    EMA m t + (1 - m) s of the old teacher and the new student, within
    four f32 ulps of the larger of |t| and |s| (m and 1 - m rounded to
    f32, and three roundings) of the f64 value."""
    step = dino_step(dev, dtype, fused, freeze=0,
                     lr_fn=lambda s: 0.2 * DINO_BATCH / 256)
    m = step.momentum_fn(0)
    s0 = {n: p.detach().clone() for n, p in step.student.named_parameters()}
    t0 = {n: p.detach().clone() for n, p in step.teacher.named_parameters()}
    loss = float(step(feats)["loss"])
    s1 = dict(step.student.named_parameters())
    ulp = torch.finfo(torch.float32).eps
    for n, p in step.teacher.named_parameters():
        t, s_ = t0[n].double(), s1[n].detach().double()
        err = (p.double() - (t * m + s_ * (1 - m))).abs()
        if (err > 4 * ulp * torch.maximum(t.abs(), s_.abs())).any():
            raise AssertionError(f"teacher {n} is not the EMA of its "
                                 f"student: {err.max().item():.3g} off")
    out = (loss, {n: (p.detach() - s0[n]).float() for n, p in s1.items()},
           {n: (p.detach() - t0[n]).float()
            for n, p in step.teacher.named_parameters()},
           step.center.clone())
    del step, s0, t0, s1
    torch.cuda.empty_cache()
    return out


def fmt_low(cos, n=3):
    return ", ".join(f"{k} {v:.6f}" for k, v in cos[:n])


DINO_BF16_FLOOR = 0.05  # the per-layer bf16 bar's slack (compare_dino_paths)


def compare_dino_paths(dev, feats):
    """One step of the kernel path and one of the plain path from the same
    weights, in f32 (TF32 off) and in bf16. Both: the loss within 1e-3,
    the center at cosine >= 0.999, and each path's teacher the EMA of its
    student (dino_one_step). f32: each layer's update and each layer's
    teacher move at cosine >= 0.999. bf16: at this seeded init the DINO
    gradient of many layers is small (the BN affines' ~4e-5 an element)
    and bf16 rounding moves it by percents on either path: the kernel
    path's and the plain path's updates each sit at cosine ~0.956 from
    the exact f32 update in the worst layer, and at ~0.996 from each
    other (as this phase prints on an H100), and a BN weight near 1 moves
    in the EMA by ~8e-9, below half an f32 ulp. So in bf16 each path's
    update is held, layer by layer, against the plain f32 step's (the
    exact update; there the two paths agree at 1.000000 a layer): a
    layer's error ||update - exact|| / ||exact|| on the kernel path at
    most 1.1 x the plain path's in that layer + DINO_BF16_FLOOR. A 50%
    error in one layer fails it. The per-layer cosines kernel vs plain,
    the teacher's moves and the layers nearest the bar are printed.
    Returns the line's parts and the failed bars."""
    parts, bad = [], []
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for fused in (True, False):
            runs[dtype, fused] = dino_one_step(dev, feats, dtype, fused)
    exact = runs[torch.float32, False][1]
    for dtype in (torch.float32, torch.bfloat16):
        (lk, uk, tk, ck), (lp, up, tp, cp) = (runs[dtype, True],
                                              runs[dtype, False])
        if uk["backbone." + B2].abs().max().item() != 0.0:
            raise AssertionError("kernel path: b2 moved; its gradient is 0")
        rel, ccos = abs(lk - lp) / abs(lp), cosine(ck, cp)
        name = str(dtype)[6:]
        if rel > 1e-3 or ccos < 0.999:
            bad.append(f"{name} loss or center")
        upd = layer_cosines(uk, up, DINO_ZERO_GRAD)
        ema = layer_cosines(tk, tp, DINO_ZERO_GRAD)
        line = (f"{name}: loss rel {rel:.2e}, center cosine {ccos:.6f}, "
                f"update cosine per layer lowest {fmt_low(upd)}; teacher "
                f"move lowest {fmt_low(ema)}")
        if dtype == torch.float32:
            if min(upd[0][1], ema[0][1]) < 0.999:
                bad.append("f32 update or teacher move")
        else:
            err = [per_layer(lambda a, b: ((a - b).norm() / b.norm()).item(),
                             u, exact, DINO_ZERO_GRAD) for u in (uk, up)]
            # (excess over 1.1 x plain, layer, kernel error, plain error)
            near = sorted(((err[0][k] - 1.1 * err[1][k], k, err[0][k],
                            err[1][k]) for k in err[0]), reverse=True)
            over = [k for x, k, *_ in near if x > DINO_BF16_FLOOR]
            if over:
                bad.append(f"bf16 update error against the exact update in "
                           f"{over}")
            low = [layer_cosines(u, exact, DINO_ZERO_GRAD)[0] for u in (uk,
                                                                        up)]
            line += (f" (recorded); against the plain f32 step's update, "
                     f"per layer relative error kernel <= 1.1 x plain + "
                     f"{DINO_BF16_FLOOR} over {len(near)} layers, nearest "
                     + ", ".join(f"{k} {e:.4f} vs {p:.4f} (excess {x:+.4f})"
                                 for x, k, e, p in near[:3])
                     + f"; largest error kernel {max(err[0].values()):.4f}, "
                     f"plain {max(err[1].values()):.4f}; lowest layer cosine "
                     f"kernel {low[0][0]} {low[0][1]:.6f}, plain {low[1][0]} "
                     f"{low[1][1]:.6f}")
        parts.append(line)
    return parts, bad


def phase_dino(dev):
    """bench.py's DINO config on the kernel path: 3 bf16 steps, finite,
    each launching rows 1, 2, 4 and 5 3, 1, 2 and 2 times and nothing
    else; rows 4 and 5 against their plain versions at the student's two
    crop shapes, (128, 298) and (256, 198), rows 1 and 2 at the teacher's
    (check_eval_tail); then one step of the kernel
    path and one of the plain path from the same weights
    (compare_dino_paths)."""
    feats = dino_features(dev)
    step = dino_step(dev)
    losses = []
    for i in range(3):
        zero_counts()
        losses.append(float(step(feats)["loss"]))
        torch.cuda.synchronize()
        if counts() != DINO_PER_STEP:
            raise AssertionError(f"DINO step {i}: launches {counts()}, want "
                                 f"{DINO_PER_STEP}")
    if not all(np.isfinite(losses)) or step.step != 3:
        raise AssertionError(f"DINO losses {losses}, step {step.step}")
    rng = np.random.default_rng(SEED + 42)
    tails = []
    for b, t in ((2 * DINO_BATCH, 298), (4 * DINO_BATCH, 198)):
        (fe, fc), (be, bc) = check_train_tail(step.student.backbone, rng, b,
                                              t, dev)
        tails.append(f"(B={b}, T={t}) fwd err {fe:.3g} cos >= {fc:.7f}, "
                     f"bwd err {be:.3g} cos >= {bc:.7f}")
    (se_e, se_c), (tail_e, tail_c) = check_eval_tail(
        step.teacher.backbone, feats["global_feat"].to(torch.bfloat16))
    del step
    torch.cuda.empty_cache()
    parts, bad = compare_dino_paths(dev, feats)
    print(f"dino: ECAPA_TDNN_GLOB_c512 + DINO head {DINO_OUT} (BN) bf16 "
          f"B={DINO_BATCH} x (2 x 3 s + 4 x 2 s), SGD, teacher temp "
          f"0.04: losses {[round(v, 4) for v in losses]}; launches per step "
          f"se=3 tail=1 train_fwd=2 train_bwd=2, nothing else; rows 4 and 5 "
          f"vs plain bf16 " + "; ".join(tails) + "; rows 1 and 2 vs plain "
          f"on the teacher's bf16 activations (B={2 * DINO_BATCH}, T=298): "
          f"three SE blocks err {se_e:.3g} cos >= {se_c:.7f}, tail err "
          f"{tail_e:.3g} cos {tail_c:.7f}; one step of each path "
          "from the same weights, kernel vs plain: " + "; ".join(parts))
    if bad:
        raise AssertionError(f"kernel and plain DINO steps disagree: {bad}")


def device_time(fn):
    """One call of fn under torch.profiler, then one between CUDA events:
    (device ms summed over its kernels, kernel launches, call ms)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(profile_extract._device_us(e), e.count)
            for e in prof.key_averages()]
    rows = [r for r in rows if r[0] > 0]
    return (sum(us for us, _ in rows) / 1e3, sum(n for _, n in rows),
            cuda_ms(fn, iters=1, warmup=0))


def fmt_device(dev_ms, launches, call_ms):
    if not launches:
        return (f"no kernel recorded, device time not measured (call "
                f"{call_ms:.2f} ms)")
    return (f"device {dev_ms:.3f} ms over {launches} launches, call "
            f"{call_ms:.2f} ms, {100 * dev_ms / call_ms:.1f}% busy")


def phase_dino_timing(dev, smi):
    """Crop-audio-s/s of bench.py's DINO step (64 x 14 s of crops a step)
    on the kernel path and the plain path, features precomputed as
    bench_dino_step.py does: CUDA events over 5 steps after 2 warm-up,
    3 repeats (median and spread), and the peak device memory of the
    path's steps; then one step's device time by torch.profiler and one
    step between CUDA events (device_time), so the busy share is read
    late in the script, where the step runs."""
    feats = dino_features(dev)
    rates = {}
    for path, fused in (("kernel", True), ("plain", False)):
        step = dino_step(dev, fused=fused)
        for _ in range(2):
            step(feats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = [cuda_ms(lambda: step(feats), iters=5, warmup=0)
              for _ in range(TIMING_REPS)]
        med = float(np.median(ms))
        rates[path] = (DINO_BATCH * DINO_CROP_SECONDS / (med / 1e3), med,
                       max(ms) - min(ms),
                       torch.cuda.max_memory_allocated() / 2**30)
        if not np.isfinite(float(step(feats)["loss"])):
            raise AssertionError(f"{path} DINO step is not finite")
        rates[path] += device_time(lambda: step(feats))
        del step
        torch.cuda.empty_cache()
    print(f"dino timing [{smi}] bf16 B={DINO_BATCH} x (2 x 3 s + 4 x 2 s), "
          f"head {DINO_OUT}, features precomputed: "
          + "; ".join(f"{k} path {v[0]:.1f} crop-audio-s/s ({v[1]:.2f} "
                      f"ms/step median of {TIMING_REPS}, spread {v[2]:.2f} "
                      f"ms; peak {v[3]:.1f} GiB; one more step by "
                      f"torch.profiler: {fmt_device(v[4], v[5], v[6])})"
                      for k, v in rates.items()))
    return rates


def ssl_corpus(root):
    """3 x DINO_BATCH utterances of 2.5-4 s (3 speakers): an epoch of 3
    steps."""
    return write_corpus(root, np.random.default_rng(SEED + 43), n_spk=3,
                        n_utt=DINO_BATCH)


def logged_losses(exp):
    with open(os.path.join(exp, "train.log")) as f:
        return [float(ln.split(" loss ")[1].split()[0])
                for ln in f.read().splitlines() if " loss " in ln]


def phase_dino_trainer(dev, raw, utt2spk, root):
    """bin/train_dino.py with the recipe's YAML (ecapa_dino.yaml: full width,
    65,536-d head, 2 x 3 s + 4 x 2 s) in bf16 on the synthetic corpus: one
    epoch of 3 steps (stop_epoch 1), launching the DINO step's kernels 3
    times; then resume=true for the second epoch, whose steps continue at
    3; the extractor loads model_1.pt and embeds one utterance."""
    exp = os.path.join(root, "dino")
    conf = os.path.join(RECIPES, "dino/conf/ecapa_dino.yaml")
    over = [f"exp_dir={exp}", "data_type=raw", f"train_data={raw}",
            f"utt2spk={utt2spk}", "num_epochs=2", "enable_amp=true",
            "log_batch_interval=1", f"seed={SEED}",
            f"dataset_args.batch_size={DINO_BATCH}"]
    zero_counts()
    t0 = time.perf_counter()
    first = dino_cli.train_dino(conf, over + ["stop_epoch=1"], device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counts()
    want = {k: 3 * v for k, v in DINO_PER_STEP.items()}
    models = os.path.join(exp, "models")
    if (first.step != 3 or launches != want
            or not os.path.exists(os.path.join(models, "model_0.pt"))
            or not os.path.exists(os.path.join(models, "trainer_state.pt"))):
        raise AssertionError(f"first epoch: {first.step} steps, launches "
                             f"{launches} (want {want})")
    del first
    second = dino_cli.train_dino(conf, over + ["resume=true"], device=dev)
    losses = logged_losses(exp)
    if second.step != 6 or len(losses) != 6 or not np.all(
            np.isfinite(losses)):
        raise AssertionError(f"resumed run: step {second.step}, logged "
                             f"losses {losses}")
    with open(os.path.join(exp, "train.log")) as f:
        if "resumed trainer state at epoch 1 (step 3)" not in f.read():
            raise AssertionError("the second run did not resume at step 3")
    del second
    configs = load_yaml(os.path.join(exp, "config.yaml"))
    model = load_model_for_eval(configs, os.path.join(models, "model_1.pt"),
                                device=dev)
    wav = np.random.default_rng(SEED + 44).uniform(
        -0.5, 0.5, (1, 48000)).astype(np.float32)
    emb = make_eval_embed_fn(model, FbankConfig(), device=dev)({"wav": wav})
    if emb.shape != (1, 192) or not torch.isfinite(emb).all():
        raise AssertionError(f"embedding {emb}")
    print(f"dino trainer: bin/train_dino.py ecapa_dino.yaml bf16 batch "
          f"{DINO_BATCH} on {3 * DINO_BATCH} utterances: epoch 0 in 3 "
          f"steps ({first_s:.1f} s with "
          f"build), launches se={launches['se']} tail={launches['tail']} "
          f"train_fwd={launches['train_fwd']} "
          f"train_bwd={launches['train_bwd']}; resumed at step 3 for epoch "
          f"1, steps 3-5; losses {[round(v, 4) for v in losses]}; "
          f"model_1.pt served a (1, 192) embedding, norm "
          f"{emb.norm().item():.4f}")
    del model
    torch.cuda.empty_cache()


def phase_contrastive(dev, raw, utt2spk, root):
    """bin/train_contrastive.py with the recipes' YAMLs (ecapa_moco.yaml:
    queue 65,536; ecapa_simclr.yaml), B=64 x 2 s, bf16, one epoch of 3
    steps each: finite losses, the kernels of each step (MoCo: rows 1 and
    2 for the key encoder, 4 and 5 for the query; SimCLR: 4 and 5 once
    over both views), MoCo's queue pointer at 3 x 64."""
    parts = []
    for method, per_step in (("moco", MOCO_PER_STEP),
                             ("simclr", SIMCLR_PER_STEP)):
        conf = os.path.join(RECIPES, f"{method}/conf/ecapa_{method}.yaml")
        exp = os.path.join(root, method)
        zero_counts()
        t0 = time.perf_counter()
        step = contrastive_cli.train_contrastive(
            conf, [f"exp_dir={exp}", "data_type=raw", f"train_data={raw}",
                   f"utt2spk={utt2spk}", "num_epochs=1", "enable_amp=true",
                   "log_batch_interval=1", f"seed={SEED}",
                   f"ssl_method={method}",
                   f"dataset_args.batch_size={DINO_BATCH}"], device=dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches, losses = counts(), logged_losses(exp)
        want = {k: 3 * v for k, v in per_step.items()}
        if (step.step != 3 or launches != want or len(losses) != 3
                or not np.all(np.isfinite(losses))):
            raise AssertionError(f"{method}: {step.step} steps, launches "
                                 f"{launches} (want {want}), losses "
                                 f"{losses}")
        extra = ""
        if method == "moco":
            if step.queue_ptr != 3 * DINO_BATCH or step.queue.shape != (
                    65536, 192):
                raise AssertionError(f"moco queue {tuple(step.queue.shape)}"
                                     f" pointer {step.queue_ptr}")
            extra = f", queue (65536, 192) pointer {step.queue_ptr}"
        parts.append(f"{method} losses {[round(v, 4) for v in losses]} "
                     f"({sec:.1f} s with build), launches "
                     + " ".join(f"{k}={v}" for k, v in launches.items() if v)
                     + extra)
        del step
        torch.cuda.empty_cache()
    print(f"contrastive: bin/train_contrastive.py bf16 B={DINO_BATCH} x 2 s, "
          "3 steps each: " + "; ".join(parts))


QUALITY_SPK = 12
QUALITY_BATCH = 8  # extraction batch: 24 evaluation utterances in 3


def phase_quality(dev, root):
    """The quality smoke's chain on its own model at 12 speakers: the
    corpus of bin/smoke_quality.py, then in this process bin/train.py
    (its supervised config: ECAPA_TDNN at 256 channels, bf16, batch 64 x
    200 frames, 2 epochs of 20 steps), bin/extract.py --bf16 (the
    checkpoint's embeddings), bin/score.py and bin/compute_metrics.py.
    Training launches rows 4 and 5 once a step and nothing else,
    extraction row 2 once a batch and nothing else (the SE blocks take the
    layers at this width); each utterance's embedding against
    make_eval_embed_fn's plain path (fused=False, plain pooling, bf16) on
    the same checkpoint and buckets at cosine >= 0.9999; each score within
    1e-5 of a numpy f64 cosine over the ark. The EER is printed, held to
    no bar (two short epochs). Its corpus, config and checkpoint stay
    under `root` for the diar phase."""
    t_start = time.perf_counter()
    smoke_quality.make_corpus(root, n_spk=QUALITY_SPK)
    cfg, exp = smoke_quality.write_config(root, "supervised")
    zero_counts()
    step = train_cli.train(cfg, ["num_epochs=2", "samples_per_epoch=1280",
                                 "log_batch_interval=10"], device=dev)
    torch.cuda.synchronize()
    train_launches = counts()
    want = dict(NO_LAUNCH, train_fwd=step.step, train_bwd=step.step)
    if step.step != 40 or train_launches != want:
        raise AssertionError(f"quality training: {step.step} steps, "
                             f"launches {train_launches}, want 40 and "
                             f"{want}")
    del step
    configs = load_yaml(os.path.join(exp, "config.yaml"))
    ckpt = os.path.join(exp, "models", "final_model.pt")
    eval_list = os.path.join(root, "eval.list")
    batches = list(eval_batches(iter_wavs_from_list(eval_list),
                                batch_size=QUALITY_BATCH))
    zero_counts()
    scp = extract_cli.extract(os.path.join(exp, "config.yaml"), ckpt,
                              eval_list, os.path.join(root, "emb"),
                              batch_size=QUALITY_BATCH, bf16=True,
                              device=dev)
    torch.cuda.synchronize()
    extract_launches = counts()
    if extract_launches != dict(NO_LAUNCH, tail=len(batches)):
        raise AssertionError(f"quality extraction: launches "
                             f"{extract_launches}, want tail "
                             f"{len(batches)} (one a batch), no other")
    emb = read_vec_scp_dict(scp)
    model = load_model_for_eval(configs, ckpt, device=dev)
    route = {b.eval_route for b in (model.layer2, model.layer3,
                                    model.layer4)}
    plain = make_eval_embed_fn(
        set_pooling_fused(model.set_fused(False), False), FbankConfig(),
        compute_dtype=torch.bfloat16, device=dev)
    cos = []
    for batch in batches:
        want_emb = plain({"wav": batch["wav"], "mask": batch["mask"]})
        got = torch.as_tensor(np.stack([emb[k] for k in batch["key"]]),
                              device=dev)
        cos.append(row_cosines(got, want_emb).min().item())
    if min(cos) < 0.9999 or len(emb) != 2 * QUALITY_SPK:
        raise AssertionError(f"quality: {len(emb)} embeddings, kernel "
                             f"vs plain path cosine {min(cos)}")
    trials = os.path.join(root, "trials")
    score_file = score_cli.score(exp, scp, trials=[trials],
                                 device=dev)[0]
    score_err = 0.0
    with open(score_file) as f:
        lines = [ln.split() for ln in f]
    for a, b, s_, _ in lines:
        ea, eb = emb[a].astype(np.float64), emb[b].astype(np.float64)
        ref = ea @ eb / (np.linalg.norm(ea) * np.linalg.norm(eb))
        score_err = max(score_err, abs(float(s_) - ref))
    if score_err > 1e-5:
        raise AssertionError(f"quality: score vs f64 cosine {score_err}")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        eer, _, mindcf = metrics_cli.metrics_for_file(score_file)
    t_back = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        back = smoke_quality.back_end(root, exp, ckpt,
                                      os.path.join(root, "emb"),
                                      ["--device", str(dev.type)])
    back_s = time.perf_counter() - t_back
    print(f"quality: bin/smoke_quality.py's corpus at {QUALITY_SPK} speakers "
          f"and supervised config (ECAPA_TDNN C={SMOKE_C}, SE route "
          f"{sorted(route)}), bin/train.py 2 epochs of 20 steps bf16 B=64: "
          f"launches train_fwd={train_launches['train_fwd']} "
          f"train_bwd={train_launches['train_bwd']} se=0 tail=0; "
          f"bin/extract.py --bf16 {len(emb)} utterances in {len(batches)} "
          f"batches: tail={extract_launches['tail']} se=0, min cosine vs "
          f"the plain path {min(cos):.7f}; bin/score.py {len(lines)} trials, "
          f"max |score - f64 cosine| {score_err:.2e}; "
          f"bin/compute_metrics.py EER {eer:.3f}% minDCF {mindcf:.3f} (no "
          f"bar); back end (bin/smoke_quality.py::back_end, {back_s:.1f} s): "
          f"PLDA EER {back['plda_eer_percent']:.3f}%, AS-Norm "
          f"{back['asnorm_eer_percent']:.3f}%, QMF "
          f"{back['qmf_eer_percent']:.3f}% (no bar); "
          f"{time.perf_counter() - t_start:.1f} s")


DIAR_SPK = 6          # speakers of the diar phase's recording
DIAR_GAP = 0.3        # seconds of silence between its turns
DIAR_BATCH = 64       # bin/diarize.py's default batch
DIAR_SR = 16000
DIAR_FULL_SECONDS = 30 * 60
DIAR_C512 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "examples", "voxceleb", "v2", "conf",
                         "ecapa_tdnn_c512.yaml")


def diar_files(root, wav, turns):
    """rec.wav (PCM16), wav.scp and ref.rttm (the turns, which are also
    the oracle SAD) under root; returns (wav read back, scp, rttm)."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "rec.wav")
    write_wav(path, wav, DIAR_SR)
    scp, ref = os.path.join(root, "wav.scp"), os.path.join(root, "ref.rttm")
    with open(scp, "w") as f:
        f.write(f"rec {path}\n")
    with open(ref, "w") as f:
        f.writelines(f"SPEAKER rec 1 {b:.3f} {e - b:.3f} <NA> <NA> {s} "
                     "<NA> <NA>\n" for b, e, s in turns)
    return read_wav(path)[0], scp, ref


def diar_cli_run(cfg, ckpt, scp, ref, out, clusterer, num_spks=None):
    """bin/diarize.py --bf16 with the oracle SAD; (hypothesis, DER against
    the turns, launches, seconds)."""
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _, der = diarize_cli.diarize(cfg, ckpt, scp, out, sad_rttm=ref,
                                     clusterer=clusterer, num_spks=num_spks,
                                     ref_rttm=ref, batch_size=DIAR_BATCH,
                                     bf16=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return rttm_mod.read_rttm(out), der, counts(), secs


def hyp_of(merged):
    return {"rec": [(b, e, lab) for _, b, e, lab in merged]}


def phase_diar(dev, root):
    """Diarization on the quality phase's trained ECAPA_TDNN (C=256) and
    checkpoint; see the module docstring (phase 36)."""
    t_start = time.perf_counter()
    exp = os.path.join(root, "exp")
    cfg, ckpt = (os.path.join(exp, "config.yaml"),
                 os.path.join(exp, "models", "final_model.pt"))
    configs = load_yaml(cfg)
    fbank_cfg = fbank_config(configs)
    with open(os.path.join(root, "eval.list")) as f:
        entries = [json.loads(ln) for ln in f if ln.strip()]
    spks = sorted({e["spk"] for e in entries})[:DIAR_SPK]
    utts = {s: sorted(e["wav"] for e in entries if e["spk"] == s)
            for s in spks}
    parts, turns, cur = [], [], 0.0
    gap = np.zeros(int(DIAR_GAP * DIAR_SR), np.float32)
    for u in range(2):
        for s in spks:
            w = read_wav(utts[s][u])[0]
            parts += [w, gap]
            turns.append((cur, cur + len(w) / DIAR_SR, s))
            cur += (len(w) + len(gap)) / DIAR_SR
    wav, scp, ref = diar_files(os.path.join(root, "diar"),
                               np.concatenate(parts), turns)
    sad = rttm_mod.oracle_sad(ref)["rec"]
    truth = rttm_mod.read_rttm(ref)
    ids, windows = diar_pipe.segment_windows("rec", wav, DIAR_SR, sad,
                                             fbank_cfg, device=dev)
    n_batches = -(-len(ids) // DIAR_BATCH)

    kernel = load_model_for_eval(configs, ckpt, device=dev)
    plain = set_pooling_fused(
        load_model_for_eval(configs, ckpt, device=dev).set_fused(False),
        False)
    runs = (("spectral", None), ("spectral", DIAR_SPK), ("umap", None))
    report = []
    for clusterer, k in runs:
        hyp, der, got, _ = diar_cli_run(
            cfg, ckpt, scp, ref, os.path.join(root, "diar", "out.rttm"),
            clusterer, k)
        if got != dict(NO_LAUNCH, tail=n_batches):
            raise AssertionError(f"diar {clusterer} {k}: launches {got}, "
                                 f"want tail={n_batches} (one a batch), "
                                 "no other")
        zero_counts()
        merged, _ = diar_pipe.diarize_wav(
            "rec", wav, DIAR_SR, diar_pipe.model_embedder(plain),
            sad_segments=sad, fbank_cfg=fbank_cfg, clusterer=clusterer,
            num_spks=k, batch_size=DIAR_BATCH, device=dev)
        torch.cuda.synchronize()
        if counts() != NO_LAUNCH:
            raise AssertionError(f"diar plain path launched {counts()}")
        plain_hyp = hyp_of(merged)
        vs_plain = rttm_mod.compute_der(plain_hyp, hyp)
        if vs_plain > 0.05:
            raise AssertionError(f"diar {clusterer} {k}: DER of the kernel "
                                 f"path against the plain path {vs_plain}")
        report.append(
            f"{clusterer}{'' if k is None else f' num_spks {k}'}: "
            f"{len({s for *_, s in hyp['rec']})} speakers, DER kernel "
            f"{100 * der:.2f}% plain "
            f"{100 * rttm_mod.compute_der(truth, plain_hyp):.2f}% (no bar), "
            f"kernel vs plain {100 * vs_plain:.2f}%")

    embs = {}
    for name, model, dtype in (("kernel bf16", kernel, torch.bfloat16),
                               ("kernel f32", kernel, torch.float32),
                               ("plain bf16", plain, torch.bfloat16),
                               ("plain f32", plain, torch.float32)):
        embs[name] = diar_pipe.embed_windows(
            windows, diar_pipe.model_embedder(model, dtype), DIAR_BATCH)
    cos = {(a, b): row_cosines(embs[a], embs[b]).min().item()
           for a, b in (("kernel bf16", "plain f32"),
                        ("kernel bf16", "plain bf16"),
                        ("kernel f32", "plain f32"))}
    if min(cos.values()) < 0.9999:
        raise AssertionError(f"diar window embeddings: {cos}")
    # the layout sums in fixed point: one result for the same embeddings
    layouts = [diar_manifold.umap_embed(embs["kernel bf16"])
               for _ in range(2)]
    if not np.array_equal(*layouts):
        raise AssertionError("diar: two UMAP layouts of the same window "
                             "embeddings differ")

    server = EmbeddingServer(configs, ckpt, port=0, device=dev).start()
    try:
        zero_counts()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/diarize",
            data=open(os.path.join(root, "diar", "rec.wav"), "rb").read(),
            headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=300) as r:
            reply = json.load(r)["segments"]
        torch.cuda.synchronize()
        served = counts()
    finally:
        server.close()
    merged, _ = diar_pipe.diarize_wav(
        "utt", wav, DIAR_SR, diar_pipe.model_embedder(kernel),
        fbank_cfg=fbank_cfg, device=dev)
    want = [{"begin": round(b, 3), "end": round(e, 3), "speaker": int(lab)}
            for _, b, e, lab in merged]
    if reply != want or served["tail"] < 1 or served["se"]:
        raise AssertionError(f"diar /diarize: reply {reply[:3]}..., "
                             f"in-process {want[:3]}..., launches {served}")

    model_dir = os.path.join(root, "speaker_model")
    os.makedirs(model_dir, exist_ok=True)
    shutil.copy(cfg, model_dir)
    shutil.copy(ckpt, model_dir)
    spk = Speaker(model_dir, device=dev)
    spk_der = rttm_mod.compute_der(truth, hyp_of(spk.diarize(
        os.path.join(root, "diar", "rec.wav"), "rec")))
    same = spk.compute_similarity(utts[spks[0]][0], utts[spks[0]][1])
    other = spk.compute_similarity(utts[spks[0]][0], utts[spks[1]][0])
    for s in spks:
        spk.register(s, utts[s][0])
    found = [spk.recognize(utts[s][1]) for s in spks]
    if not all(r["name"] in spks and 0.0 <= r["confidence"] <= 1.0
               for r in found):
        raise AssertionError(f"diar Speaker.recognize: {found}")
    print(f"diar: {DIAR_SPK} of the quality corpus's speakers x 2 held-out "
          f"3 s utterances in {len(turns)} turns with {DIAR_GAP} s gaps "
          f"({cur:.1f} s), quality checkpoint (ECAPA_TDNN C={SMOKE_C}), "
          f"{len(ids)} windows; bin/diarize.py --bf16 oracle SAD, "
          f"launches tail={n_batches} se=0 a run; " + "; ".join(report)
          + "; window embeddings min cosine "
          + ", ".join(f"{a} vs {b} {c:.7f}" for (a, b), c in cos.items())
          + "; two UMAP layouts of the kernel bf16 embeddings bit-identical"
          + f"; /diarize {len(reply)} segments equal to diarize_wav "
          f"in-process (tail={served['tail']}); Speaker: diarize DER "
          f"{100 * spk_der:.2f}% (umap, energy VAD, no bar), similarity "
          f"same speaker {same:.4f} other {other:.4f}, recognize "
          f"{sum(r['name'] == s for r, s in zip(found, spks))}/{DIAR_SPK} "
          f"after registering {DIAR_SPK} (no bar); "
          f"{time.perf_counter() - t_start:.1f} s")


def formant_turn(voice, n, rng, gen, dev):
    """n samples of one formant speaker (bin/smoke_quality.py's
    synth_utterance, for any length and on the card): a harmonic source
    with the speaker's formant envelope and tilt, this turn's f0 jitter
    and vibrato, syllabic modulation and breath noise."""
    formants, bandwidths, f0_base, tilt = voice
    t = torch.arange(n, device=dev, dtype=torch.float64) / DIAR_SR
    f0 = f0_base * (1.0 + 0.04 * rng.standard_normal()
                    + 0.02 * torch.sin(2 * np.pi * rng.uniform(1, 4) * t))
    phase = 2 * np.pi * torch.cumsum(f0, 0) / DIAR_SR
    h = np.arange(1, 40)
    h = h[h * f0_base <= DIAR_SR / 2 - 200]
    freq = h * f0_base
    gain = sum(b ** 2 / ((freq - fm) ** 2 + b ** 2)
               for fm, b in zip(formants, bandwidths))
    gain = gain * (freq / 500.0) ** tilt
    offs = rng.uniform(0, 2 * np.pi, len(h))
    sig = (torch.as_tensor(gain, device=dev)[:, None] * torch.sin(
        torch.as_tensor(h, device=dev, dtype=torch.float64)[:, None]
        * phase[None] + torch.as_tensor(offs, device=dev)[:, None])).sum(0)
    am = 0.55 + 0.45 * torch.clamp(torch.sin(
        2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6)), min=0)
    sig = sig * am / (sig.abs().max() + 1e-9)
    noise = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    return (0.3 * sig + 0.005 * noise).float().cpu().numpy()


def diar_full_recording(rng, dev):
    """DIAR_FULL_SECONDS of DIAR_SPK formant speakers (their formants,
    bandwidths, f0 and tilt drawn as bin/smoke_quality.py draws them),
    turns of 2-8 s by a random speaker other than the last, gaps of
    0.2-1 s; (wav, turns)."""
    voices = [(np.sort(rng.uniform([250, 800, 1800, 2800],
                                   [750, 1700, 2700, 3600])),
               rng.uniform(60, 140, 4), rng.uniform(80, 260),
               rng.uniform(-0.8, 0.8)) for _ in range(DIAR_SPK)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    parts, turns, cur, last = [], [], 0, -1
    while True:
        n = int(rng.uniform(2, 8) * DIAR_SR)
        gap = int(rng.uniform(0.2, 1.0) * DIAR_SR)
        if cur + n > DIAR_FULL_SECONDS * DIAR_SR:
            break
        s = int(rng.choice([i for i in range(DIAR_SPK) if i != last]))
        parts += [formant_turn(voices[s], n, rng, gen, dev),
                  np.zeros(gap, np.float32)]
        turns.append((cur / DIAR_SR, (cur + n) / DIAR_SR, f"spk{s}"))
        cur, last = cur + n + gap, s
    wav = np.zeros(DIAR_FULL_SECONDS * DIAR_SR, np.float32)
    joined = np.concatenate(parts)[:len(wav)]
    wav[:len(joined)] = joined
    return wav, turns


class StageClock:
    """diarize_wav's `mark`: each stage's seconds by the host clock, the
    card synchronized at its end, and the device ms between CUDA events
    recorded at the marks."""

    def __init__(self):
        self.secs, self.device_ms = {}, {}
        self.event = torch.cuda.Event(enable_timing=True)
        self.event.record()
        self.t0 = self.start = time.perf_counter()

    def __call__(self, stage):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.secs[stage] = now - self.t0
        self.device_ms[stage] = self.event.elapsed_time(event)
        self.event, self.t0 = event, now

    def total(self):
        return self.t0 - self.start


def phase_diar_full(dev, smi):
    """Diarization at full width; see the module docstring (phase 37)."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 30)
    with tempfile.TemporaryDirectory() as root:
        wav, turns = diar_full_recording(rng, dev)
        wav, scp, ref = diar_files(root, wav, turns)
        configs = load_yaml(DIAR_C512)
        torch.manual_seed(SEED)
        model = randomised_bn(build_model(configs), dev, calibrate=True)
        ckpt = os.path.join(root, "model.pt")
        torch.save(model.state_dict(), ckpt)
        setup_s = time.perf_counter() - t_start
        fbank_cfg = fbank_config(configs)
        sad = rttm_mod.oracle_sad(ref)["rec"]
        ids, windows = diar_pipe.segment_windows("rec", wav, DIAR_SR, sad,
                                                 fbank_cfg, device=dev)
        n = len(ids)
        n_batches = -(-n // DIAR_BATCH)
        plain = set_pooling_fused(
            load_model_for_eval(configs, ckpt, device=dev).set_fused(False),
            False)

        def in_process(net, dtype, clusterer, mark=None):
            merged, _ = diar_pipe.diarize_wav(
                "rec", wav, DIAR_SR, diar_pipe.model_embedder(net, dtype),
                sad_segments=sad, fbank_cfg=fbank_cfg, clusterer=clusterer,
                batch_size=DIAR_BATCH, device=dev, mark=mark)
            return hyp_of(merged)

        runs, clocks = [], {}
        for clusterer in ("spectral", "umap"):
            hyp, der, got, wall = diar_cli_run(
                DIAR_C512, ckpt, scp, ref, os.path.join(root, "out.rttm"),
                clusterer)
            want = dict(NO_LAUNCH, se=3 * n_batches, tail=n_batches)
            if got != want:
                raise AssertionError(f"diar full {clusterer}: launches "
                                     f"{got}, want {want}")
            clocks[clusterer] = clock = StageClock()
            in_process(model, torch.bfloat16, clusterer, clock)
            zero_counts()
            plain_hyp = in_process(plain, torch.float32, clusterer)
            torch.cuda.synchronize()
            if counts() != NO_LAUNCH:
                raise AssertionError(f"diar full plain path launched "
                                     f"{counts()}")
            vs_plain = rttm_mod.compute_der(plain_hyp, hyp)
            if clusterer == "spectral" and vs_plain > 0.05:
                raise AssertionError(f"diar full spectral: DER of the kernel "
                                     f"path against the plain path "
                                     f"{vs_plain}")
            runs.append(
                f"{clusterer}: {len({s for *_, s in hyp['rec']})} speakers, "
                f"DER {100 * der:.2f}% (random weights, no bar), kernel vs "
                f"plain f32 {100 * vs_plain:.2f}%"
                + ("" if clusterer == "spectral" else " (no bar)")
                + f", bin/diarize.py {wall:.2f} s, RTF "
                f"{clock.total() / DIAR_FULL_SECONDS:.5f} in-process")

        embs = {}
        for name, net, dtype in (("kernel bf16", model, torch.bfloat16),
                                 ("kernel f32", model, torch.float32),
                                 ("plain bf16", plain, torch.bfloat16),
                                 ("plain f32", plain, torch.float32)):
            embs[name] = diar_pipe.embed_windows(
                windows, diar_pipe.model_embedder(net, dtype), DIAR_BATCH)
        cos = {(a, b): row_cosines(embs[a], embs[b]).min().item()
               for a, b in (("kernel bf16", "plain f32"),
                            ("kernel bf16", "plain bf16"),
                            ("kernel f32", "plain f32"))}
        if min(cos.values()) < 0.9999:
            raise AssertionError(f"diar full window embeddings: {cos}")
        neighbours = row_cosines(embs["plain f32"][:-1],
                                 embs["plain f32"][1:]).mean().item()

        lap = spectral.laplacian(embs["kernel bf16"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, _ = spectral.eigh(lap)
        card_eigh = time.perf_counter() - t0
        host_lap = lap.cpu().numpy()
        t0 = time.perf_counter()
        host_vals, _ = scipy.linalg.eigh(host_lap)
        host_eigh = time.perf_counter() - t0
        k = spectral.num_speakers(vals)
        if k != spectral.num_speakers(host_vals):
            raise AssertionError("diar full: the eigengap count differs "
                                 "between the card's and the host's eigh")
    stages = "; ".join(
        f"{c}: " + ", ".join(f"{k_} {v:.3f}" for k_, v in clock.secs.items())
        for c, clock in clocks.items())
    device_ms = clocks["spectral"].device_ms
    print(f"diar full: ECAPA_TDNN_GLOB_c512 (ecapa_tdnn_c512.yaml, random "
          f"weights, BN statistics from synthetic voices), "
          f"{DIAR_FULL_SECONDS / 60:.0f} min of {DIAR_SPK} formant "
          f"speakers in {len(turns)} turns, oracle SAD, {n} windows in "
          f"{n_batches} batches of {DIAR_BATCH}, bf16 (set-up {setup_s:.1f} "
          f"s): launches a run se={3 * n_batches} tail={n_batches}; "
          + "; ".join(runs) + "; window embeddings min cosine "
          + ", ".join(f"{a} vs {b} {c:.7f}" for (a, b), c in cos.items())
          + f" (neighbouring windows {neighbours:.4f}); diarize_wav's "
          f"stage seconds, warm: {stages} (fbank "
          f"{device_ms['fbank']:.1f} ms, embedding "
          f"{device_ms['embedding']:.1f} ms between CUDA events); eigh of "
          f"the spectral Laplacian on the card {card_eigh:.3f} s, scipy's "
          f"on the host {host_eigh:.3f} s, eigengap count {k} on both; "
          f"{smi}; {time.perf_counter() - t_start:.1f} s")


BACKEND_SPK, BACKEND_UTT, BACKEND_TRAIN_SPK = 128, 4, 112
BACKEND_BATCH, BACKEND_LDA = 128, 100
SRE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "sre", "v2", "conf",
                          "resnet34_sre.yaml")


def speaker_voices(root, rng):
    """BACKEND_SPK speakers x BACKEND_UTT utterances of 2 s at 16 kHz, each
    speaker a fixed pitch and harmonic envelope, each utterance its own
    jitter, modulation and noise. Writes wavs, a jsonl list per set
    (train: the first BACKEND_TRAIN_SPK speakers; enroll: utterance 0 of
    the others; test: their utterances 1-3; adapt: the enroll and test
    utterances and utterance 3 of every training speaker), utt2spk per
    set and the trials (every enrolled speaker x test utterance). Returns
    the paths."""
    n = 2 * 16000
    t = np.arange(n) / 16000
    sets = {k: [] for k in ("train", "enroll", "test", "adapt")}
    for s_ in range(BACKEND_SPK):
        f0 = rng.uniform(90, 260)
        amps = rng.uniform(0.1, 1.0, 12)
        for u in range(BACKEND_UTT):
            f = f0 * (1 + 0.03 * rng.standard_normal())
            tone = sum(a * np.sin(2 * np.pi * f * (k + 1) * t
                                  + rng.uniform(0, 6.3))
                       for k, a in enumerate(amps))
            env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 4) * t
                                     + rng.uniform(0, 6.3))
            wav = tone * env / (np.abs(tone).max() + 1e-9)
            wav = (0.3 * wav + 0.01 * rng.standard_normal(n)).astype(
                np.float32)
            key = f"spk{s_:03d}_utt{u}"
            path = os.path.join(root, key + ".wav")
            write_wav(path, wav, 16000)
            entry = (key, path, f"spk{s_:03d}")
            if s_ < BACKEND_TRAIN_SPK:
                sets["train"].append(entry)
                if u == 3:
                    sets["adapt"].append(entry)
            else:
                sets["enroll" if u == 0 else "test"].append(entry)
                sets["adapt"].append(entry)
    paths = {}
    for name, entries in sets.items():
        paths[name] = os.path.join(root, f"{name}.list")
        with open(paths[name], "w") as f:
            f.write("".join(json.dumps({"key": k, "wav": w, "spk": sp})
                            + "\n" for k, w, sp in entries))
        paths[name + "_utt2spk"] = os.path.join(root, f"{name}.utt2spk")
        with open(paths[name + "_utt2spk"], "w") as f:
            f.write("".join(f"{k} {sp}\n" for k, _, sp in entries))
    paths["trials"] = os.path.join(root, "trials")
    with open(paths["trials"], "w") as f:
        for _, _, es in sets["enroll"]:
            for u, _, us in sets["test"]:
                f.write(f"{es} {u} "
                        f"{'target' if es == us else 'nontarget'}\n")
    return paths


def perturbed(sd, rng, scale=0.01):
    """A copy of the state_dict: floating tensors plus scale x their std x
    normal noise, BN variances times U(0.95, 1.05); counters kept."""
    out = {}
    for key, v in sd.items():
        v = v.detach().cpu()
        if not v.is_floating_point():
            out[key] = v.clone()
        elif key.endswith("running_var"):
            out[key] = v * torch.as_tensor(rng.uniform(0.95, 1.05, v.shape),
                                           dtype=v.dtype)
        else:
            noise = torch.as_tensor(rng.standard_normal(v.shape),
                                    dtype=v.dtype)
            out[key] = v + scale * (v.std() if v.numel() > 1 else 1) * noise
    return out


def phase_backend(dev):
    """Checkpoint interop and the SRE back end at full width; see the
    module docstring (phase 38)."""
    secs = {}
    t_start = t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs[name] = round(now - t0, 2)
        t0 = now

    configs = load_yaml(SRE_CONFIG)
    rate = configs["dataset_args"]["resample_rate"]
    bins = configs["dataset_args"]["fbank_args"]["num_mel_bins"]
    embed = configs["model_args"]["embed_dim"]
    rng = np.random.default_rng(SEED + 36)
    with tempfile.TemporaryDirectory() as root:
        data = speaker_voices(root, rng)
        lap("corpus")
        torch.manual_seed(SEED)
        model = randomised_bn(build_model(configs), dev, True,
                              FbankConfig(num_mel_bins=bins,
                                          sample_rate=rate))
        base = model.state_dict()
        head = torch.nn.Linear(embed, 1211)  # a head the extractor drops
        models = os.path.join(root, "models")
        os.makedirs(models)
        sds = []
        for epoch in range(3):
            sd = perturbed(base, rng)
            sds.append(sd)
            ckpt_io.save_msgpack_checkpoint(
                os.path.join(models, f"model_{epoch}.ckpt"),
                {**to_jax_variables(sd, configs["model"]),
                 **to_jax_projection(head.state_dict())})
        del model
        avg_ckpt = os.path.join(models, "avg_model.ckpt")
        with contextlib.redirect_stdout(io.StringIO()):
            avg_cli.main(["--src_path", models, "--dst_model", avg_ckpt,
                          "--num", "3"])
        avg = {}
        for key, last in sds[-1].items():
            if last.is_floating_point():
                acc = sds[0][key].double()
                for sd in sds[1:]:
                    acc = acc + sd[key].double()
                avg[key] = (acc / len(sds)).float()
            else:
                avg[key] = last
        avg_pt = os.path.join(models, "avg_model.pt")
        torch.save({"state_dict": avg}, avg_pt)
        ckpt_mb = os.path.getsize(avg_ckpt) / 2 ** 20
        lap("checkpoints")

        n_batches = len(list(eval_batches(
            iter_wavs_from_list(data["train"], rate), batch_size=BACKEND_BATCH,
            quantum_samples=rate)))
        arks = {}
        for name, path in (("ckpt", avg_ckpt), ("pt", avg_pt)):
            zero_counts()
            extract_cli.main(["--config", SRE_CONFIG, "--checkpoint", path,
                              "--data_list", data["train"], "--out_prefix",
                              os.path.join(root, f"train_{name}"),
                              "--batch_size", str(BACKEND_BATCH)])
            torch.cuda.synchronize()
            if name == "ckpt":
                launches = counts()
            with open(os.path.join(root, f"train_{name}.ark"), "rb") as f:
                arks[name] = f.read()
            lap(f"extract_{name}")
        if launches != dict(NO_LAUNCH, masked=n_batches):
            raise AssertionError(f"backend extraction launched {launches}, "
                                 f"want masked={n_batches} (one a batch), "
                                 "no other")
        if arks["ckpt"] != arks["pt"]:
            raise AssertionError("backend: the .ckpt and .pt embeddings "
                                 "differ")
        emb = read_vec_scp_dict(os.path.join(root, "train_ckpt.scp"))
        vecs = np.stack(list(emb.values()))
        if vecs.shape != (BACKEND_TRAIN_SPK * BACKEND_UTT, embed) or not \
                np.isfinite(vecs).all():
            raise AssertionError(f"backend embeddings {vecs.shape}")
        scp = {"cts": os.path.join(root, "train_ckpt.scp")}
        for name in ("enroll", "test", "adapt"):
            extract_cli.main(["--config", SRE_CONFIG, "--checkpoint",
                              avg_ckpt, "--data_list", data[name],
                              "--out_prefix", os.path.join(root, name),
                              "--batch_size", str(BACKEND_BATCH)])
            scp[name] = os.path.join(root, name + ".scp")
        lap("extract_eval")

        dev_arg = ["--device", str(dev.type)]
        proc = os.path.join(root, "embd_proc.pkl")
        chain = (f"mean-subtract --scp {scp['adapt']} | length-norm | "
                 f"lda --scp {scp['cts']} --utt2spk "
                 f"{data['train_utt2spk']} --dim {BACKEND_LDA} | "
                 "length-norm")
        proc_cli.main(["prep", "--chain", chain, "--out", proc, *dev_arg])
        for name in list(scp):
            proc_cli.main(["apply", "--proc", proc, "--in_scp", scp[name],
                           "--out_prefix", os.path.join(root, name + "_proc"),
                           *dev_arg])
            scp[name + "_proc"] = os.path.join(root, name + "_proc.scp")
        lap("embd_proc")
        plda, adapted = (os.path.join(root, "plda.h5"),
                         os.path.join(root, "plda_adapt.h5"))
        plda_cli.main(["train", "--scp_path", scp["cts_proc"], "--utt2spk",
                       data["train_utt2spk"], "--model_path", plda,
                       "--embed_dim", str(BACKEND_LDA), *dev_arg])
        lap("plda_train")
        plda_cli.main(["adapt", "--model_path", plda, "--adapt_scp_path",
                       scp["adapt_proc"], "--out_model", adapted, *dev_arg])
        lap("plda_adapt")
        # the files are the JAX package's formats, and the port's readers
        # give back the models that the CLIs held in memory, to the bit
        mem_chain = EmbeddingProcessingChain(chain)
        mem_plda = TwoCovPLDA(BACKEND_LDA, normalize_length=True).train(
            read_spk2emb(scp["cts_proc"], data["train_utt2spk"]), 5)
        mem_adapted = mem_plda.adapt(np.vstack(list(read_vec_scp_dict(
            scp["adapt_proc"]).values())), 0.5, 0.5)
        heads = {}
        for path in (proc, plda, adapted):
            with open(path, "rb") as f:
                heads[os.path.basename(path)] = f.read(8)
        if heads["embd_proc.pkl"][:1] != pickle.PROTO or any(
                heads[k] != hdf5.SIGNATURE for k in ("plda.h5",
                                                     "plda_adapt.h5")):
            raise AssertionError(f"backend: file heads {heads}, want a "
                                 "pickle and two HDF5 files")
        file_chain = EmbeddingProcessingChain().load(proc)
        if [type(x) for x in file_chain.links] != \
                [type(x) for x in mem_chain.links] or any(
                sorted(vars(a)) != sorted(vars(b)) or any(
                    vars(a)[k].tobytes() != v.tobytes()
                    for k, v in vars(b).items())
                for a, b in zip(file_chain.links, mem_chain.links)):
            raise AssertionError("backend: embd_proc.pkl read back differs "
                                 "from the chain estimated in memory")
        for path, mem in ((plda, mem_plda), (adapted, mem_adapted)):
            got = TwoCovPLDA.load(path)
            for name in ("mu", "transform", "psi", "offset"):
                if getattr(got, name).tobytes() != \
                        getattr(mem, name).tobytes():
                    raise AssertionError(f"backend: {path} read back: "
                                         f"{name} differs from memory")
            if (got.normalize_length, got.subtract_train_set_mean) != (
                    mem.normalize_length, mem.subtract_train_set_mean):
                raise AssertionError(f"backend: {path} flags differ")
        h5_bytes = os.path.getsize(adapted)
        lap("files_check")
        eers = {}
        for name, model_path in (("plda", plda), ("plda_adapt", adapted)):
            score_file = os.path.join(root, name + ".score")
            with contextlib.redirect_stdout(io.StringIO()):
                plda_cli.main(["eval", "--enroll_scp_path",
                               scp["enroll_proc"], "--enroll_utt2spk",
                               data["enroll_utt2spk"], "--test_scp_path",
                               scp["test_proc"], "--trials", data["trials"],
                               "--score_path", score_file, "--model_path",
                               model_path, *dev_arg])
            lap(f"{name}_eval")
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                metrics_cli.main([score_file])
            eers[name] = smoke_quality.parse_metrics(printed.getvalue())[0]

        model = TwoCovPLDA.load(adapted)
        enroll = read_spk2emb(scp["enroll_proc"], data["enroll_utt2spk"])
        test = read_vec_scp_dict(scp["test_proc"])
        with open(data["trials"]) as f:
            pairs = [tuple(line.split()[:2]) for line in f]
        card = model.score_trials(enroll, test, pairs, device=dev)
        mem_card = mem_adapted.score_trials(enroll, test, pairs, device=dev)
        if not np.array_equal(card, mem_card):
            raise AssertionError(
                "backend: LLRs on the card from plda_adapt.h5 read back "
                "differ from the in-memory model's by up to "
                f"{np.abs(card - mem_card).max():.3g}")
        e, t_, n, ei, ti = model.trial_tables(enroll, test, pairs)
        f64 = _llr(torch.as_tensor(model.psi, dtype=torch.float64),
                   torch.as_tensor(e)[ei], torch.as_tensor(t_)[ti],
                   torch.as_tensor(n, dtype=torch.float64)[ei][:, None]
                   ).numpy()
        rel = np.abs(card - f64) / np.maximum(np.abs(f64), 1.0)
        raw_rel = np.abs(card - f64) / np.abs(f64)
        if not np.isfinite(card).all() or rel.max() > 1e-4:
            raise AssertionError(f"backend: LLR on the card vs f64 on the "
                                 f"CPU, max relative error {rel.max():.3g}")
        lap("llr_check")
    print(f"backend: {configs['model']} {bins}-bin fbank at {rate} Hz embed "
          f"{embed} TSTP ({os.path.basename(SRE_CONFIG)}); three perturbed "
          f"model_<n>.ckpt by the port's msgpack writer, bin/average_model.py "
          f"-> avg_model.ckpt ({ckpt_mb:.1f} MiB); bin/extract.py on "
          f"{len(emb)} training utterances at batch {BACKEND_BATCH}: .ckpt "
          f"and .pt arks byte-identical, launches masked="
          f"{launches['masked']} ({n_batches} batches) and none else; sre "
          f"v3 chain (LDA {BACKEND_LDA}) via bin/embd_proc.py, "
          f"bin/plda_tools.py train/adapt/eval on {len(pairs)} trials: "
          f"PLDA EER {eers['plda']:.3f}%, adapted {eers['plda_adapt']:.3f}% "
          f"(random model, no bar); embd_proc.pkl a pickle (protocol "
          f"{heads['embd_proc.pkl'][1]}), plda.h5 and plda_adapt.h5 HDF5 "
          f"({h5_bytes} bytes), each read back equal to "
          f"the in-memory model to the bit, the {len(pairs)} LLRs on the "
          f"card from plda_adapt.h5 equal the in-memory model's; LLR card "
          f"vs f64 CPU max error "
          f"{rel.max():.3g} of max(|LLR|, 1) (raw relative "
          f"{raw_rel.max():.3g}, |LLR| {np.abs(f64).min():.3g}-"
          f"{np.abs(f64).max():.3g}); seconds {json.dumps(secs)}; "
          f"{time.perf_counter() - t_start:.1f} s")


# the recipes' training stage (examples/voxceleb/v2/run.sh:34-45): packed
# MUSAN/RIR stores, then bin/train.py on the recipe YAMLs
V2_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "voxceleb", "v2", "conf")
AUG_BATCH, AUG_RIR = 128, 16000   # the aug phase: B x 2 s chunks, R
# ECAPA runs: steps, then the host-clock window before the last step
RECIPE_STEPS, RECIPE_TIMED = 14, 8


def write_aug_stores(root, rng):
    """Synthetic RIRs (decaying noise of 0.3-1 s) and MUSAN-like noise
    (3-8 s; keys noise-, music-, speech-), each a wav.scp packed by
    `python -m wespeaker_tpu_torch.bin.prep_data aug_store`; returns the
    two store prefixes."""
    prefixes = []
    for kind, keys in (
            ("rirs", [f"rir{i:02d}" for i in range(24)]),
            ("musan", [f"{k}-{i:02d}" for k in ("noise", "music", "speech")
                       for i in range(8)])):
        d = os.path.join(root, kind)
        os.makedirs(d)
        lines = []
        for key in keys:
            if kind == "rirs":
                n = int(rng.uniform(0.3, 1.0) * 16000)
                wav = rng.normal(0, 0.5, n) * np.exp(
                    -np.arange(n) / (rng.uniform(0.02, 0.2) * 16000))
                wav[0] = 1.0  # the direct path
            else:
                n = int(rng.uniform(3.0, 8.0) * 16000)
                tone = np.sin(2 * np.pi * rng.uniform(80, 2000)
                              * np.arange(n) / 16000)
                wav = 0.2 * tone + rng.uniform(-0.3, 0.3, n)
            path = os.path.join(d, f"{key}.wav")
            write_wav(path, np.clip(wav, -1, 1).astype(np.float32), 16000)
            lines.append(f"{key} {path}")
        with open(os.path.join(d, "wav.scp"), "w") as f:
            f.write("\n".join(lines) + "\n")
        prefix = os.path.join(root, f"{kind}_store")
        subprocess.run([sys.executable, "-m",
                        "wespeaker_tpu_torch.bin.prep_data", "aug_store",
                        "--wav_scp", os.path.join(d, "wav.scp"),
                        "--out_prefix", prefix], check=True, timeout=120,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
        prefixes.append(prefix)
    return tuple(prefixes)


def phase_aug(dev, smi, root):
    """The stores of write_aug_stores under `root`, returned; then
    device-side reverb/noise augmentation (train/device_aug.py) on the
    card against the port's CPU result on the same int16 store samples
    and host choices (data/pipeline.py::attach_device_aug, aug_prob 0.6,
    reverb rows packed first), B=128 x 32,240 samples, R=16,000: f32 max
    abs error <= 1e-4 of the peak, modes 0, 1 and 2 present, mode-0 rows
    bit-equal to the input; the card's step by CUDA events and the host
    path (augment_one on each row, the choices of the same generator
    seed) by the host clock."""
    t_start = time.perf_counter()
    stores = write_aug_stores(root, np.random.default_rng(SEED + 36))
    t_stores = time.perf_counter() - t_start
    reverb, noise = (PackedAudioStore(p) for p in stores)
    rng = np.random.default_rng(SEED + 37)
    samples = [{"key": str(i), "label": 0,
                "wav": (0.3 * np.sin(2 * np.pi * (120 + 3 * i)
                                     * np.arange(CHUNK_SAMPLES) / 16000)
                        + rng.uniform(-0.1, 0.1, CHUNK_SAMPLES)).astype(
                    np.float32)} for i in range(AUG_BATCH)]
    batch = next(batch_samples(attach_device_aug(
        [dict(s) for s in samples], reverb, noise, 0.6, AUG_RIR,
        np.random.default_rng(SEED + 38)), AUG_BATCH))
    mode = batch["aug_mode"]
    if not {0, 1, 2} <= set(mode.tolist()):
        raise AssertionError(f"aug modes {np.bincount(mode)}")
    names = ("wav", "aug_mode", "aug_rir", "aug_noise", "aug_snr")
    cpu = device_augment(*[torch.from_numpy(batch[k]) for k in names])
    args = [torch.from_numpy(batch[k]).to(dev) for k in names]
    got = device_augment(*args)
    torch.cuda.synchronize()
    peak = cpu.abs().max().item()
    err = (got.cpu() - cpu).abs().max().item()
    if not torch.isfinite(got).all() or err > 1e-4 * peak:
        raise AssertionError(f"device_augment: max abs error {err} > 1e-4 "
                             f"of the peak {peak}")
    if not torch.equal(got[torch.from_numpy(mode == 0).to(dev)].cpu(),
                       torch.from_numpy(batch["wav"][mode == 0])):
        raise AssertionError("device_augment changed a mode-0 row")
    card_ms = cuda_ms(lambda: device_augment(*args), iters=10, warmup=2)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        device_augment(*args)
        torch.cuda.synchronize()
    by_kernel = sorted(((profile_extract._device_us(e) / 1e3, e.key)
                        for e in prof.key_averages()), reverse=True)
    by_kernel = [r for r in by_kernel if r[0] > 0]
    dev_ms = sum(ms for ms, _ in by_kernel)
    augment_one(samples[0]["wav"], reverb, noise, rng)  # imports scipy
    host_rng = np.random.default_rng(SEED + 38)
    t0 = time.perf_counter()
    for s in samples:
        if host_rng.uniform() < 0.6:
            augment_one(s["wav"], reverb, noise, host_rng)
    host_ms = (time.perf_counter() - t0) * 1e3
    counts_by_mode = np.bincount(mode, minlength=3)
    print(f"aug [{smi}]: device_augment B={AUG_BATCH} x {CHUNK_SAMPLES} "
          f"samples, R={AUG_RIR}, int16 stores (modes none/reverb/noise "
          f"{counts_by_mode.tolist()}, reverb rows {batch['aug_rir'].shape[0]}"
          f" convolved): card vs CPU max abs error {err:.3g} (peak "
          f"{peak:.4f}), mode-0 rows bit-equal; card {card_ms:.3f} ms a "
          f"batch (CUDA events, 10 calls), one call by torch.profiler "
          f"{dev_ms:.3f} ms device over {len(by_kernel)} kernels, the "
          f"largest " + ", ".join(f"{k[:60]} {ms:.3f}"
                                   for ms, k in by_kernel[:3])
          + f"; host augment_one over the same {AUG_BATCH} rows (aug_prob "
          f"0.6, one process) {host_ms:.1f} ms; {t_stores:.1f} s for the "
          f"stores, {time.perf_counter() - t_start:.1f} s in all")
    return stores


def write_shards(root, rng, n_spk=16, n_utt=8, per_shard=16,
                 seconds=(2.5, 4.0)):
    """A synthetic corpus as the recipes read it: tar shards of
    <key>.wav + <key>.spk (PCM16 wavs of `seconds` long, 2.5-4 s by
    default, a tone per speaker plus noise), shard.list and utt2spk. 8
    shards by default, so that each of resnet34_sre.yaml's 8 workers gets
    one (a worker with an empty stripe yields nothing and never ends, as
    in the JAX package)."""
    import tarfile

    items = []
    for s in range(n_spk):
        tone = 2 * np.pi * (150 + 25 * s) / 16000
        for u in range(n_utt):
            n = int(rng.uniform(*seconds) * 16000)
            wav = (0.3 * np.sin(tone * np.arange(n))
                   + rng.uniform(-0.1, 0.1, n)).astype(np.float32)
            path = os.path.join(root, "utt.wav")
            write_wav(path, wav, 16000)
            with open(path, "rb") as f:
                items.append((f"spk{s:02d}-utt{u}", f"spk{s:02d}",
                              f.read()))
    shards = []
    for i in range(0, len(items), per_shard):
        path = os.path.join(root, f"shard{i // per_shard:03d}.tar")
        with tarfile.open(path, "w") as tf:
            for key, spk, data in items[i:i + per_shard]:
                for name, blob in ((f"{key}.wav", data),
                                   (f"{key}.spk", spk.encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(blob)
                    tf.addfile(info, io.BytesIO(blob))
        shards.append(path)
    for name, rows in (("shard.list", shards),
                       ("utt2spk", [f"{k} {s}" for k, s, _ in items])):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    return os.path.join(root, "shard.list"), os.path.join(root, "utt2spk")


@contextlib.contextmanager
def step_clock(warm=None, n=1):
    """Times the trainer's steps from the outside (none with warm None):
    TrainStep.__call__ is wrapped so that a host-clock window opens when
    step `warm` ends and closes when step warm + n ends (each edge after a
    synchronize), the batch fetches between them included, with no
    profiler running; then torch.profiler (CUDA activity) records the one
    step after the window for its device time. Yields a dict that gets
    "ms" (wall per step in the window), "dev_ms" (the profiled step's
    device kernel time), "busy" (dev_ms / ms) and "losses" (every step's
    loss tensor); the run needs warm + n + 1 steps."""
    from wespeaker_tpu_torch.train import train_step as ts

    out = {"losses": []}
    call = ts.TrainStep.__call__
    state = {}

    def timed(self, batch):
        metrics = call(self, batch)
        out["losses"].append(metrics["loss"])
        if warm is None:
            pass
        elif self.step == warm:
            torch.cuda.synchronize()
            state["t0"] = time.perf_counter()
        elif self.step == warm + n:
            torch.cuda.synchronize()
            out["ms"] = (time.perf_counter() - state["t0"]) * 1e3 / n
            state["prof"] = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            state["prof"].start()
        elif self.step == warm + n + 1:
            torch.cuda.synchronize()
            state["prof"].stop()
            out["dev_ms"] = sum(profile_extract._device_us(e) for e in
                                state["prof"].key_averages()) / 1e3
            out["busy"] = out["dev_ms"] / out["ms"]
        return metrics

    ts.TrainStep.__call__ = timed
    try:
        yield out
    finally:
        ts.TrainStep.__call__ = call


def run_recipe(conf, over, steps, batch, timed=0):
    """bin/train.py on a recipe YAML with overrides; the step count set by
    samples_per_epoch over one epoch. Checks every loss finite, the
    checkpoint written and loaded with its head; -> (TrainStep, the
    launches during the run, the step clock's dict)."""
    over = list(over) + ["num_epochs=1", f"dataset_args.batch_size={batch}",
                         f"samples_per_epoch={steps * batch}"]
    zero_counts()
    t0 = time.perf_counter()
    with step_clock(steps - timed - 1 if timed else None, timed) as clock:
        step = train_cli.train(conf, over, device="cuda")
    torch.cuda.synchronize()
    clock["s"] = time.perf_counter() - t0
    launches = counts()
    losses = [float(v) for v in clock["losses"]]
    if step.step != steps or len(losses) != steps \
            or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{conf}: {step.step} steps, losses {losses}")
    exp = parse_config_or_kwargs(conf, over)["exp_dir"]
    path = os.path.join(exp, "models", "model_0.pt")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    for part, mod in (("state_dict", step.model),
                      ("projection", step.projection)):
        for k, v in mod.state_dict().items():
            if not torch.equal(saved[part][k], v.cpu()):
                raise AssertionError(f"{path}: {part} {k} differs")
    clock["losses"] = losses
    return step, launches, clock


def host_pipeline_ms(conf, shard_list, utt2spk, stores, extra, n=4):
    """ms a batch of the recipe's host pipeline alone (SpeakerDataset over
    the shards, one process, no training) with the dataset_args changes
    `extra`: the mean over n batches after one warm-up batch."""
    configs = load_yaml(conf)
    args = {**configs["dataset_args"], **extra}
    ds = SpeakerDataset("shard", shard_list, args,
                        spk2id_from_utt2spk(utt2spk),
                        reverb_store_prefix=stores[0],
                        noise_store_prefix=stores[1], seed=SEED)
    it = ds.batches(args["batch_size"])
    next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    return (time.perf_counter() - t0) * 1e3 / n


def phase_recipe_train(dev, smi, stores, shard_root):
    """The recipes' training stage on the card: the stores of
    write_aug_stores, a shard corpus written into `shard_root`, bin/train.py
    on the YAMLs unchanged but for the corpus paths, the epoch and step
    counts, the batch size and the options the phase is about
    (num_workers, device_aug, conv_dw_mode, project_type); see the module
    docstring (phase 40). -> (shard.list, utt2spk) of the corpus."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 39)
    parts, timings = [], {}
    shard_list, utt2spk = write_shards(shard_root, rng)
    with tempfile.TemporaryDirectory() as root:
        with open(shard_list) as f:
            n_shards = len(f.read().split())
        corpus = [f"train_data={shard_list}", f"utt2spk={utt2spk}",
                  f"reverb_data={stores[0]}", f"noise_data={stores[1]}",
                  "data_type=shard"]
        ecapa = os.path.join(V2_CONF, "ecapa_tdnn_c512.yaml")
        host = {name: host_pipeline_ms(ecapa, shard_list, utt2spk, stores,
                                       extra)
                for name, extra in (
                    ("parse, filter, shuffle, chunk",
                     {"speed_perturb": False, "aug_prob": 0.0}),
                    ("+ speed perturb", {"aug_prob": 0.0}),
                    ("+ host aug", {}),
                    ("+ device-aug picks", {"device_aug": True}))}
        parts.append("host pipeline alone, ms a batch of 64 in one "
                     "process: " + ", ".join(f"{k} {v:.1f}"
                                              for k, v in host.items()))
        workers = max(1, min(4, (os.cpu_count() or 2) - 1))
        for name, extra in (
                ("host aug, one process", ["dataloader_args.num_workers=0"]),
                (f"host aug, {workers} workers",
                 [f"dataloader_args.num_workers={workers}"]),
                ("device aug", ["dataloader_args.num_workers=0",
                                "dataset_args.device_aug=true"])):
            step, launches, clock = run_recipe(
                ecapa,
                corpus + extra + [f"exp_dir={root}/ecapa_{len(timings)}"],
                RECIPE_STEPS, 64, timed=RECIPE_TIMED)
            want = dict(NO_LAUNCH, train_fwd=RECIPE_STEPS,
                        train_bwd=RECIPE_STEPS)
            if launches != want:
                raise AssertionError(f"ecapa {name}: launches {launches}, "
                                     f"want {want}")
            timings[name] = (clock["ms"], clock["busy"])
            parts.append(f"ECAPA_TDNN_GLOB_c512 {name}: {RECIPE_STEPS} "
                         f"steps, rows 4/5 x{launches['train_fwd']}, last "
                         f"loss {clock['losses'][-1]:.4f}, "
                         f"{clock['ms']:.1f} ms a step over {RECIPE_TIMED} "
                         f"steps before the last (host clock, no profiler),"
                         f" the last step {clock['dev_ms']:.3f} ms device "
                         f"(torch.profiler), {100 * clock['busy']:.1f}% "
                         f"device-busy ({clock['s']:.1f} s)")
        # the same step without its pipeline: one device-aug batch, held
        args = {**load_yaml(ecapa)["dataset_args"], "device_aug": True}
        fixed = next(SpeakerDataset(
            "shard", shard_list, args, spk2id_from_utt2spk(utt2spk),
            reverb_store_prefix=stores[0], noise_store_prefix=stores[1],
            seed=SEED).batches(args["batch_size"]))
        for _ in range(2):
            step(fixed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RECIPE_TIMED):
            step(fixed)
        torch.cuda.synchronize()
        alone = (time.perf_counter() - t0) * 1e3 / RECIPE_TIMED
        timings["step alone"] = (alone, None)
        parts.append(f"the device-aug step alone on a held batch: "
                     f"{alone:.1f} ms a step (host clock over "
                     f"{RECIPE_TIMED}); one more by torch.profiler: "
                     f"{fmt_device(*device_time(lambda: step(fixed)))}")
        del step
        for ptype in ("sphereface2", "arc_margin_intertopk_subcenter"):
            step, launches, clock = run_recipe(
                ecapa, corpus + ["dataloader_args.num_workers=0",
                                 f"projection_args.project_type={ptype}",
                                 f"exp_dir={root}/ecapa_{ptype}"], 3, 64)
            if launches["train_fwd"] != 3 or launches["train_bwd"] != 3:
                raise AssertionError(f"{ptype}: launches {launches}")
            parts.append(f"ECAPA {ptype}: losses "
                         + " ".join(f"{v:.3f}" for v in clock["losses"])
                         + f" ({clock['s']:.1f} s)")
            del step
        step, launches, clock = run_recipe(
            os.path.join(V2_CONF, "resnet.yaml"),
            corpus + ["conv_dw_mode=packed", f"exp_dir={root}/resnet"],
            3, 128)
        if launches != dict(NO_LAUNCH, dw=3 * DW_PER_STEP):
            raise AssertionError(f"resnet.yaml packed: launches {launches}")
        parts.append(f"resnet.yaml packed: 3 steps at B=128, row 10 "
                     f"x{launches['dw']}, losses "
                     + " ".join(f"{v:.3f}" for v in clock["losses"])
                     + f" ({clock['s']:.1f} s)")
        del step
        sre = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "sre", "v2", "conf",
                           "resnet34_sre.yaml")
        step, launches, clock = run_recipe(
            sre, corpus + [f"exp_dir={root}/sre"], 3, 256)
        bn = step.projection.trans_bn
        if int(bn.num_batches_tracked) != 3 or torch.all(
                bn.running_var == 1):
            raise AssertionError("resnet34_sre: the head's BatchNorm "
                                 "statistics were not carried")
        sre_workers = load_yaml(sre)["dataloader_args"]["num_workers"]
        if n_shards < sre_workers:
            raise AssertionError(f"{n_shards} shards for {sre_workers} "
                                 "workers: some would idle")
        parts.append(f"resnet34_sre.yaml (softmax head, {sre_workers} "
                     f"workers, 8 kHz): 3 steps at B=256, losses "
                     + " ".join(f"{v:.3f}" for v in clock["losses"])
                     + f", head BN tracked {int(bn.num_batches_tracked)} "
                     f"({clock['s']:.1f} s)")
        del step
    torch.cuda.empty_cache()
    print(f"recipe train [{smi}]: " + "; ".join(parts)
          + f"; {time.perf_counter() - t_start:.1f} s")
    return shard_list, utt2spk


class _CountingHandler(http.server.SimpleHTTPRequestHandler):
    """Serves a directory quietly and counts the GET requests."""
    gets = 0

    def do_GET(self):
        _CountingHandler.gets += 1
        super().do_GET()

    def log_message(self, *args):
        pass


def phase_http_shards(dev, smi, stores, shard_list, utt2spk):
    """The recipe train phase's shards streamed from a loopback http
    server; see the module docstring (phase 53)."""
    t_start = time.perf_counter()
    root = os.path.dirname(shard_list)
    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(_CountingHandler, directory=root))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        url_list = os.path.join(root, "http_shard.list")
        with open(shard_list) as f:
            urls = [f"{base}/{os.path.relpath(p, root)}"
                    for p in f.read().split()]
        with open(url_list, "w") as f:
            f.write("\n".join(urls) + "\n")
        ecapa = os.path.join(V2_CONF, "ecapa_tdnn_c512.yaml")
        args = load_yaml(ecapa)["dataset_args"]
        first = {name: next(SpeakerDataset(
            "shard", path, args, spk2id_from_utt2spk(utt2spk),
            reverb_store_prefix=stores[0], noise_store_prefix=stores[1],
            seed=SEED).batches(args["batch_size"]))
            for name, path in (("local", shard_list), ("http", url_list))}
        if first["http"]["key"] != first["local"]["key"] or sorted(
                first["http"]) != sorted(first["local"]) or any(
                not np.array_equal(first["http"][k], first["local"][k])
                for k in first["local"] if k != "key"):
            raise AssertionError("http shards: the first batch from the "
                                 "URLs differs from the local list's")
        gets_before = _CountingHandler.gets
        with tempfile.TemporaryDirectory() as exp:
            step, launches, clock = run_recipe(
                ecapa, [f"train_data={url_list}", f"utt2spk={utt2spk}",
                        f"reverb_data={stores[0]}",
                        f"noise_data={stores[1]}", "data_type=shard",
                        f"exp_dir={exp}/ecapa_http"], 3, 64)
            del step
        gets = _CountingHandler.gets - gets_before
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    want = dict(NO_LAUNCH, train_fwd=3, train_bwd=3)
    if launches != want:
        raise AssertionError(f"http shards: launches {launches}, want "
                             f"{want}")
    if gets < 1:
        raise AssertionError("http shards: the trainer fetched no URL")
    torch.cuda.empty_cache()
    print(f"http shards [{smi}]: {len(urls)} shards of the recipe train "
          f"phase served by a ThreadingHTTPServer on 127.0.0.1; the first "
          f"batch of {args['batch_size']} from the URLs equal to the local "
          f"list's (SpeakerDataset, the stores, seed {SEED}); "
          f"bin/train.py on ecapa_tdnn_c512.yaml (B=64, ArcMargin, host "
          f"aug) from the URL list: 3 steps, rows 4/5 "
          f"x{launches['train_fwd']}/{launches['train_bwd']}, losses "
          + " ".join(f"{v:.3f}" for v in clock["losses"])
          + f", {gets} shard GETs ({clock['s']:.1f} s); "
          f"{time.perf_counter() - t_start:.1f} s")


# ---- the rest of the model zoo (ERes2Net, Res2Net, RepVGG, the x-vector,
# the xi-vector, SimAM-ResNet, ReDimNet2) ----

def _launches(**want):
    return dict(NO_LAUNCH, **want)


# (name, constructor at its recipe's width, fbank bins, embed, the kernel
# launches of one eval forward); the recipes: examples/voxceleb/v2/conf/
# eres2net.yaml, res2net.yaml, repvgg.yaml, xvec.yaml, xi_vector.yaml,
# redimnet2.yaml, and SimAM_ResNet34_ASP at its constructor's defaults
ZOO = (("ERes2Net34_Base", lambda: ERes2Net34_Base(80, 512), 80, 512,
        _launches(masked=1)),
       ("Res2Net34_Base", lambda: Res2Net34_Base(80, 256), 80, 256,
        _launches(masked=1)),
       ("REPVGG_TINY_A0", lambda: REPVGG_TINY_A0(80, 256), 80, 256,
        _launches(masked=1)),
       ("XVEC", lambda: XVEC(80, embed_dim=512), 80, 512, _launches(masked=1)),
       ("XI_VEC_ECAPA_TDNN_c512", lambda: XI_VEC_ECAPA_TDNN_c512(80, 192),
        80, 192, _launches(se=3)),
       ("ReDimNet2B6", lambda: ReDimNet2B6(72, 192), 72, 192,
        _launches(softmax=1, masked=1)),
       ("SimAM_ResNet34_ASP", lambda: SimAM_ResNet34_ASP(), 80, 256,
        NO_LAUNCH))
# ERes2Net34_Base's packed dW calls a train step: the stem (1 -> 32) and
# the Res2 convs of layers 1-3 (3 x 2 at width 16, 4 x 2 at 32, 6 x 2 at
# 64: conv2_1 and convs.0); layer 4's width 128 is not eligible
ERES_DW_PER_STEP = 1 + 6 + 8 + 12
# row 10's new shapes at B=128 x 200 frames, (H, W, Ci, Co): ERes2Net34's
# and Res2Net34's width-16 Res2 convs, ERes2Net34_aug's width-24 ones and
# its 1 -> 64 stem (SimAM-ResNet34's too), the width-48 layer2 convs of
# ERes2Net34_aug and the 64-wide convs at layer3's 20 x 50 map
ZOO_DW = ((80, 200, 16, 16), (80, 200, 24, 24), (80, 200, 1, 64),
          (40, 100, 48, 48), (20, 50, 64, 64))
# the TSTP widths of row 7 on the new paths, (T', D) at 200 frames:
# ERes2Net34 and Res2Net34 (64 x 8 x 10), the x-vector (186 frames x 1500)
ZOO_TSTP = ((25, 5120), (186, 1500))
# Whisper-PMFA's ASTP with global context (rows 6 and 7): whisper-large-v2
# layers 16-23 side by side, D = 8 x 1280, at T = 100 (2 s) and 250 (5 s)
WHISPER_POOL = ((100, 10240), (250, 10240))


def zoo_model(make, feat, dev, calibrate):
    """A zoo model with torch's default init from SEED and randomised (or,
    with `calibrate`, synthetic-voice) BN statistics."""
    torch.manual_seed(SEED)
    return randomised_bn(make(), dev, calibrate,
                         FbankConfig(num_mel_bins=feat))


def set_plain(model, plain):
    """The plain route (pooling and ECAPA blocks layer by layer) or the
    kernel route."""
    set_pooling_fused(model, False if plain else None)
    if hasattr(model, "set_fused"):
        model.set_fused(not plain)
    return model


def phase_zoo_slice(dev):
    """Each zoo model at full width: its launches, the kernel route against
    the plain route in bf16 and f32, f32 on the card against the CPU on a
    calibrated copy, and its frame features' shape."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 40)
    wav = torch.as_tensor(np.stack([voice(rng, CHUNK_SAMPLES)
                                    for _ in range(SLICE_BATCH)]), device=dev)
    parts = []
    for name, make, feat, embed, want in ZOO:
        fb = FbankConfig(num_mel_bins=feat)
        model = zoo_model(make, feat, dev, calibrate=False)
        cos = {}
        for dtype in (torch.bfloat16, torch.float32):
            fn = make_eval_embed_fn(model, fb, compute_dtype=dtype,
                                    fbank_conv_dtype=dtype, device=dev)
            zero_counts()
            emb = fn({"wav": wav})
            torch.cuda.synchronize()
            if counts() != want:
                raise AssertionError(f"{name} {dtype}: launches {counts()}, "
                                     f"want {want}")
            set_plain(model, True)
            plain = fn({"wav": wav})
            set_plain(model, False)
            if emb.shape != (SLICE_BATCH, embed) or not torch.isfinite(
                    emb).all():
                raise AssertionError(f"{name}: embeddings {emb.shape}")
            cos[dtype] = row_cosines(emb, plain).min().item()
        if cos[torch.bfloat16] < 0.9999 or cos[torch.float32] < 0.99999:
            raise AssertionError(f"{name}: kernel vs plain route {cos}")
        with torch.inference_mode():
            feats = features_from_batch({"wav": wav[:2]}, fb, None, None,
                                        False, dev)
            frame = tuple(model(feats, return_frame_feat=True).shape)
        del model
        cal = zoo_model(make, feat, dev, calibrate=True)
        cpu_model = copy.deepcopy(cal).cpu()
        emb32 = make_eval_embed_fn(cal, fb, device=dev)({"wav": wav[:4]})
        cpu = make_eval_embed_fn(cpu_model, fb, device="cpu")(
            {"wav": wav[:4].cpu()})
        cos32 = row_cosines(emb32.cpu(), cpu).min().item()
        err32 = (emb32.cpu() - cpu).abs().max().item()
        cross = row_cosines(emb32[:-1], emb32[1:]).mean().item()
        if cos32 < 0.9999:
            raise AssertionError(f"{name}: f32 card vs CPU cosine {cos32}")
        launched = " ".join(f"{k}={v}" for k, v in want.items() if v) \
            or "none"
        parts.append(f"{name} (feat {feat}, embed {embed}) launches "
                     f"{launched}; kernel vs plain min cosine bf16 "
                     f"{cos[torch.bfloat16]:.7f} f32 "
                     f"{cos[torch.float32]:.7f}; calibrated f32 card vs "
                     f"CPU {cos32:.7f} (max abs err {err32:.3g}, between "
                     f"utterances {cross:.4f}); frame features {frame}")
        del cal, cpu_model
        torch.cuda.empty_cache()
    print(f"zoo slice: B={SLICE_BATCH} x {CHUNK_SAMPLES} samples, one "
          "forward a type: " + "; ".join(parts)
          + f"; {time.perf_counter() - t_start:.1f} s")


def phase_zoo_serving(dev):
    """A server from eres2net.yaml and a .pt of the calibrated
    ERes2Net34_Base: three waves of concurrent /embed requests in buckets
    of 1, 2 and 3 s; each reply against the same request padded and
    masked to its bucket (cosine >= 0.99999)."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 41)
    wavs = [voice(rng, n) for n in (12000, 16000, 20800, 27200, 32000,
                                    35200, 41600, 48000)]
    model = zoo_model(ZOO[0][1], 80, dev, calibrate=True)
    with open(os.path.join(V2_CONF, "eres2net.yaml")) as f:
        yaml_text = f.read()
    embs, served, launches = serve_waves(
        model, dev, [wavs[:2], wavs[2:5], wavs[5:]], yaml_text)
    if launches != dict(NO_LAUNCH, masked=len(served)):
        raise AssertionError(f"ERes2Net serving launches {launches} for "
                             f"{len(served)} batches")
    if sorted({n for _, n in served}) != [16000, 32000, 48000]:
        raise AssertionError(f"served buckets {served}")
    fn = make_eval_embed_fn(model, FbankConfig(), device=dev)
    bucket = []
    for w in wavs:
        n = -(-len(w) // 16000) * 16000
        padded, mask = np.zeros((1, n), np.float32), np.zeros((1, n),
                                                              np.float32)
        padded[0, :len(w)], mask[0, :len(w)] = w, 1.0
        bucket.append(fn({"wav": padded, "mask": mask}).cpu())
    vs_bucket = row_cosines(embs, torch.cat(bucket))
    if vs_bucket.min().item() < 0.99999:
        raise AssertionError(f"ERes2Net served replies vs bucket "
                             f"{vs_bucket}")
    print(f"zoo serving: ERes2Net34_Base from eres2net.yaml + .pt (BN "
          f"statistics from synthetic voices), {len(wavs)} /embed "
          f"(0.75-3 s) in three concurrent waves; batches {served}, "
          f"launches masked={launches['masked']}; min cosine vs the bucket "
          f"embedded directly {vs_bucket.min().item():.7f}; "
          f"{time.perf_counter() - t_start:.1f} s")


def zoo_modules(make, embed, head, dev):
    return build_train_state(
        lambda: (make(), get_projection({
            "project_type": head, "embed_dim": embed,
            "num_class": NUM_CLASS, "scale": 32.0})),
        RESNET_SGD, seed=SEED, device=dev)


def phase_zoo_train(dev, root, corpus):
    """bin/train.py on eres2net.yaml with conv_dw_mode packed (B=128, 3
    steps), the extractor on its checkpoint; 3 bf16 steps in-process for
    the other six models (B=32, ReDimNet2B6 with its sphereface2 head);
    one step packed against one native for ERes2Net34_Base in bf16 and
    f32 at B=32 (loss within 1e-3 relative, each layer's update at cosine
    >= 0.999)."""
    t_start = time.perf_counter()
    parts = []
    exp = os.path.join(root, "eres2net")
    step, launches, clock = run_recipe(
        os.path.join(V2_CONF, "eres2net.yaml"),
        corpus + ["conv_dw_mode=packed", f"exp_dir={exp}"], 3, RESNET_BATCH,
        timed=1)
    conv_dw_pack.set_conv_dw_mode("native")
    if launches != dict(NO_LAUNCH, dw=3 * ERES_DW_PER_STEP):
        raise AssertionError(f"eres2net.yaml packed: launches {launches}, "
                             f"want dw={3 * ERES_DW_PER_STEP}")
    del step
    loaded = load_model_for_eval(load_yaml(os.path.join(exp, "config.yaml")),
                                 os.path.join(exp, "models", "model_0.pt"),
                                 device=dev)
    emb = make_eval_embed_fn(loaded, FbankConfig(), device=dev)(
        {"wav": np.random.default_rng(SEED + 42).uniform(
            -0.5, 0.5, (1, 48000)).astype(np.float32)})
    if emb.shape != (1, 512) or not torch.isfinite(emb).all():
        raise AssertionError(f"eres2net.yaml checkpoint embedding {emb}")
    del loaded
    parts.append(f"bin/train.py eres2net.yaml conv_dw_mode packed bf16 "
                 f"B={RESNET_BATCH}: 3 steps, row 10 "
                 f"{launches['dw'] // 3} a step, losses "
                 + " ".join(f"{v:.3f}" for v in clock["losses"])
                 + f", {clock['ms']:.1f} ms the second step (host clock), "
                 f"the third {clock['dev_ms']:.2f} ms device "
                 f"({clock['s']:.1f} s with start-up); the extractor on "
                 f"model_0.pt gave a (1, 512) embedding")
    # redimnet2.yaml unchanged: its tfmel frontend and sphereface2 head
    exp = os.path.join(root, "redimnet2")
    step, launches, clock = run_recipe(
        os.path.join(V2_CONF, "redimnet2.yaml"),
        corpus + [f"exp_dir={exp}"], 2, TRAINER_BATCH)
    if launches != NO_LAUNCH or step.featurize_fn is None:
        raise AssertionError(f"redimnet2.yaml: launches {launches}, "
                             "want none, through the tfmel hook")
    del step
    configs = load_yaml(os.path.join(exp, "config.yaml"))
    loaded = load_model_for_eval(configs, os.path.join(
        exp, "models", "model_0.pt"), device=dev)
    zero_counts()
    emb = make_eval_embed_fn(loaded, FbankConfig(), device=dev,
                             featurize_fn=featurizers(configs)[1])(
        {"wav": np.random.default_rng(SEED + 47).uniform(
            -0.5, 0.5, (2, 48000)).astype(np.float32)})
    torch.cuda.synchronize()
    if emb.shape != (2, 192) or not torch.isfinite(emb).all() or \
            counts() != dict(NO_LAUNCH, softmax=1, masked=1):
        raise AssertionError(f"redimnet2.yaml checkpoint: {emb.shape}, "
                             f"launches {counts()}")
    del loaded
    parts.append(f"bin/train.py redimnet2.yaml (tfmel frontend, "
                 f"sphereface2) B={TRAINER_BATCH}: 2 steps, losses "
                 + " ".join(f"{v:.3f}" for v in clock["losses"])
                 + f" ({clock['s']:.1f} s); the extractor through tfmel "
                 "on model_0.pt gave (2, 192), rows 6 and 7 once")
    rng = np.random.default_rng(SEED + 43)
    batch = train_batch(rng, TRAINER_BATCH, dev)
    for name, make, feat, embed, _ in ZOO[1:]:
        head = "sphereface2" if name.startswith("ReDimNet2") else "arc_margin"
        model, proj, opt, gen = zoo_modules(make, embed, head, dev)
        one = make_train_step(model, proj, opt, lambda s: 0.1, lambda s: 0.2,
                              FbankConfig(num_mel_bins=feat, dither=1.0),
                              AugConfig(), compute_dtype=torch.bfloat16,
                              device=dev, generator=gen)
        zero_counts()
        t0 = time.perf_counter()
        losses = [float(one(batch)["loss"]) for _ in range(3)]
        sec = time.perf_counter() - t0
        if not all(np.isfinite(losses)) or counts() != NO_LAUNCH:
            raise AssertionError(f"{name} train steps: losses {losses}, "
                                 f"launches {counts()}")
        parts.append(f"{name} + {head} losses "
                     + " ".join(f"{v:.3f}" for v in losses)
                     + f" ({sec:.1f} s)")
        del model, proj, opt, one
        torch.cuda.empty_cache()
    bad = []
    for dtype in (torch.bfloat16, torch.float32):
        rel, worst, _ = compare_dw_modes(
            dev, batch, dtype, lambda d: zoo_modules(ZOO[0][1], 512,
                                                     "arc_margin", d),
            ERES_DW_PER_STEP)
        parts.append(f"ERes2Net34_Base packed vs native {str(dtype)[6:]} "
                     f"B={TRAINER_BATCH}: loss rel {rel:.2e}, update cosine "
                     "per layer lowest "
                     + ", ".join(f"{n} {c:.6f}" for n, c in worst))
        if rel > 1e-3 or worst[0][1] < 0.999:
            bad.append(str(dtype))
    torch.cuda.empty_cache()
    print("zoo train: " + "; ".join(parts)
          + f"; {time.perf_counter() - t_start:.1f} s")
    if bad:
        raise AssertionError(f"ERes2Net packed and native steps disagree "
                             f"in {bad}")
    return launches


def phase_repvgg_deploy(dev, root, corpus):
    """repvgg.yaml: bin/train.py (3 steps); its model_0.pt with BN
    statistics from synthetic voices (three steps leave them near their
    init, and 33 unnormalised three-branch blocks then give embeddings of
    ~1e9), saved as a .pt; bin/convert_repvgg.py on it, bin/extract.py
    with the train form and with `deploy: true` in f32 over 8 utterances,
    one batch and so one row 7 launch each. Deploy against train form at
    cosine >= 0.99999; and, since three steps leave the utterances'
    embeddings nearly collinear (neighbours at cosine ~0.9997) so that
    the cosine bar alone cannot tell a wrong fusion, each utterance's
    deploy error within 1e-3 of the nearest distance between two
    utterances' train-form embeddings."""
    t_start = time.perf_counter()
    exp = os.path.join(root, "repvgg")
    step, _, clock = run_recipe(os.path.join(V2_CONF, "repvgg.yaml"),
                                corpus + [f"exp_dir={exp}"], 3, 64)
    del step
    config = os.path.join(exp, "config.yaml")
    model = load_model_for_eval(load_yaml(config), os.path.join(
        exp, "models", "model_0.pt"), device=dev)
    trained = os.path.join(exp, "models", "calibrated.pt")
    torch.save(calibrate_bn(model, dev).state_dict(), trained)
    del model
    rng = np.random.default_rng(SEED + 44)
    eval_list = os.path.join(root, "repvgg_eval.list")
    with open(eval_list, "w") as f:
        for i in range(8):
            path = os.path.join(root, f"rep{i}.wav")
            write_wav(path, voice(rng, int(rng.uniform(1.5, 3.0) * 16000)),
                      16000)
            f.write(json.dumps({"key": f"rep{i}", "wav": path}) + "\n")
    deployed = os.path.join(exp, "models", "deploy.pt")
    with contextlib.redirect_stdout(io.StringIO()):
        convert_repvgg.main(["--checkpoint", trained, "--save_path",
                             deployed])
    embs, launches = {}, {}
    for form, ckpt, over in (("train", trained, []),
                             ("deploy", deployed, ["model_args.deploy=true"])):
        zero_counts()
        extract_cli.main(["--config", config, "--checkpoint", ckpt,
                          "--data_list", eval_list, "--out_prefix",
                          os.path.join(root, f"rep_{form}"),
                          "--batch_size", "8"] + over)
        torch.cuda.synchronize()
        launches[form] = counts()["masked"]
        embs[form] = read_vec_scp_dict(os.path.join(root,
                                                    f"rep_{form}.scp"))
    keys = sorted(embs["train"])
    got = torch.tensor(np.stack([embs["deploy"][k] for k in keys]))
    want = torch.tensor(np.stack([embs["train"][k] for k in keys]))
    cos = row_cosines(got, want).min().item()
    cross = row_cosines(want[:-1], want[1:]).mean().item()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    dist = torch.cdist(want, want).fill_diagonal_(torch.inf)
    apart = (got - want).norm(dim=1).max().item() / dist.min().item()
    print(f"repvgg deploy: repvgg.yaml 3 steps at B=64 (losses "
          + " ".join(f"{v:.3f}" for v in clock["losses"])
          + f"), BN statistics from synthetic voices, bin/convert_repvgg.py, "
          f"bin/extract.py f32 over 8 utterances of 1.5-3 s: deploy vs train "
          f"form min cosine {cos:.7f} (max abs err {rel:.3g} of the largest "
          f"magnitude {want.abs().max().item():.3g}; train form between "
          f"neighbouring utterances {cross:.4f}; largest deploy error "
          f"{apart:.3g} of the nearest distance between two utterances); "
          f"row 7 launches train "
          f"{launches['train']} deploy {launches['deploy']}; "
          f"{time.perf_counter() - t_start:.1f} s")
    if len(keys) != 8 or cos < 0.99999:
        raise AssertionError(f"RepVGG deploy vs train form: {len(keys)} "
                             f"keys, min cosine {cos}")
    if not apart <= 1e-3:
        raise AssertionError(f"RepVGG deploy error {apart} of the nearest "
                             "distance between two utterances, want <= 1e-3")
    if launches != {"train": 1, "deploy": 1}:
        raise AssertionError(f"RepVGG extraction: row 7 launches "
                             f"{launches}, want one a batch")


def phase_zoo_timing(dev, smi):
    """ERes2Net34_Base and XVEC extraction at B=512 x 2 s bf16, with row 7
    (the kernel route) and then without it (plain pooling): audio-s/s
    from CUDA events over 5 calls after 2."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 45)
    wav = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, CHUNK_SAMPLES)).astype(
        np.float32), device=dev)
    io_t = torch.bfloat16
    parts, out = [], {}
    for name, make, feat, _, _ in (ZOO[0], ZOO[3]):
        model = zoo_model(make, feat, dev, calibrate=False)
        embed = make_eval_embed_fn(model, FbankConfig(num_mel_bins=feat),
                                   compute_dtype=io_t, fbank_conv_dtype=io_t,
                                   device=dev)
        rates = {}
        for route in ("row 7", "plain pooling"):
            set_pooling_fused(model, False if route == "plain pooling"
                              else None)
            ms = cuda_ms(lambda: embed({"wav": wav}), iters=5, warmup=2)
            rates[route] = (B * CHUNK_SECONDS / (ms / 1e3), ms)
        out[name] = rates
        parts.append(f"{name} " + ", ".join(
            f"{k} {v[0]:.1f} audio-s/s ({v[1]:.2f} ms/batch)"
            for k, v in rates.items()))
        del model, embed
        torch.cuda.empty_cache()
    print(f"zoo timing [{smi}] extraction B={B} x 2 s bf16: "
          + "; ".join(parts) + f"; {time.perf_counter() - t_start:.1f} s")
    return out


# the neural frontends' recipes: each family's YAMLs as the recipes ship
# them; the first is the one extracted and served
V1_WHISPER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "voxceleb", "v1", "Whisper-PMFA",
                          "conf")
FRONTEND_FAMILIES = (
    ("WavLM + ECAPA", V2_CONF,
     ("ecapa_wavlm_joint_ft.yaml", "ecapa_wavlm_frozen.yaml",
      "ecapa_wavlm_joint_lmft.yaml"),
     dict(NO_LAUNCH, se=3, tail=1), dict(NO_LAUNCH, train_fwd=1,
                                         train_bwd=1)),
    ("Whisper-PMFA", V1_WHISPER,
     ("whisper_pmfa_stage2.yaml", "whisper_pmfa_stage1.yaml"),
     dict(NO_LAUNCH, softmax=1, masked=1), NO_LAUNCH),
    ("w2v-bert + adapter-MFA", V2_CONF,
     ("w2vbert_s2_ft.yaml", "w2vbert_s1.yaml", "w2vbert_s3_lmft.yaml"),
     NO_LAUNCH, NO_LAUNCH))
FRONTEND_B = 64        # the timing batch: B x 2 s
FRONTEND_LIST = (1.3, 3.1, 2.2, 1.7, 2.9, 2.5)  # the ragged list, seconds


def frontend_model(conf, dev):
    """The recipe's composite at its full width, built on the card with
    flax's init from SEED, in eval mode."""
    configs = load_yaml(conf)
    torch.manual_seed(SEED)
    return configs, build_model(configs, device=dev).eval()


def frontend_route(model, plain):
    """The kernel route (plain False: ECAPA's fused blocks and tail, the
    pooling kernels) or the plain one."""
    set_pooling_fused(model, False if plain else None)
    if hasattr(model.speaker_model, "set_fused"):
        model.speaker_model.set_fused(not plain)
    return model


def frontend_embeds(model, configs, utts, dev, dtype, batch_size=4):
    """{key: embedding} of (key, wav) utts in extraction buckets
    (eval_batches, masks), through the frontend's eval hook."""
    fn = make_eval_embed_fn(model, compute_dtype=dtype, device=dev,
                            featurize_fn=featurizers(configs)[1])
    out = {}
    for batch in eval_batches(iter(utts), batch_size=batch_size,
                              quantum_samples=16000):
        out.update(zip(batch["key"], fn(batch).cpu()))
    return out


def stacked(d, keys):
    return torch.stack([d[k] for k in keys])


def direct_miss(got, direct, keys, utts, model, configs, dev):
    """What the frontend slice prints when bin/extract.py's embeddings
    miss the same buckets embedded directly: the lowest row's key, length
    and bucket (its batch of eval_batches and padded samples), that
    utterance embedded alone in a bucket of its padded length against the
    extraction and against the direct row, and the direct buckets
    embedded again against themselves (run-to-run agreement)."""
    cos = row_cosines(got, stacked(direct, keys))
    i = int(cos.argmin())
    key, wav = keys[i], dict(utts)[keys[i]]
    batch_no, n = next(
        (j, b["wav"].shape[1]) for j, b in enumerate(eval_batches(
            iter(utts), batch_size=4, quantum_samples=16000))
        if key in b["key"])
    fn = make_eval_embed_fn(model, compute_dtype=torch.bfloat16, device=dev,
                            featurize_fn=featurizers(configs)[1])
    padded, mask = np.zeros((1, n), np.float32), np.zeros((1, n), np.float32)
    padded[0, :len(wav)], mask[0, :len(wav)] = wav, 1.0
    alone = fn({"wav": padded, "mask": mask}).cpu()[0]
    again = frontend_embeds(model, configs, utts, dev, torch.bfloat16)
    rerun = row_cosines(stacked(again, keys), stacked(direct, keys)).min()
    return (f"MISS: lowest row {key} ({len(wav)} samples, batch {batch_no} "
            f"padded to {n}) at {cos[i].item():.7f}; alone in a bucket of "
            f"{n} vs the extraction {cosine(alone, got[i]):.7f}, vs the "
            f"direct row {cosine(alone, direct[key]):.7f}; the direct "
            f"buckets embedded again vs themselves {rerun.item():.7f}")


def phase_frontend_slice(dev, root, smi):
    """The three families at their YAMLs' widths, random weights from
    SEED: bin/extract.py --bf16 on a ragged list of 6 utterances (1.3-3.1
    s, batches of 4) with each batch's launches (rows 1 x3 and 2 for
    WavLM + ECAPA; rows 6 and 7 at D = 10,240 for Whisper-PMFA; none for
    w2v-bert's plain ASP), its embeddings against the same buckets
    embedded directly (>= 0.99999) and the kernel route against the plain
    route in bf16 (>= 0.9999); f32 on the card against the CPU on two
    utterances (>= 0.99999); WavLM: the raw waveform rounded to bf16
    before the first conv against f32 (>= 0.9999), and the whole bf16
    path against f32 recorded; a server from the YAML and a .pt answering
    6 /embed requests in two waves (replies against the bucket embedded
    directly, >= 0.99999) and /diarize with 501; extraction audio-s/s at
    B=64 x 2 s bf16, the median of 5 readings (one reading of WavLM +
    ECAPA ran 28% slow on an H100)."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 48)
    utts = [(f"fe{i}", voice(rng, int(s * 16000)))
            for i, s in enumerate(FRONTEND_LIST)]
    lst = os.path.join(root, "frontend.list")
    with open(lst, "w") as f:
        for key, wav in utts:
            path = os.path.join(root, f"{key}.wav")
            write_wav(path, wav, 16000)
            f.write(json.dumps({"key": key, "wav": path}) + "\n")
    # as the extractor reads them (PCM16)
    utts = list(iter_wavs_from_list(lst, read_threads=1))
    keys = [k for k, _ in utts]
    n_batches = len(list(eval_batches(iter(utts), batch_size=4,
                                      quantum_samples=16000)))
    timing_wav = rng.uniform(-0.5, 0.5, (FRONTEND_B, CHUNK_SAMPLES)).astype(
        np.float32)
    parts, rates, out = [], {}, {}
    for family, conf_dir, yamls, per_forward, _ in FRONTEND_FAMILIES:
        t0 = time.perf_counter()
        conf = os.path.join(conf_dir, yamls[0])
        configs, model = frontend_model(conf, dev)
        n_params = sum(p.numel() for p in model.parameters())
        ckpt = os.path.join(root, "frontend.pt")
        ckpt_io.save_checkpoint(ckpt, model)
        prefix = os.path.join(root, "frontend_emb")
        zero_counts()
        extract_cli.main(["--config", conf, "--checkpoint", ckpt,
                          "--data_list", lst, "--out_prefix", prefix,
                          "--batch_size", "4", "--bf16"])
        torch.cuda.synchronize()
        launches = counts()
        want = {k: v * n_batches for k, v in per_forward.items()}
        if launches != want:
            raise AssertionError(f"{family} extraction launches {launches}, "
                                 f"want {want} ({n_batches} batches)")
        ark = read_vec_scp_dict(prefix + ".scp")
        got = torch.tensor(np.stack([ark[k] for k in keys]))
        kern = frontend_embeds(frontend_route(model, False), configs, utts,
                               dev, torch.bfloat16)
        plain = frontend_embeds(frontend_route(model, True), configs, utts,
                                dev, torch.bfloat16)
        frontend_route(model, False)
        vs_direct = row_cosines(got, stacked(kern, keys)).min().item()
        vs_plain = row_cosines(stacked(kern, keys),
                               stacked(plain, keys)).min().item()
        cross = row_cosines(got[:-1], got[1:]).mean().item()
        # f32: the card (kernel route) against a CPU copy, two utterances
        two = utts[:2]
        card = frontend_embeds(model, configs, two, dev, torch.float32)
        cpu_model = copy.deepcopy(model).cpu()
        host = frontend_embeds(cpu_model, configs, two, "cpu",
                               torch.float32)
        del cpu_model
        vs_cpu = row_cosines(stacked(card, keys[:2]),
                             stacked(host, keys[:2])).min().item()
        line = (f"{family} ({os.path.basename(conf)}, {n_params / 1e6:.1f}M "
                f"parameters): bin/extract.py bf16 over {len(utts)} "
                f"utterances in {n_batches} batches, launches "
                + (" ".join(f"{k}={v}" for k, v in launches.items() if v)
                   or "none")
                + f"; vs the buckets embedded directly {vs_direct:.7f}, "
                f"kernel vs plain route bf16 {vs_plain:.7f}, f32 card vs "
                f"CPU {vs_cpu:.7f}, neighbouring utterances {cross:.4f}")
        if vs_direct < 0.99999:
            line += "; " + direct_miss(got, kern, keys, utts, model,
                                       configs, dev)
        bad = vs_direct < 0.99999 or vs_plain < 0.9999 or vs_cpu < 0.99999
        if family.startswith("WavLM"):
            # the raw waveform rounded to bf16 before the first conv, the
            # rest in f32; and the whole bf16 path, both against f32
            wav = torch.as_tensor(np.stack([w[:32000] for _, w in utts
                                            if len(w) >= 32000]), device=dev)
            with torch.inference_mode():
                f32 = model(wav)
                rounded = model(wav.bfloat16().float())
                bf16 = model(wav.bfloat16()).float()
            cast = row_cosines(rounded, f32).min().item()
            whole = row_cosines(bf16, f32).min().item()
            line += (f"; the waveform rounded to bf16 vs f32 {cast:.7f}, "
                     f"the whole bf16 path vs f32 {whole:.7f}")
            bad = bad or cast < 0.9999
        # the server: two waves of concurrent requests from the YAML + .pt
        waves = [[w for _, w in utts[:3]], [w for _, w in utts[3:]]]
        with open(conf) as f:
            yaml_text = f.read()
        status = {}
        replies, served, s_launches = serve_waves(
            model, dev, waves, yaml_text,
            probe=lambda url: diarize_status(url, status))
        want = {k: v * len(served) for k, v in per_forward.items()}
        bucket = []
        fn = make_eval_embed_fn(model, device=dev,
                                featurize_fn=featurizers(configs)[1])
        for _, w in utts:
            n = -(-len(w) // 16000) * 16000
            padded, mask = np.zeros((1, n), np.float32), np.zeros(
                (1, n), np.float32)
            padded[0, :len(w)], mask[0, :len(w)] = w, 1.0
            bucket.append(fn({"wav": padded, "mask": mask}).cpu())
        vs_bucket = row_cosines(replies, torch.cat(bucket)).min().item()
        line += (f"; server: batches {[tuple(s) for s in served]}, launches "
                 + (" ".join(f"{k}={v}" for k, v in s_launches.items() if v)
                    or "none")
                 + f", replies vs the bucket embedded directly "
                 f"{vs_bucket:.7f}")
        bad = bad or vs_bucket < 0.99999 or s_launches != want
        line += f", /diarize {status.get('diarize')}"
        bad = bad or status.get("diarize") != 501
        # timing: B=64 x 2 s bf16 through the kernel route
        embed = make_eval_embed_fn(model, compute_dtype=torch.bfloat16,
                                   device=dev,
                                   featurize_fn=featurizers(configs)[1])
        readings = [cuda_ms(lambda: embed({"wav": timing_wav}), iters=3,
                            warmup=1) for _ in range(5)]
        ms = float(np.median(readings))
        rates[family] = (FRONTEND_B * CHUNK_SECONDS / (ms / 1e3), ms,
                         min(readings), max(readings))
        line += f"; {time.perf_counter() - t0:.1f} s"
        parts.append(line)
        out[family] = {"direct": vs_direct, "plain": vs_plain,
                       "cpu": vs_cpu}
        del model, embed, fn
        torch.cuda.empty_cache()
        if bad:
            print("frontend slice: " + "; ".join(parts))
            raise AssertionError(f"{family}: {line}")
    print("frontend slice: " + "; ".join(parts)
          + f"; {time.perf_counter() - t_start:.1f} s")
    print(f"frontend timing [{smi}] extraction B={FRONTEND_B} x 2 s bf16 "
          "(CUDA events, median of 5 readings of 3 calls after 1): "
          + "; ".join(
              f"{k} {v[0]:.1f} audio-s/s ({v[1]:.2f} ms/batch, readings "
              f"{v[2]:.2f}-{v[3]:.2f})" for k, v in rates.items()))
    return out


def diarize_status(url, out):
    """POST /diarize to the server at `url`; its HTTP status into
    out["diarize"] (a neural frontend's server answers 501, as the JAX
    package builds no diarize for it)."""
    import urllib.error

    try:
        _post(f"{url}/diarize", {"wav": [0.0] * 16000,
                                 "sample_rate": 16000})
        out["diarize"] = 200
    except urllib.error.HTTPError as e:
        out["diarize"] = e.code


@contextlib.contextmanager
def frontend_before_steps():
    """Yields a dict that gets "frontend": the model's frontend
    parameters (cloned) as the first train step starts."""
    from wespeaker_tpu_torch.train import train_step as ts

    out = {}
    call = ts.TrainStep.__call__

    def first(self, batch):
        if "frontend" not in out:
            out["frontend"] = {k: v.detach().clone() for k, v in
                               self.model.frontend.state_dict().items()}
        return call(self, batch)

    ts.TrainStep.__call__ = first
    try:
        yield out
    finally:
        ts.TrainStep.__call__ = call


def phase_frontend_train(dev, root, stores, smi):
    """bin/train.py on each family's YAMLs unchanged but for the corpus
    (write_shards at 4.2-6.5 s, so that w2vbert_s3_lmft.yaml's 4 s minimum
    keeps every utterance, and the aug phase's stores), 3 steps at each
    YAML's own batch size: every loss finite, rows 4 and 5 once a step
    under WavLM + ECAPA and no launch under the others, a frozen
    frontend's parameters bit-identical after the steps and a joint one's
    moved, the second step's wall ms (host clock) and the third's device
    ms."""
    t_start = time.perf_counter()
    corpus_dir = os.path.join(root, "frontend_corpus")
    os.makedirs(corpus_dir)
    shard_list, utt2spk = write_shards(
        corpus_dir, np.random.default_rng(SEED + 49), n_spk=8, n_utt=8,
        seconds=(4.2, 6.5))
    corpus = [f"train_data={shard_list}", f"utt2spk={utt2spk}",
              f"reverb_data={stores[0]}", f"noise_data={stores[1]}"]
    parts, bad, steps_ms = [], [], {}
    for family, conf_dir, yamls, _, per_step in FRONTEND_FAMILIES:
        for name in yamls:
            conf = os.path.join(conf_dir, name)
            configs = load_yaml(conf)
            batch = configs["dataset_args"]["batch_size"]
            frontend = configs["dataset_args"]["frontend"]
            frozen = configs["dataset_args"][f"{frontend}_args"].get(
                "frozen", False)
            exp = os.path.join(root, "frontend_exp")
            with frontend_before_steps() as before:
                step, launches, clock = run_recipe(
                    conf, corpus + [f"exp_dir={exp}"], 3, batch, timed=1)
            after = step.model.frontend.state_dict()
            same = all(torch.equal(after[k], v)
                       for k, v in before["frontend"].items())
            want = {k: 3 * v for k, v in per_step.items()}
            parts.append(
                f"{name} B={batch} ({'frozen' if frozen else 'joint'}): "
                "losses " + " ".join(f"{v:.3f}" for v in clock["losses"])
                + ", launches " + (" ".join(f"{k}={v}" for k, v in
                                            launches.items() if v)
                                   or "none")
                + f", frontend {'unchanged' if same else 'moved'}, "
                f"{clock['ms']:.1f} ms the second step, "
                f"{clock['dev_ms']:.2f} ms device the third "
                f"({clock['s']:.1f} s)")
            steps_ms[name] = (clock["ms"], clock["dev_ms"])
            if launches != want or same != frozen:
                bad.append(name)
            del step, after, before
            shutil.rmtree(exp)
            torch.cuda.empty_cache()
    print(f"frontend train [{smi}]: " + "; ".join(parts)
          + f"; {time.perf_counter() - t_start:.1f} s")
    if bad:
        raise AssertionError(f"frontend train: {bad} launched other "
                             "kernels or moved a frozen frontend (or left "
                             "a joint one)")
    return steps_ms


DEPLOY_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "voxceleb", "v2", "conf",
                           "ecapa_tdnn_c512.yaml")
DEPLOY_BATCH = 64  # the YAML's own
DEPLOY_SHAPES = ((64, 200), (1, 137))
# the families whose eval route holds rows 3 and 6-9, each exported to a
# .pt2 at full width with seeded weights: (name, its YAML under
# DEPLOY_CONF's directory, overrides, the launches of one eval forward,
# eager's and the .pt2's on the card). Gemini is the YAML's widths at
# Gemini_DF_ResNet60's depth (3, 3, 9, 3 blocks): the same four stage
# calls, and a shorter phase
DEPLOY_FAMILIES = (
    ("CAMPPlus", "campplus.yaml", (), dict(cam=3, masked=1)),
    ("Gemini_DF_ResNet60", "gemini_dfresnet_adam.yaml",
     ("model=Gemini_DF_ResNet60",), dict(gemini=4, masked=1)),
    ("ResNet34", "resnet.yaml", (), dict(masked=1)),
    ("ReDimNetB2", "redimnet.yaml", (), dict(softmax=1, masked=1)),
    ("ECAPA_TDNN_GLOB_c512 fused_res2", "ecapa_tdnn_c512.yaml",
     ("model_args.fused=false", "model_args.fused_res2=true"),
     dict(res2=3, softmax=1, masked=1)))
# rows 4 and 5's kernels in a bf16 glob step: the forward's context
# statistics, the backward's weight-gradient GEMM and softmax backward
DEPLOY_TRACE_NAMES = ("ctx_stats_kernel", "gemm_tn_sm90_kernel",
                      "softmax_bwd_kernel")


def deploy_stage1(root, rng, n_spk=8, n_utt=4):
    """Recipe stage 1 on n_spk x n_utt seeded PCM16 wavs of 2-3.5 s (a
    tone per speaker plus noise): wav.scp and utt2spk, then `prep_data
    raw` and `prep_data shard` (8 utterances a shard, 2 processes). ->
    (raw list, shard list, utt2spk, lines, shards)."""
    os.makedirs(os.path.join(root, "wav"))
    scp, u2s = [], []
    for s in range(n_spk):
        tone = 2 * np.pi * (150 + 25 * s) / 16000
        for u in range(n_utt):
            n = int(rng.uniform(2.0, 3.5) * 16000)
            wav = (0.3 * np.sin(tone * np.arange(n))
                   + rng.uniform(-0.1, 0.1, n)).astype(np.float32)
            key = f"spk{s}-utt{u}"
            path = os.path.join(root, "wav", f"{key}.wav")
            write_wav(path, wav, 16000)
            scp.append(f"{key} {path}")
            u2s.append(f"{key} spk{s}")
    files = {k: os.path.join(root, k) for k in (
        "wav.scp", "utt2spk", "raw.list", "shard.list", "shards")}
    for name, rows in (("wav.scp", scp), ("utt2spk", u2s)):
        with open(files[name], "w") as f:
            f.write("\n".join(rows) + "\n")
    prep_data.main(["raw", "--wav_scp", files["wav.scp"], "--utt2spk",
                    files["utt2spk"], "--out_list", files["raw.list"]])
    prep_data.main(["shard", "--wav_scp", files["wav.scp"], "--utt2spk",
                    files["utt2spk"], "--shards_dir", files["shards"],
                    "--shards_list", files["shard.list"],
                    "--num_utts_per_shard", "8", "--num_threads", "2"])
    with open(files["raw.list"]) as f:
        lines = len(f.readlines())
    with open(files["shard.list"]) as f:
        shards = len(f.readlines())
    if lines != n_spk * n_utt or shards != -(-n_spk * n_utt // 8):
        raise AssertionError(f"stage 1: {lines} raw lines, {shards} shards")
    return (files["raw.list"], files["shard.list"], files["utt2spk"],
            lines, shards)


def seeded_checkpoint(yaml_name, over, root, dev):
    """The YAML's model with the overrides `over` at full width
    (build_model from SEED, BN statistics from synthetic voices as
    randomised_bn takes them), written as a .pt beside a copy of the YAML
    under root: (config path, checkpoint path)."""
    d = os.path.join(root, os.path.splitext(yaml_name)[0])
    os.makedirs(d)
    conf = shutil.copy(os.path.join(os.path.dirname(DEPLOY_CONF), yaml_name),
                       os.path.join(d, "config.yaml"))
    configs = parse_config_or_kwargs(conf, list(over))
    torch.manual_seed(SEED)
    model = randomised_bn(build_model(configs), dev, True,
                          fbank_config(configs))
    ckpt = os.path.join(d, "model.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    return conf, ckpt


def deploy_pt2(name, conf, ckpt, over, want, root, rng, dev, smi):
    """One family's .pt2: bin/export_model.py on the CPU, load_exported on
    the card; at DEPLOY_SHAPES in f32 (TF32 off) its launches a call equal
    eager's, and those equal `want`, and its embeddings meet eager's within
    1e-4 of the largest magnitude; then B=64 x 200 timed by CUDA events,
    eager, .pt2, .pt2, eager. Returns (.pt2 path, the eager model)."""
    t0 = time.perf_counter()
    pt2 = export_model.export_pt2(conf, ckpt, os.path.join(
        root, name.split()[0] + ".pt2"), overrides=list(over))
    export_s = time.perf_counter() - t0
    prog = export_model.load_exported(pt2, dev)
    configs = parse_config_or_kwargs(conf, list(over))
    eager = load_model_for_eval(configs, ckpt, device=dev)
    feat = configs["model_args"]["feat_dim"]
    rels = []
    for b, t in DEPLOY_SHAPES:
        x = torch.as_tensor(rng.standard_normal((b, t, feat)).astype(
            np.float32), device=dev)
        with torch.no_grad():
            zero_counts()
            got = prog(x)
            torch.cuda.synchronize()
            n_pt2 = counts()
            zero_counts()
            ref = eager(x)
            torch.cuda.synchronize()
            n_eager = counts()
        if n_pt2 != n_eager or n_eager != dict(NO_LAUNCH, **want):
            raise AssertionError(f"{name} .pt2 at {(b, t)} launched "
                                 f"{n_pt2}, eager {n_eager}; want {want}")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if got.shape != ref.shape or not err <= 1e-4 * scale:
            raise AssertionError(f"{name} .pt2 at {(b, t)}: max error {err} "
                                 f"of {scale}")
        rels.append(err / scale)
    x = torch.as_tensor(rng.standard_normal((64, 200, feat)).astype(
        np.float32), device=dev)
    with torch.no_grad():
        turns = [cuda_ms(lambda: fn(x), iters=10) for fn in
                 (eager, prog, prog, eager)]
    print(f"deploy .pt2 [{smi}] {name}: export {export_s:.2f} s (CPU); "
          f"on the card {', '.join(f'{k}={v}' for k, v in want.items())} "
          f"a call, as eager; f32 max error / max {max(rels):.2e} at "
          f"{DEPLOY_SHAPES}; B=64 x 200 f32 ms eager {turns[0]:.3f} / "
          f"{turns[3]:.3f}, .pt2 {turns[1]:.3f} / {turns[2]:.3f}")
    return pt2, eager


def deploy_opcheck(ecapa, cam, gemini, dev):
    """torch.library.opcheck of the seven eval ops on the card, at B=2,
    T=16 in f32 and bf16 (masks ragged where the op takes one): the fake
    against the kernel's output, the schema, autograd's registration and
    a dynamic-shape AOT trace. Returns the number of ops checked."""
    ops = torch.ops.wespeaker_tpu_torch
    rng = np.random.default_rng(SEED + 61)
    b, t = 2, 16
    mask = ragged_mask(rng, b, t, dev)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        x, w, dil = se_inputs(ecapa, rng, b, t, dtype, dev)
        xs, tw = tail_inputs(ecapa, rng, b, t, dtype, dev)
        cx, cw, cdil = chain_inputs(ecapa.layer3, rng, b, t, dtype, dev)
        logits, px, pmask = pool_inputs(rng, b, t, 128, dtype, dev, True)
        mx, mw, mdil = cam_inputs(cam, 0, rng, b, t, dtype, dev)
        gx, gw = gemini_inputs(gemini, 0, rng, b, t, dtype, dev)
        for op, args in (
                (ops.fused_se_res2_block, (x, *w, dil, mask)),
                (ops.fused_mfa_astp, (*xs, *tw, mask, True)),
                (ops.fused_res2_chain, (cx, *cw, cdil)),
                (ops.fused_softmax_stats, (logits, px, pmask)),
                (ops.fused_masked_stats, (px, pmask, 1)),
                (ops.fused_cam_dense_block, (mx, *mw, mdil, 100, mask)),
                (ops.fused_inv_bottleneck_stage, (gx, *gw))):
            torch.library.opcheck(op, args)
            n += 1
    return n


def phase_deploy_families(dev, smi):
    """The families whose eval route holds rows 3 and 6-9 (the docstring's
    phase 52): a .pt2 each (deploy_pt2), CAM++'s also through infer_demo
    on a 3 s wav against bin/extract.py; then opcheck of the seven ops."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 62)
    models = {}
    with tempfile.TemporaryDirectory() as root:
        probe = os.path.join(root, "probe.wav")
        write_wav(probe, voice(rng, 48000), 16000)
        plist = os.path.join(root, "probe.list")
        with open(plist, "w") as f:
            f.write(json.dumps({"key": "probe", "wav": probe,
                                "spk": "x"}) + "\n")
        for name, yaml_name, over, want in DEPLOY_FAMILIES:
            conf, ckpt = seeded_checkpoint(yaml_name, over, root, dev)
            pt2, models[name] = deploy_pt2(name, conf, ckpt, over, want,
                                           root, rng, dev, smi)
            if name != "CAMPPlus":
                continue
            zero_counts()
            demo = infer_demo.infer(pt2, probe, 80, device=dev)
            demo_launches = counts()
            scp = extract_cli.extract(conf, ckpt, plist,
                                      os.path.join(root, "cam_emb"),
                                      batch_size=1, device=dev)
            cam_cos = cosine(torch.from_numpy(demo), torch.from_numpy(
                read_vec_scp_dict(scp)["probe"]))
            if cam_cos < 0.9999 or demo_launches != dict(NO_LAUNCH, **want):
                raise AssertionError(f"CAM++ infer_demo: cosine {cam_cos} "
                                     f"against extract, launches "
                                     f"{demo_launches}")
    families_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    checked = deploy_opcheck(models["ECAPA_TDNN_GLOB_c512 fused_res2"],
                             models["CAMPPlus"], models["Gemini_DF_ResNet60"],
                             dev)
    print(f"deploy families [{smi}]: {len(DEPLOY_FAMILIES)} .pt2 "
          f"{families_s:.1f} s; CAM++ infer_demo vs extract cosine "
          f"{cam_cos:.7f}; opcheck of {checked} (op, dtype) pairs on the "
          f"card {time.perf_counter() - t0:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def phase_deploy(dev, smi):
    """Recipe stage 1, 2 profiled recipe steps, then the deployment path
    of their checkpoint: .pt2, ONNX, infer_demo and the C++ runtime with
    the model on the card as its callback (the docstring's phase 49)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 60)
    with tempfile.TemporaryDirectory() as root:
        _, shard_list, utt2spk, lines, shards = deploy_stage1(root, rng)
        exp = os.path.join(root, "exp")
        zero_counts()
        step = train_cli.train(DEPLOY_CONF, [
            "data_type=shard", f"train_data={shard_list}",
            f"utt2spk={utt2spk}", f"exp_dir={exp}", "num_epochs=1",
            f"samples_per_epoch={2 * DEPLOY_BATCH}", "log_batch_interval=1",
            "profile_args={start_step: 0, num_steps: 2}"], device=dev)
        torch.cuda.synchronize()
        launches = counts()
        if step.step != 2 or launches != dict(NO_LAUNCH, train_fwd=2,
                                              train_bwd=2):
            raise AssertionError(f"deploy train: {step.step} steps, "
                                 f"launches {launches}")
        trace = os.path.join(exp, "profile", "steps_0-2.json")
        with open(trace) as f:
            text = f.read()
        missing = [k for k in DEPLOY_TRACE_NAMES if k not in text]
        if missing:
            raise AssertionError(f"{trace} names none of {missing}")
        conf = os.path.join(exp, "config.yaml")
        ckpt = os.path.join(exp, "models", "model_0.pt")
        configs = load_yaml(conf)

        # .pt2: exported on the CPU, run on the card
        t0 = time.perf_counter()
        pt2 = export_model.export_pt2(conf, ckpt,
                                      os.path.join(root, "ecapa.pt2"))
        export_s = time.perf_counter() - t0
        prog = export_model.load_exported(pt2, dev)
        eager = load_model_for_eval(configs, ckpt, device=dev)
        errs = []
        for b, t in DEPLOY_SHAPES:
            x = torch.as_tensor(rng.standard_normal((b, t, 80)).astype(
                np.float32), device=dev)
            zero_counts()
            with torch.no_grad():
                got = prog(x)
                torch.cuda.synchronize()
                n = counts()
                want = eager(x)
            if n != dict(NO_LAUNCH, se=3, tail=1):
                raise AssertionError(f".pt2 at {(b, t)} launched {n}")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if got.shape != (b, 192) or not err <= 1e-4 * scale:
                raise AssertionError(f".pt2 at {(b, t)}: max error {err} "
                                     f"of {scale}")
            errs.append(err / scale)
        x = torch.as_tensor(rng.standard_normal((64, 200, 80)).astype(
            np.float32), device=dev)
        with torch.no_grad():
            turns = [cuda_ms(lambda: fn(x), iters=10) for fn in
                     (eager, prog, prog, eager)]
            # device kernels and copies a call, by torch.profiler (printed,
            # not gated): where the two differ
            kernels = [count_launches(lambda: fn(x), "ws::")
                       for fn in (eager, prog)]

        # ONNX, run by the port's numpy executor on the host
        t0 = time.perf_counter()
        onnx_path = export_model.export_onnx(
            conf, ckpt, os.path.join(root, "ecapa.onnx"))
        onnx_s = time.perf_counter() - t0
        with open(onnx_path, "rb") as f:
            blob = f.read()
        plain_cpu = fx_to_onnx.plain_route(
            load_model_for_eval(configs, ckpt, device="cpu"))
        onnx_rel = []
        for b, t in ((2, 200), (1, 137)):
            feats = rng.standard_normal((b, t, 80)).astype(np.float32)
            got = onnx_numpy.run(blob, {"feats": feats})["embs"]
            with torch.no_grad():
                want = plain_cpu(torch.from_numpy(feats)).numpy()
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            if got.shape != want.shape or not rel < 1e-4:
                raise AssertionError(f"ONNX at {(b, t)}: relative {rel}")
            onnx_rel.append(rel)

        # infer_demo on a 3 s wav (one whole extraction bucket, no padding)
        # against bin/extract.py
        probe = os.path.join(root, "probe.wav")
        write_wav(probe, voice(rng, 48000), 16000)
        zero_counts()
        demo = infer_demo.infer(pt2, probe, 80, device=dev)
        demo_launches = counts()
        plist = os.path.join(root, "probe.list")
        with open(plist, "w") as f:
            f.write(json.dumps({"key": "probe", "wav": probe,
                                "spk": "x"}) + "\n")
        scp = extract_cli.extract(conf, ckpt, plist,
                                  os.path.join(root, "probe_emb"),
                                  batch_size=1, device=dev)
        demo_cos = cosine(torch.from_numpy(demo), torch.from_numpy(
            read_vec_scp_dict(scp)["probe"]))
        if demo_cos < 0.9999 or demo_launches != dict(NO_LAUNCH, se=3,
                                                      tail=1):
            raise AssertionError(f"infer_demo: cosine {demo_cos} against "
                                 f"extract, launches {demo_launches}")

        # the C++ runtime: fbank, the engine with the model on the card,
        # the two binaries
        t0 = time.perf_counter()
        bdir = runtime_binding.build_runtime()
        build_s = time.perf_counter() - t0
        wav16 = (voice(rng, 16000 * 3 + 4800) * (1 << 15)).astype(
            np.float32)
        nat = runtime_binding.NativeFbank(80)(wav16)
        ref = compute_fbank(torch.as_tensor(wav16, device=dev),
                            FbankConfig()).cpu().numpy()
        np.testing.assert_allclose(nat, ref, atol=2e-3, rtol=1e-3)
        embed = runtime_binding.model_embed_fn(eager, dev)
        engine = runtime_binding.NativeEngine(80, embed_fn=embed,
                                              embed_dim=192)
        engine.extract(wav16)  # warm
        zero_counts()
        t0 = time.perf_counter()
        emb = engine.extract(wav16)
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
        eng_launches = counts()
        chunks = runtime_binding.engine_chunks(nat)
        py = np.mean([embed(c) for c in chunks], axis=0)
        eng_cos = cosine(torch.from_numpy(emb), torch.from_numpy(py))
        if eng_cos < 0.9999 or eng_launches != dict(
                NO_LAUNCH, se=3 * len(chunks), tail=len(chunks)):
            raise AssertionError(f"runtime engine: cosine {eng_cos}, "
                                 f"launches {eng_launches} over "
                                 f"{len(chunks)} chunks")
        wscp = os.path.join(root, "rt_wav.scp")
        with open(wscp, "w") as f:
            f.write(f"probe {probe}\nprobe2 {probe}\n")
        out = os.path.join(root, "rt_emb.txt")
        r = subprocess.run([str(bdir / "extract_emb_main"), wscp, out, "80",
                            "16000", "198", "2"], capture_output=True,
                           text=True, timeout=120)
        with open(out) as f:
            rows = f.read().split("\n")
        if r.returncode != 0 or "RTF" not in r.stderr or len(
                [x for x in rows if x]) != 2:
            raise AssertionError(f"extract_emb_main: {r.returncode} "
                                 f"{r.stderr[-300:]}")
        r = subprocess.run([str(bdir / "asv_main"), probe, probe, "0.9",
                            "80"], capture_output=True, text=True,
                           timeout=120)
        if r.returncode != 0 or "ACCEPT" not in r.stdout:
            raise AssertionError(f"asv_main: {r.returncode} {r.stdout}")
    rtf = engine_s / (len(wav16) / 16000)
    print(f"deploy [{smi}] ECAPA_TDNN_GLOB_c512: stage 1 prep_data raw "
          f"{lines} lines, shard {shards} tars; bin/train.py "
          f"ecapa_tdnn_c512.yaml 2 steps with profile_args, launches "
          f"train_fwd={launches['train_fwd']} "
          f"train_bwd={launches['train_bwd']}, trace "
          f"{len(text)} bytes naming "
          f"{', '.join(DEPLOY_TRACE_NAMES)}; .pt2 export {export_s:.2f} s "
          f"(CPU), f32 on the card se=3 tail=1 a call, max error / max "
          f"{max(errs):.2e} at {DEPLOY_SHAPES}; B=64 x 200 f32 ms eager "
          f"{turns[0]:.3f} / {turns[3]:.3f}, .pt2 {turns[1]:.3f} / "
          f"{turns[2]:.3f}; kernels a call by torch.profiler (ours, all, "
          f"copies) eager {kernels[0]}, .pt2 {kernels[1]}; ONNX export {onnx_s:.2f} s, onnx_numpy vs "
          f"eager CPU plain relative {max(onnx_rel):.2e}; infer_demo vs "
          f"extract cosine {demo_cos:.7f}; runtime built in {build_s:.1f} "
          f"s, fbank within 2e-3, engine callback {len(chunks)} chunks "
          f"se={eng_launches['se']} tail={eng_launches['tail']} cosine "
          f"{eng_cos:.7f}, real-time factor {rtf:.4f} ({engine_s * 1e3:.1f}"
          f" ms for {len(wav16) / 16000:.1f} s); extract_emb_main and "
          f"asv_main ran; phase {time.perf_counter() - t_phase:.1f} s")


# --- ddp: the parallel layer (parallel/) on one card ---------------------
DDP_RANKS = 2
DDP_BATCH = 64      # ecapa_tdnn_c512.yaml's batch_size, each rank's
DDP_STEPS = 3
DDP_SSL_B = 16      # each rank's utterances in the SSL checks
DDP_SSL_EMBED = 128  # the quality smoke's ECAPA_TDNN: C=256, embed 128
DDP_QUEUE = 4096
DDP_TIMEOUT = 600


def state_hash(modules):
    """sha256 (16 hex digits) over the modules' parameters and buffers,
    by name and bytes: equal hashes mean bit-identical states."""
    import hashlib
    h = hashlib.sha256()
    for mod in modules:
        for k, v in mod.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().contiguous().reshape(-1).view(
                torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ddp_compare_rows(rng):
    """The global batch of the two-rank comparison (dither 0, spec-aug and
    aug off): 2 x 64 chunks of 2 s, rank 1's quiet in their first half,
    so that the two ranks' BatchNorm statistics differ."""
    wav = rng.uniform(-0.5, 0.5, (DDP_RANKS * DDP_BATCH, CHUNK_SAMPLES))
    wav[DDP_BATCH:, :CHUNK_SAMPLES // 2] *= 0.01
    return {"wav": wav.astype(np.float32),
            "label": rng.integers(0, NUM_CLASS, DDP_RANKS * DDP_BATCH)}


def ddp_one_step(dev, batch, dtype, mesh=None, global_stats=True):
    """One step of train_modules' ECAPA_TDNN_GLOB_c512 + ArcMargin from the
    seeded weights on `batch` (this rank's rows), LR 0.1 and margin 0.2
    (phase_train_step's); -> (the global loss, each parameter's update and
    each BatchNorm running statistic after the step, on the CPU, and each
    parameter's largest magnitude after the step)."""
    model, proj, opt, _ = train_modules(dev)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, proj, opt, lambda s: 0.1, lambda s: 0.2,
                           FbankConfig(dither=0.0), AugConfig(spec_aug=False),
                           compute_dtype=dtype, device=dev, mesh=mesh,
                           global_stats=global_stats)
    loss = float(step({k: torch.as_tensor(v, device=dev)
                       for k, v in batch.items()})["loss"])
    upd = {n: (p.detach() - start[n]).float().cpu()
           for n, p in model.named_parameters()}
    stats = {n: b.float().cpu() for n, b in model.named_buffers()
             if n.rsplit(".", 1)[-1] in ("running_mean", "running_var")}
    top = {n: p.detach().abs().max().item()
           for n, p in model.named_parameters()}
    del model, proj, opt, step
    torch.cuda.empty_cache()
    return loss, upd, stats, top


def ddp_ssl_step(method, dev, batch, dtype, mesh=None):
    """One `dtype` step (TF32 off in f32) of DINO, MoCo or SimCLR on the
    quality smoke's ECAPA_TDNN (C=256, embed 128) built from SEED, DINO
    with the SSL
    smoke's BN head (8,192 out), MoCo with a 4,096 queue; -> (the global
    loss, each student / encoder parameter's update on the CPU, DINO's
    centre or MoCo's queue, each parameter's largest magnitude after the
    step)."""
    from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
    from wespeaker_tpu_torch.ssl import contrastive as SC
    from wespeaker_tpu_torch.ssl import dino as SD
    torch.manual_seed(SEED)
    enc = ECAPA_TDNN(SMOKE_C, 80, DDP_SSL_EMBED, global_context_att=False)
    if method == "dino":
        head = SD.DINOHead(DDP_SSL_EMBED, 8192, use_bn=True,
                           hidden_dim=1024, bottleneck_dim=128)
        state = SD.init_dino_state(enc, head, lambda m: torch.optim.SGD(
            [p for p in m.parameters() if p.requires_grad], lr=0.0,
            momentum=0.9), dev)
        step = SD.DINOTrainStep(
            state, lambda s: 0.05, lambda s: 0.996, lambda s: 0.04,
            SD.DINOConfig(out_dim=8192, n_global=2, n_local=4),
            compute_dtype=dtype, mesh=mesh)
        module = step.student
    else:
        enc = enc.to(dev)
        opt = torch.optim.SGD(enc.parameters(), lr=0.0, momentum=0.9)
        if method == "moco":
            queue = SC.l2norm(torch.randn(
                (DDP_QUEUE, DDP_SSL_EMBED),
                generator=torch.Generator(device=dev).manual_seed(SEED),
                device=dev))
            step = SC.MoCoTrainStep(enc, opt, lambda s: 0.05, queue,
                                    compute_dtype=dtype, mesh=mesh)
        else:
            step = SC.SimCLRTrainStep(enc, opt, lambda s: 0.05,
                                      compute_dtype=dtype,
                                      mesh=mesh)
        module = enc
    start = {n: p.detach().clone() for n, p in module.named_parameters()}
    loss = float(step({k: torch.as_tensor(v, device=dev)
                       for k, v in batch.items()})["loss"])
    upd = {n: (p.detach() - start[n]).float().cpu()
           for n, p in module.named_parameters()}
    top = {n: p.detach().abs().max().item()
           for n, p in module.named_parameters()}
    # DINO's centre, MoCo's queue rows this step wrote
    extra = (step.center if method == "dino" else
             step.queue[:DDP_RANKS * DDP_SSL_B] if method == "moco"
             else torch.zeros(1)).float().cpu()
    del step, module, enc
    torch.cuda.empty_cache()
    return loss, upd, extra, top


def ddp_ssl_batches(rng):
    """Each rank's SSL rows (features, view-major), rank 1's scaled and
    shifted; and the global batch in view-major order."""
    def rows(shape, r):
        x = rng.standard_normal(shape).astype(np.float32)
        return x * 3.0 + 1.0 if r else x

    b = DDP_SSL_B
    ranks = {"dino": [{"global_feat": rows((2 * b, 200, 80), r),
                       "local_feat": rows((4 * b, 100, 80), r)}
                      for r in range(DDP_RANKS)],
             "moco": [{k: rows((b, 200, 80), r) for k in ("q_feat",
                                                         "k_feat")}
                      for r in range(DDP_RANKS)],
             "simclr": [{"feat": rows((2 * b, 200, 80), r)}
                        for r in range(DDP_RANKS)]}

    def view_major(parts, views):
        return np.concatenate([p.reshape(views, b, *p.shape[1:])
                               for p in parts], axis=1).reshape(
            -1, *parts[0].shape[1:])

    glob = {"dino": {"global_feat": view_major(
                [p["global_feat"] for p in ranks["dino"]], 2),
                     "local_feat": view_major(
                [p["local_feat"] for p in ranks["dino"]], 4)},
            "moco": {k: np.concatenate([p[k] for p in ranks["moco"]])
                     for k in ("q_feat", "k_feat")},
            "simclr": {"feat": view_major(
                [p["feat"] for p in ranks["simclr"]], 2)}}
    return ranks, glob


def ddp_trainer_args(inputs, rank, name, samples, extra=()):
    """bin/train.py overrides for the ranks: ecapa_tdnn_c512.yaml on the
    shard corpus, one epoch of `samples`, distributed_args."""
    return (list(inputs["corpus"])
            + [f"exp_dir={os.path.join(inputs['root'], name)}",
               "num_epochs=1", "log_batch_interval=1",
               f"samples_per_epoch={samples}",
               f"distributed_args={{coordinator: localhost:"
               f"{inputs['port']}, num_processes: {inputs['world']}, "
               f"process_id: {rank}}}"] + list(extra))


def ddp_rank(rank, world, workdir):
    """One rank of phase_ddp (chip_smoke.py --ddp-rank RANK WORLD DIR):
    joins the group of DIR/inputs.pt, runs its tasks and writes
    DIR/rank<RANK>.pt. The parent has built every kernel already. A
    fatal signal prints every thread's Python stack to the rank's log."""
    import faulthandler

    import torch.distributed as dist

    from wespeaker_tpu_torch.parallel.mesh import make_mesh

    faulthandler.enable()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    inputs["world"] = world
    backend = inputs["backend"]
    dev = torch.device(inputs.get("device", "cuda"))
    conf = os.path.join(V2_CONF, "ecapa_tdnn_c512.yaml")
    out = {}
    writes = []
    save = ckpt_io.save_checkpoint

    def counted(path, *a, **kw):
        writes.append(os.path.basename(path))
        return save(path, *a, **kw)

    ckpt_io.save_checkpoint = counted
    # the trainer: 3 steps, each rank's launches, its state's hash, a
    # step's wall and device time, and a resume from rank 0's checkpoint
    over = ddp_trainer_args(inputs, rank, "dp",
                            DDP_STEPS * world * DDP_BATCH)
    zero_counts()
    # rank 0 times its second step and profiles its third
    with step_clock(*((1, 1) if rank == 0 else ())) as clock:
        step = train_cli.train(conf, over, device=dev, backend=backend)
    torch.cuda.synchronize()
    out["trainer"] = {
        "launches": counts(), "hash": state_hash([step.model,
                                                  step.projection]),
        "steps": step.step, "losses": [float(v) for v in clock["losses"]],
        "ms": clock.get("ms"), "dev_ms": clock.get("dev_ms"),
        "grad_numel": sum(p.numel() for p in step.params)}
    ckpt = os.path.join(inputs["root"], "dp", "models", "model_0.pt")
    resumed = train_cli.train(conf, over + [f"checkpoint={ckpt}"],
                              device=dev, backend=backend)
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    out["trainer"]["resumed"] = resumed.step == DDP_STEPS and all(
        torch.equal(saved["state_dict"][k], v.cpu())
        for k, v in resumed.model.state_dict().items())
    del step, resumed
    torch.cuda.empty_cache()
    mesh = make_mesh()
    # one gradient all_reduce of the trainer's size (median of 5)
    flat = torch.randn(out["trainer"]["grad_numel"], device=dev)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = float(np.median(times[1:]))
    if inputs["tasks"] == ["trainer"]:
        ckpt_io.save_checkpoint = save
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
        return 0
    # two ranks against one process: this rank's rows of the global batch
    rows = {k: v[rank * DDP_BATCH:(rank + 1) * DDP_BATCH]
            for k, v in inputs["rows"].items()}
    out["compare"] = {
        name: ddp_one_step(dev, rows, dtype, mesh, gs)
        for name, dtype, gs in (("bf16", torch.bfloat16, True),
                                ("f32", torch.float32, True),
                                ("f32 per-rank BN", torch.float32, False))}
    out["ssl"] = {(m, dt): ddp_ssl_step(m, dev, inputs["ssl"][m][rank], dt,
                                        mesh)
                  for m in ("dino", "moco", "simclr")
                  for dt in (torch.float32, torch.bfloat16)}
    # the model axis: parallel_args.model 2 (data 1), 2 steps
    zero_counts()
    with step_clock() as clock:
        # data 1: the global batch is one rank's
        train_cli.train(conf, ddp_trainer_args(
            inputs, rank, "mp", 2 * DDP_BATCH, ["parallel_args={model: 2}"]),
            device=dev, backend=backend)
    out["model_axis"] = {"losses": [float(v) for v in clock["losses"]],
                         "launches": counts()}
    ckpt_io.save_checkpoint = save
    out["writes"] = writes
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def run_ddp_ranks(workdir, inputs, world=DDP_RANKS):
    """Start `world` ranks of this script on inputs, wait for them, stop
    them all on any failure; -> each rank's results and seconds."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        inputs["port"] = s.getsockname()[1]
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    t0 = time.perf_counter()
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r),
         str(world), workdir], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        deadline = time.time() + DDP_TIMEOUT
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    secs = time.perf_counter() - t0
    failed = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            failed.append(f"ddp rank {r} exited {p.returncode}:\n"
                          f"{text[-6000:]}")
    if failed:  # every failed rank: the first to fail may not be rank 0
        raise AssertionError("\n".join(failed))
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)], secs


def update_check(got, want, skip=(B2,)):
    """PERF.md section 2's per-layer bar on one step's updates (a module's
    parameters as one vector): cosine >= 0.999. -> (the lowest three
    (layer, cosine), passed)."""
    low = layer_cosines(got, want, skip)
    return low[:3], low[0][1] >= 0.999


def param_errors(got, want, skip):
    """Per parameter, the largest element error after the step of max(1,
    the tensor's largest magnitude), the scale of
    tests/test_torch_parallel.py (the parameters start equal, so it is
    the update's error); `skip`'s exact gradient is 0."""
    return {n: (got[1][n] - u).abs().max().item() / max(want[3][n], 1.0)
            for n, u in want[1].items() if n not in skip}


def f32_check(got, want, skip, order=None):
    """The f32 bar (TF32 off) of a step (loss, updates, BatchNorm running
    statistics or None, largest magnitudes) against the one-process step:
    the loss within 1e-4 (relative), each running statistic element-wise
    within 1e-4 of max(1, its largest magnitude), each layer's update at
    cosine >= 0.999, and each parameter after the step element-wise
    within 1e-4 (param_errors), or, given `order` (the one-process step
    on the same rows in another order, which changes every reduction's
    order and nothing else), within twice the error that the reordering
    alone makes where that is larger: at LR 0.1 from init the reordering
    alone moves a parameter by ~1e-4 of max(1, its largest) on the
    H100 (PERF.md, Findings). -> (the line's text, passed)."""
    rel = abs(got[0] - want[0]) / abs(want[0])
    err = param_errors(got, want, skip)
    limit, floor = 1e-4, ""
    if order is not None:
        own = max(param_errors(order, want, skip).items(),
                  key=lambda kv: kv[1])
        limit = max(limit, 2 * own[1])
        floor = (f" (bar {limit:.3g}: the same rows reordered in one "
                 f"process move {own[0]} by {own[1]:.3g})")
    if want[2] is not None:
        stats = {n: (got[2][n] - w).abs().max().item()
                 / max(w.abs().max().item(), 1.0)
                 for n, w in want[2].items()}
        top = max(stats.items(), key=lambda kv: kv[1])
    worst = sorted(err.items(), key=lambda kv: -kv[1])
    low, cos_ok = update_check(got[1], want[1], skip)
    text = (f"loss rel {rel:.2e}, parameters after the step, largest error "
            "of max(1, the tensor's largest) "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst[:3]) + floor
            + (f"; running statistics {top[0]} {top[1]:.3g}"
               if want[2] is not None else "")
            + f"; update cosine per layer lowest {fmt_low(low)}")
    return text, (rel <= 1e-4 and worst[0][1] <= limit and cos_ok
                  and (want[2] is None or top[1] <= 1e-4))


def bf16_check(got, want, exact, control, skip):
    """A bf16 step of the ranks (loss, updates) against the one-process
    bf16 step that takes its statistics as the ranks do: the loss within
    1e-3, and, per layer, the ranks' error against the exact update (the
    one-process f32 step's) at most 1.1 x the one-process bf16 step's own
    + DINO_BF16_FLOOR (phase dino's bar). `control` is the one-process
    bf16 step with the plain two-pass statistics instead of the sums, a
    change of f32 rounding in the statistics only: the per-layer cosine
    between the two one-process steps shows how far bf16 rounding carries
    such a change. Every layer that the control leaves at cosine >= 0.9999
    must meet PERF.md section 2's >= 0.999 between the ranks and the one
    process. -> (the line's text, passed)."""
    rel = abs(got[0] - want[0]) / abs(want[0])
    cos = per_layer(cosine, got[1], want[1], skip)
    ctrl = per_layer(cosine, control[1], want[1], skip)
    low = sorted(cos.items(), key=lambda kv: kv[1])
    ctrl_low = sorted(ctrl.items(), key=lambda kv: kv[1])
    steady = [k for k in cos if ctrl[k] >= 0.9999]
    steady_low = sorted(((cos[k], k) for k in steady))[:1]
    err = [per_layer(lambda a, b: ((a - b).norm() / b.norm()).item(), u,
                     exact, skip) for u in (got[1], want[1])]
    near = sorted(((err[0][k] - 1.1 * err[1][k], k, err[0][k], err[1][k])
                   for k in err[0]), reverse=True)
    text = (f"loss rel {rel:.2e}; update cosine per layer lowest "
            f"{fmt_low(low)}; control (one process, two-pass statistics "
            f"vs the sums) lowest {fmt_low(ctrl_low)}; of the "
            f"{len(steady)}/{len(cos)} layers that the control leaves at "
            ">= 0.9999 the lowest "
            + (f"{steady_low[0][1]} {steady_low[0][0]:.6f}" if steady_low
               else "none")
            + " (bar 0.999); error against the f32 step's update, ranks <= "
            f"1.1 x one process + {DINO_BF16_FLOOR}, nearest "
            + ", ".join(f"{k} {e:.4f} vs {p:.4f}"
                        for _, k, e, p in near[:2]))
    return text, (rel <= 1e-3 and near[0][0] <= DINO_BF16_FLOOR
                  and all(c >= 0.999 for c, _ in steady_low))


def phase_ddp(dev, smi, stores):
    """Two ranks over gloo on the one card (NCCL refuses two ranks on one
    device), then NCCL; see the module docstring (phase 51)."""
    import torch.distributed as dist

    from wespeaker_tpu_torch.parallel.mesh import Mesh, make_mesh

    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 61)
    parts, bad = [], []
    with tempfile.TemporaryDirectory() as root:
        shard_list, utt2spk = write_shards(root, rng)
        corpus = [f"train_data={shard_list}", f"utt2spk={utt2spk}",
                  f"reverb_data={stores[0]}", f"noise_data={stores[1]}",
                  "data_type=shard"]
        rows = ddp_compare_rows(rng)
        ssl_ranks, ssl_global = ddp_ssl_batches(rng)
        out, rank_s = run_ddp_ranks(root, {
            "backend": "gloo", "root": root, "corpus": corpus,
            "tasks": ["trainer", "compare", "ssl", "model_axis"],
            "rows": rows, "ssl": ssl_ranks})
        tr = [o["trainer"] for o in out]
        want = dict(NO_LAUNCH, train_fwd=DDP_STEPS, train_bwd=DDP_STEPS)
        hashes = [t["hash"] for t in tr]
        if (any(t["launches"] != want or t["steps"] != DDP_STEPS
                or not t["resumed"] for t in tr) or len(set(hashes)) != 1
                or out[0]["writes"][:1] != ["model_0.pt"]
                or any(o["writes"] for o in out[1:])):
            bad.append("trainer")
        losses = tr[0]["losses"]
        if not np.all(np.isfinite(losses)):
            bad.append("trainer losses")
        parts.append(
            f"bin/train.py ecapa_tdnn_c512.yaml in {DDP_RANKS} ranks "
            f"(gloo on CUDA tensors, one card) x B={DDP_BATCH}, "
            f"{DDP_STEPS} steps: launches per rank "
            + "; ".join(" ".join(f"{k}={v}" for k, v in t["launches"].items()
                                 if v) for t in tr)
            + f", state hashes {hashes}, losses "
            f"{[round(v, 4) for v in losses]}, rank 0 wrote "
            f"{out[0]['writes']}, rank 1 {out[1]['writes']}, resume in "
            f"{DDP_RANKS} ranks loads model_0.pt "
            f"{all(t['resumed'] for t in tr)}; a step {tr[0]['ms']:.1f} ms "
            f"wall ({tr[0]['dev_ms']:.1f} ms on the device, rank 0); one "
            f"gradient all_reduce of {tr[0]['grad_numel']:,} f32 "
            f"{out[0]['allreduce_ms']:.1f} ms (gloo stages through the "
            "host: not an NCCL figure, not a scaling figure)")

        # the model axis against one process on the same data
        ma = [o["model_axis"] for o in out]
        zero_counts()
        with step_clock() as clock:
            train_cli.train(os.path.join(V2_CONF, "ecapa_tdnn_c512.yaml"),
                            list(corpus) + [
                                f"exp_dir={os.path.join(root, 'mp1')}",
                                "num_epochs=1", "log_batch_interval=1",
                                f"samples_per_epoch={2 * DDP_BATCH}"],
                            device=dev)
        one = [float(v) for v in clock["losses"]]
        rels = [abs(a - b) / abs(b) for a, b in zip(ma[0]["losses"], one)]
        path = os.path.join(root, "mp", "models", "model_0.pt")
        model_sd, head_sd = ckpt_io.read_checkpoint(path,
                                                    "ECAPA_TDNN_GLOB_c512")
        full = ArcMarginProduct(192, head_sd["weight"].shape[0])
        model = ECAPA_TDNN_GLOB_c512(80, 192)
        ckpt_io.load_checkpoint(path, model, full)
        rows_one = torch.load(os.path.join(root, "mp1", "models",
                                           "model_0.pt"),
                              weights_only=True)["projection"]["weight"]
        if (len(rels) != 2 or max(rels) > 1e-3
                or ma[0]["losses"] != ma[1]["losses"]
                or head_sd["weight"].shape != rows_one.shape):
            bad.append("model axis")
        parts.append(
            f"model axis (parallel_args.model 2, data 1) 2 steps: losses "
            f"{[round(v, 5) for v in ma[0]['losses']]} vs one process "
            f"{[round(v, 5) for v in one]} (rel {max(rels):.2e}), launches "
            "a rank " + " ".join(f"{k}={v}" for k, v in ma[0]["launches"]
                                 .items() if v)
            + f"; model_0.pt holds the head's {head_sd['weight'].shape[0]} "
            f"rows and loads into a one-card model; ranks {rank_s:.1f} s")
        del model, full

        # The one-process references on the global batch take their
        # BatchNorm statistics as the ranks do (the sums of
        # models/layers.py::_global_batch_norm, through a group of one), in
        # a world of one over NCCL whose own all_reduce and train step are
        # checked too. The f32 step's update is the exact one that the
        # bf16 steps are held against. The controls are the same
        # one-process steps with the plain two-pass statistics
        # (batch_norm without a group).
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        try:
            solo = Mesh(data_group=dist.group.WORLD)
            want = ddp_one_step(dev, rows, torch.float32, solo)
            exact = want[1]
            # the same rows, rank 1's first: the reductions' order alone
            swapped = {k: np.concatenate([v[DDP_BATCH:], v[:DDP_BATCH]])
                       for k, v in rows.items()}
            order = ddp_one_step(dev, swapped, torch.float32, solo)
            line, ok = f32_check(out[0]["compare"]["f32"], want, (B2,),
                                 order)
            ctrl_line, _ = f32_check(ddp_one_step(dev, rows, torch.float32),
                                     want, (B2,))
            pr_line, pr_ok = f32_check(out[0]["compare"]["f32 per-rank BN"],
                                       want, (B2,), order)
            parts.append(
                f"f32 step, 2 ranks vs one process on the global "
                f"B={DDP_RANKS * DDP_BATCH}: {line}; control (one process, "
                f"two-pass statistics vs the sums, recorded): {ctrl_line}; "
                "with each rank's own BN statistics (the sensitivity check, "
                f"must miss): {pr_line}")
            if not ok:
                bad.append("f32 step")
            if pr_ok:
                bad.append("per-rank BN passes the f32 bar")
            del want, order
            line, ok = bf16_check(
                out[0]["compare"]["bf16"],
                ddp_one_step(dev, rows, torch.bfloat16, solo), exact,
                ddp_one_step(dev, rows, torch.bfloat16), (B2,))
            parts.append(f"bf16 step, 2 ranks vs one process: {line}")
            if not ok:
                bad.append("bf16 step")
            del exact
            # SSL: f32 (TF32 off) at the f32 bar, then bf16 against the f32
            # one-process step's update
            for method in ("dino", "moco", "simclr"):
                skip = DINO_ZERO_GRAD if method == "dino" else (B2,)
                what = {"dino": "centre", "moco": "queue's new rows"}.get(
                    method)
                batch = ssl_global[method]
                want = ddp_ssl_step(method, dev, batch, torch.float32,
                                    solo)
                got = out[0]["ssl"][method, torch.float32]
                line, ok = f32_check((got[0], got[1], None, got[3]),
                                     (want[0], want[1], None, want[3]),
                                     skip)
                ecos = cosine(got[2], want[2])
                line = (f"{method} B={DDP_RANKS}x{DDP_SSL_B} vs one process, "
                        f"f32: {line}")
                want16 = ddp_ssl_step(method, dev, batch, torch.bfloat16,
                                      solo)
                got16 = out[0]["ssl"][method, torch.bfloat16]
                text, ok16 = bf16_check(
                    got16, want16, want[1],
                    ddp_ssl_step(method, dev, batch, torch.bfloat16), skip)
                line += f"; bf16: {text}"
                if what:
                    cos16 = cosine(got16[2], want16[2])
                    same = all(torch.equal(o["ssl"][method, dt][2],
                                           out[0]["ssl"][method, dt][2])
                               for o in out for dt in (torch.float32,
                                                       torch.bfloat16))
                    line += (f"; {what} cosine f32 {ecos:.7f} bf16 "
                             f"{cos16:.7f}, bit-identical over ranks {same}")
                    ok = ok and min(ecos, cos16) >= 0.999 and same
                parts.append(line)
                if not (ok and ok16):
                    bad.append(method)
                del want, want16
            # NCCL's own: an all_reduce and a train step in the world of one
            x = torch.ones(4, device=dev)
            dist.all_reduce(x)
            loss = ddp_one_step(dev, {k: v[:DDP_BATCH]
                                      for k, v in rows.items()},
                                torch.bfloat16, make_mesh())[0]
        finally:
            dist.destroy_process_group()
        if x.sum().item() != 4 or not np.isfinite(loss):
            bad.append("nccl world of one")
        nccl = f"NCCL world of one: all_reduce and one step (loss {loss:.4f})"
        if torch.cuda.device_count() >= 2:
            two, _ = run_ddp_ranks(root, {
                "backend": "nccl", "root": root, "corpus": corpus,
                "tasks": ["trainer"]})
            ok = len({o["trainer"]["hash"] for o in two}) == 1
            bad += [] if ok else ["nccl two cards"]
            nccl += (f"; NCCL on two cards: 3 steps, hashes equal {ok}, "
                     f"all_reduce {two[0]['allreduce_ms']:.1f} ms")
        else:
            nccl += ("; NCCL across two cards not run: "
                     f"{torch.cuda.device_count()} card")
        parts.append(nccl)
    print(f"ddp [{smi}]: " + "; ".join(parts)
          + f"; {time.perf_counter() - t_start:.1f} s")
    if bad:
        raise AssertionError(f"ddp: {bad}")


def phase_ddp_eval(dev, root):
    """--data_parallel extraction and diarization with two replicas on the
    one card against one replica: bin/extract.py bf16 with
    ECAPA_TDNN_GLOB_c512 (random weights from SEED) over the quality
    phase's evaluation list, and bin/diarize.py on the diar phase's
    recording with the quality checkpoint."""
    t_start = time.perf_counter()
    model = random_model(dev)
    ckpt = os.path.join(root, "c512.pt")
    ckpt_io.save_checkpoint(ckpt, model)
    del model
    cfg = os.path.join(root, "c512.yaml")
    with open(cfg, "w") as f:
        f.write("model: ECAPA_TDNN_GLOB_c512\nmodel_args:\n  feat_dim: 80\n"
                "  embed_dim: 192\ndataset_args:\n  fbank_args:\n"
                "    num_mel_bins: 80\n")
    lst = os.path.join(root, "eval.list")
    runs = {}
    for name, kw in (("one", {}),
                     ("two", {"data_parallel": True,
                              "devices": ["cuda:0", "cuda:0"]})):
        zero_counts()
        scp = extract_cli.extract(cfg, ckpt, lst,
                                  os.path.join(root, f"dp_{name}"),
                                  batch_size=QUALITY_BATCH, bf16=True,
                                  device=dev, **kw)
        torch.cuda.synchronize()
        with open(scp) as f:
            keys = [ln.split()[0] for ln in f]
        runs[name] = (keys, read_vec_scp_dict(scp), counts())
    (k1, e1, c1), (k2, e2, c2) = runs["one"], runs["two"]
    cos = row_cosines(torch.tensor(np.stack([e2[k] for k in k1])),
                      torch.tensor(np.stack([e1[k] for k in k1])))
    bad = (k1 != k2 or cos.min().item() < 0.9999
           or c2 != dict(NO_LAUNCH, se=3 * c2["tail"], tail=2 * c1["tail"])
           or c1 != dict(NO_LAUNCH, se=3 * c1["tail"], tail=c1["tail"]))
    exp = os.path.join(root, "exp")
    diar = os.path.join(root, "diar")
    rttms = []
    for name, kw in (("one", {}),
                     ("two", {"data_parallel": True,
                              "devices": ["cuda:0", "cuda:0"]})):
        out = os.path.join(diar, f"dp_{name}.rttm")
        with contextlib.redirect_stdout(io.StringIO()):
            diarize_cli.diarize(os.path.join(exp, "config.yaml"),
                                os.path.join(exp, "models",
                                             "final_model.pt"),
                                os.path.join(diar, "wav.scp"), out,
                                sad_rttm=os.path.join(diar, "ref.rttm"),
                                batch_size=DIAR_BATCH, bf16=True,
                                device=dev, **kw)
        with open(out) as f:
            rttms.append(f.read())
    bad = bad or rttms[0] != rttms[1]
    print(f"ddp eval: bin/extract.py --data_parallel bf16 with 2 replicas "
          f"on cuda:0 vs one replica, ECAPA_TDNN_GLOB_c512 over "
          f"{len(k1)} utterances (batch {QUALITY_BATCH}): keys in the same "
          f"order {k1 == k2}, min cosine {cos.min().item():.7f}, launches "
          "one replica " + " ".join(f"{k}={v}" for k, v in c1.items() if v)
          + ", two " + " ".join(f"{k}={v}" for k, v in c2.items() if v)
          + " (rows 1 x3 and 2 x1 a replica batch); bin/diarize.py "
          "--data_parallel on the diar phase's recording: RTTM identical "
          f"{rttms[0] == rttms[1]} ({rttms[0].count(chr(10))} lines); "
          f"{time.perf_counter() - t_start:.1f} s")
    if bad:
        raise AssertionError("ddp eval: --data_parallel differs from one "
                             "replica")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # the plain versions are exact f32 where they run in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_device()
    model = random_model(dev)
    errs = phase_kernels(model, dev)
    errs.update(phase_train_kernels(model, dev))
    launches = phase_slice(model, dev)
    phase_serving(model, dev)
    phase_train_step(dev)
    train_launches = phase_trainer(dev)
    phase_deploy(dev, smi)
    launches.update(train_fwd=train_launches["train_fwd"],
                    train_bwd=train_launches["train_bwd"])
    timing = phase_timing(model, dev, smi)
    train_timing, train_errs = phase_train_timing(model, dev, smi)
    timing.update(train_timing)
    errs["train_bwd"] = max(errs["train_bwd"], train_errs["train_bwd"])
    errs.update(phase_res2_kernels(model, dev))
    launches["res2"] = phase_res2_slice(model, dev)["res2"]
    timing.update(phase_res2_timing(model, dev, smi))
    del model
    cam = random_campplus(dev)
    errs.update(phase_cam_kernels(cam, dev))
    launches["cam"] = phase_campplus_slice(cam, dev)["cam"]
    phase_campplus_serving(cam, dev)
    timing.update(phase_campplus_timing(cam, dev, smi))
    del cam
    gemini = random_gemini(dev)
    errs.update(phase_gemini_kernels(gemini, dev))
    launches["gemini"] = phase_gemini_slice(gemini, dev)["gemini"]
    phase_gemini_serving(dev)
    timing.update(phase_gemini_timing(gemini, dev, smi))
    del gemini
    errs.update(phase_dw_kernels(dev))
    phase_resnet_slice(dev)
    phase_resnet_serving(dev)
    phase_resnet_train(dev)
    launches["dw"] = phase_resnet_trainer(dev)["dw"]
    timing.update(phase_resnet_timing(dev, smi))
    phase_family_train(dev)
    errs.update(phase_pool_kernels(dev))
    redim = random_redimnet(dev)
    pool_launches = phase_redimnet_slice(redim, dev)
    launches.update(softmax=pool_launches["softmax"],
                    masked=pool_launches["masked"])
    phase_redimnet_serving(dev)
    timing.update(phase_redimnet_timing(redim, dev, smi))
    del redim
    torch.cuda.empty_cache()
    phase_dino(dev)
    phase_dino_timing(dev, smi)
    with tempfile.TemporaryDirectory() as d:
        raw, utt2spk = ssl_corpus(d)
        phase_dino_trainer(dev, raw, utt2spk, d)
        phase_contrastive(dev, raw, utt2spk, d)
    with tempfile.TemporaryDirectory() as d:
        phase_quality(dev, d)
        phase_diar(dev, d)
        phase_ddp_eval(dev, d)
    phase_diar_full(dev, smi)
    phase_backend(dev)
    with tempfile.TemporaryDirectory() as d:
        stores = phase_aug(dev, smi, d)
        recipe = os.path.join(d, "recipe")
        os.makedirs(recipe)
        shards = phase_recipe_train(dev, smi, stores, recipe)
        phase_http_shards(dev, smi, stores, *shards)
        phase_ddp(dev, smi, stores)
        t_zoo = time.perf_counter()
        phase_zoo_slice(dev)
        phase_zoo_serving(dev)
        root = os.path.join(d, "zoo")
        os.makedirs(root)
        shard_list, utt2spk = write_shards(root, np.random.default_rng(
            SEED + 46))
        corpus = [f"train_data={shard_list}", f"utt2spk={utt2spk}",
                  f"reverb_data={stores[0]}", f"noise_data={stores[1]}",
                  "data_type=shard"]
        phase_zoo_train(dev, root, corpus)
        phase_repvgg_deploy(dev, root, corpus)
        phase_zoo_timing(dev, smi)
        print(f"zoo phases: {time.perf_counter() - t_zoo:.1f} s")
        t_front = time.perf_counter()
        phase_frontend_slice(dev, d, smi)
        phase_frontend_train(dev, d, stores, smi)
        print(f"frontend phases: {time.perf_counter() - t_front:.1f} s")
    phase_deploy_families(dev, smi)
    csrc, ops = "wespeaker_tpu_torch/csrc/", "wespeaker_tpu/ops/"
    rows = [("fused_se_res2_block", "se", csrc + "se_block.cu",
             ops + "se_block_pallas.py:204"),
            ("fused_mfa_astp", "tail", csrc + "mfa_astp.cu",
             ops + "mfa_astp_pallas.py:191"),
            ("mfa_astp_train_fwd", "train_fwd", csrc + "mfa_astp_train.cu",
             ops + "mfa_astp_vjp.py:166"),
            ("mfa_astp_train_bwd", "train_bwd", csrc + "mfa_astp_train.cu",
             ops + "mfa_astp_vjp.py:350"),
            ("fused_cam_dense_block", "cam", csrc + "cam_block.cu",
             ops + "cam_block_pallas.py:204"),
            ("fused_inv_bottleneck_stage", "gemini",
             csrc + "inv_bottleneck.cu", ops + "inv_bottleneck_pallas.py:167"),
            ("fused_res2_chain", "res2", csrc + "se_block.cu",
             ops + "res2_pallas.py:137"),
            ("dw_pack", "dw", csrc + "conv_dw_pack.cu",
             ops + "conv_dw_pack.py:119"),
            ("fused_softmax_stats", "softmax", csrc + "pooling.cu",
             ops + "pooling_pallas.py:62"),
            ("fused_masked_stats", "masked", csrc + "pooling.cu",
             ops + "pooling_pallas.py:113")]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": timing[k]["ms"], "plain_ms": timing[k]["plain_ms"],
         "bound_ms": timing[k]["bound_ms"],
         "bound_by": timing[k]["bound_by"],
         "library_ms": timing[k].get("library_ms")}
        for name, k, src, rep in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:  # one rank of phase_ddp
        sys.exit(ddp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
